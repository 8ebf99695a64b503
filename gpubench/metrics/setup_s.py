"""``setup_s``: seconds from the process's start to the window's opening:
imports, CUDA's start, the weights, the kernels' build or load, warm-up
and, when serving, the closed loop's ramp to its steady state."""


def read(run, out):
    if out["t_open"] is None:
        return None
    return out["t_open"] - run.started
