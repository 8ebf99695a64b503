"""``mfu.train``: the model FLOPs of the window's steps (forward and
backward, 6 per active parameter a token plus attention, no recompute)
over the window's seconds at the H100's bf16 peak, in percent."""

from gpubench.yardstick.flops import PEAK_BF16_FLOPS, train_flops


def read(run, out):
    if not out["steps"]:
        return None
    t = run.traffic
    flops = out["steps"] * train_flops(run.shape, t["batch"], t["seq"])
    return 100.0 * flops / ((out["t_close"] - out["t_open"]) * PEAK_BF16_FLOPS)
