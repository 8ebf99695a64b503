"""``output_tokens_per_s``: output tokens that became visible to the
clients inside the window, over the window's seconds."""

from gpubench.yardstick.stats import tokens_in_window


def read(run, out):
    t0, t1 = out["t_open"], out["t_close"]
    return tokens_in_window(out["requests"], t0, t1) / (t1 - t0)
