"""``tpot_p95_ms``: the 95th percentile, over requests that finished inside
the window with at least two output tokens, of (end - first token) /
(tokens - 1): the gap between tokens a client sees, its last tokens
included, which the engine hands over at the end of its decode chunk."""

from gpubench.yardstick.stats import percentile, tpot_samples


def read(run, out):
    samples = tpot_samples(out["requests"], out["t_open"], out["t_close"])
    return 1e3 * percentile(samples, 0.95) if samples else None
