"""``ttft_p95_ms``: the 95th percentile, over every request sent inside the
window, of its first token's time less its send time; a request with no
first token by the close counts with the time it had waited."""

from gpubench.yardstick.stats import percentile, ttft_samples


def read(run, out):
    samples = ttft_samples(out["requests"], out["t_open"], out["t_close"])
    return 1e3 * percentile(samples, 0.95) if samples else None
