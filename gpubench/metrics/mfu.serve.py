"""``mfu.serve``: the model FLOPs of the window's work over the window's
seconds at the H100's bf16 peak, in percent. The work is every prefill
whose first token appeared in the window (its prompt, causal attention
over it) and every later output token that appeared in it (the weights
once, attention over its context); nothing recomputed, no padding."""

from gpubench.yardstick.flops import PEAK_BF16_FLOPS, forward_flops


def read(run, out):
    t0, t1 = out["t_open"], out["t_close"]
    flops = 0.0
    for r in out["requests"]:
        P = r.prompt_len
        if r.first is not None and t0 < r.first <= t1:
            flops += forward_flops(run.shape, P, P * (P + 1) / 2)
        a, b = max(r.count_at(t0), 1), r.count_at(t1)
        if b > a:  # output token j is fed at position P + j - 1
            keys = sum(P + j for j in range(a, b))
            flops += forward_flops(run.shape, b - a, keys)
    return 100.0 * flops / ((t1 - t0) * PEAK_BF16_FLOPS)
