"""``flash_fwd_roofline.serve``: the forward flash kernels' share of their
roofline in the trace up to its slice's end, in percent: the sum of each
call's bound
(:func:`gpubench.yardstick.flops.flash_fwd_bound_s`) at the TRUE length of
the prompt it prefilled, over the sum of the calls' measured times. So a
prompt padded to its bucket counts its padding as waste. The trace starts
with the loop, so the first clients' prefills count too: the decode
chunks between admissions are long, and a slice may hold few.

Prefills run in the order requests were sent (the engine admits first in,
first out), one forward call a layer, and the trace starts before the
first request: the k-th forward kernel of the trace belongs to the
(k // layers)-th request sent. That holds only while the trace holds
exactly one call a layer for each request the engine prefilled; where it
holds another count (prefills batched, chunked, or events lost), which
call served which prompt is unknown and nothing is read."""

from gpubench.yardstick.flops import flash_fwd_bound_s

KERNEL = "flash_fwd"


def read(run, out):
    tl = out.get("timeline")
    if tl is None:
        return None
    s = run.shape
    calls = [k for k in tl.kernels if KERNEL in k.name]
    if len(calls) != s.layers * out["prefilled"]:
        return None
    bound = measured = 0.0
    for index, k in enumerate(calls):
        if k.start >= tl.hi:
            break
        prompt = out["requests"][index // s.layers].prompt_len
        bound += flash_fwd_bound_s(1, prompt, s.heads, s.kv_heads, s.head_dim)
        measured += (k.end - k.start) / 1e6
    return 100.0 * bound / measured if measured else None
