"""``flash_bwd_roofline.train``: the backward flash kernels' share of
their roofline in the traced steps, in percent: the sum of each call's
bound (:func:`gpubench.yardstick.flops.flash_bwd_bound_s`: the fused
kernel's 5 products with dq, dk and dv written; the two-pass dq kernel's
3 with dq, the dk/dv kernel's 4 with dk and dv) over the sum of the calls'
measured times. Every call of a step has the step's shape."""

from gpubench.yardstick.flops import flash_bwd_bound_s


def _kind(name: str):
    if "bwd_dq_bf16" in name:
        return 3, "q"
    if "bwd_kv_bf16" in name:
        return (5, "q kv") if "true" in name else (4, "kv")
    return None


def read(run, out):
    tl = out.get("timeline")
    if tl is None:
        return None
    s, t = run.shape, run.traffic
    bound = measured = 0.0
    for k in tl.inside():
        kind = _kind(k.name)
        if kind is None:
            continue
        bound += flash_bwd_bound_s(t["batch"], t["seq"], s.heads, s.kv_heads,
                                   s.head_dim, *kind)
        measured += (k.end - k.start) / 1e6
    return 100.0 * bound / measured if measured else None
