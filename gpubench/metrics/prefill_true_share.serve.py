"""``prefill_true_share.serve``: the share of prefilled tokens that are the
prompts' own, not padding to their bucket: the ``tokens`` over the
``bucket`` counts of the ``engine.prefill`` spans that end in the traced
slice, in percent."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    prefills = [] if st is None else st.ending_inside("engine.prefill")
    bucket = sum(s.span.counts["bucket"] for s in prefills)
    return (100.0 * sum(s.span.counts["tokens"] for s in prefills) / bucket
            if bucket else None)
