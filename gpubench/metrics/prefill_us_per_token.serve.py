"""``prefill_us_per_token.serve``: the device time of the kernels launched
in the ``engine.prefill`` spans that lie wholly in the traced slice, over
those prefills' true prompt tokens (their ``tokens`` counts), in
microseconds a token. With ``decode_step_ms.serve`` it splits the model
step that ``mfu.serve`` averages."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    prefills = [] if st is None else st.inside("engine.prefill")
    tokens = sum(s.span.counts["tokens"] for s in prefills)
    return 1e6 * st.device_s(prefills) / tokens if tokens else None
