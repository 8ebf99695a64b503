"""``decode_step_ms.serve``: the device time of the kernels launched in the
``engine.chunk`` spans that lie wholly in the traced slice (a CUDA
graph's kernels with its launch), over those chunks' decode units (their
``units`` counts), in milliseconds a step."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    chunks = [] if st is None else st.inside("engine.chunk")
    units = sum(s.span.counts["units"] for s in chunks)
    return 1e3 * st.device_s(chunks) / units if units else None
