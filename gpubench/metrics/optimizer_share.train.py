"""``optimizer_share.train``: the device time of the kernels launched in the
``train.optimizer`` spans (clipping and AdamW) over that of the kernels
launched in the ``train.step`` spans, both over the steps that lie wholly
in the traced slice, in percent."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    steps = [] if st is None else st.inside("train.step")
    step_s = st.device_s(steps) if steps else 0.0
    if not step_s:
        return None
    ids = {s.span.id for s in steps}
    optimizer = [s for s in st.named("train.optimizer")
                 if s.span.parent in ids]
    return 100.0 * st.device_s(optimizer) / step_s
