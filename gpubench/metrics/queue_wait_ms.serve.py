"""``queue_wait_ms.serve``: the mean wait of a request in the engine's queue,
from its submission to its pop at admission (the ``engine.queue`` spans
that end in the traced slice), in milliseconds."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    waits = [] if st is None else st.ending_inside("engine.queue")
    return (sum(s.end - s.start for s in waits) / len(waits) / 1e3
            if waits else None)
