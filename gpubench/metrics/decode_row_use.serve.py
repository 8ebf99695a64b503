"""``decode_row_use.serve``: the share of the decode rows the engine's
chunks computed that emitted a token a request kept: the ``emitted``
counts over ``units`` x ``slots`` of the ``engine.chunk`` spans that end
in the traced slice, in percent. It counts what ``slot_occupancy.serve``
samples, and also the rows that finished before their chunk ended."""

from gpubench.yardstick import spans


def read(run, out):
    st = spans.on_trace(out)
    chunks = [] if st is None else st.ending_inside("engine.chunk")
    rows = sum(s.span.counts["units"] * s.span.counts["slots"]
               for s in chunks)
    return (100.0 * sum(s.span.counts["emitted"] for s in chunks) / rows
            if rows else None)
