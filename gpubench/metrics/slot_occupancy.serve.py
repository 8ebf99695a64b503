"""``slot_occupancy.serve``: the mean share of the engine's slots holding a
request, from ``Engine.metrics()["active"]`` read every
``occupancy_every_seconds`` through the window, in percent."""


def read(run, out):
    samples = out["occupancy"]
    return 100.0 * sum(samples) / len(samples) if samples else None
