"""``idle_share.train``: the share of the traced steps in which no kernel
ran on the card (1 - the union of the kernels' intervals over the slice),
in percent."""


def read(run, out):
    tl = out.get("timeline")
    return None if tl is None else 100.0 * (1.0 - tl.busy_s() / tl.window_s)
