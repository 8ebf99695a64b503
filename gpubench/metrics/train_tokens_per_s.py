"""``train_tokens_per_s``: the tokens of every step run in the window, over
the window's seconds; the window opens and closes on a synchronised step."""


def read(run, out):
    if not out["steps"]:
        return None
    return out["steps"] * out["tokens_per_step"] / (out["t_close"] - out["t_open"])
