"""``peak_mem_gib.train``: the most device memory the process held in
tensors, ``torch.cuda.max_memory_allocated()`` read after the window, in
GiB."""


def read(run, out):
    peak = out.get("memory_peak_bytes")
    return peak / 2**30 if peak else None
