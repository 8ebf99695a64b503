"""Token-file dataset: memory-mapped corpus -> training batches.

The port's own copy of ``nanotpu/data/tokens.py``, which imports only numpy.

* **One flat binary file of token ids** (uint16 for vocab <= 65536, else
  uint32/int32), memory-mapped: no records, no framing, no index file.
* **Stateless sampling.** Batch ``i`` of a run is a pure function of
  (seed, i): rows are drawn at uniformly random offsets by a PRNG keyed
  per batch index, so a resumed run recomputes exactly the batches it
  would have seen, with no loader state in the checkpoint.
* **Chunked host->device transfer.** ``batches`` yields [chunk, B, S]
  blocks, so the train loop uploads one block per ``gen_chunk`` steps.
"""

from __future__ import annotations

import os

import numpy as np

_DTYPES = {2: np.uint16, 4: np.uint32}


def write_tokens(path: str, tokens, vocab_size: int | None = None) -> None:
    """Write a flat token file. Width is chosen from ``vocab_size`` (or
    the max token): uint16 when every id fits, else uint32."""
    arr = np.asarray(tokens).reshape(-1)
    hi = int(vocab_size - 1 if vocab_size else arr.max(initial=0))
    dt = np.uint16 if hi < 2 ** 16 else np.uint32
    if arr.size and (arr.min() < 0 or int(arr.max()) > hi):
        raise ValueError("token ids out of range for the declared vocab")
    arr.astype(dt).tofile(path)


def open_tokens(path: str, dtype=None) -> np.memmap:
    """Memory-map a token file. The default width is uint16 (the write
    side's choice for vocab <= 65536); pass ``dtype=np.uint32`` for
    large-vocab corpora — a flat file carries no header, so the width is
    the caller's contract, not an inference."""
    size = os.path.getsize(path)
    dt = np.dtype(dtype if dtype is not None else _DTYPES[2])
    if size % dt.itemsize:
        raise ValueError(
            f"{path}: {size} bytes is not a whole number of {dt} tokens"
        )
    return np.memmap(path, dtype=dt, mode="r")


def sample_chunk(
    data: np.memmap, chunk: int, batch: int, seq: int,
    seed: int, index: int,
) -> np.ndarray:
    """[chunk, batch, seq] int32 rows at random offsets — a pure function
    of (seed, index), so resume at step k regenerates step k's batch."""
    n = data.shape[0]
    if n < seq:
        raise ValueError(f"corpus has {n} tokens < seq {seq}")
    rng = np.random.default_rng((seed, index))
    offsets = rng.integers(0, n - seq + 1, size=chunk * batch)
    rows = data[offsets[:, None] + np.arange(seq)[None, :]]
    return rows.reshape(chunk, batch, seq).astype(np.int32)


def batches(path: str, batch: int, seq: int, *, seed: int = 0,
            chunk: int = 1, start_index: int = 0, dtype=None):
    """Infinite iterator of [chunk, batch, seq] int32 blocks."""
    data = open_tokens(path, dtype=dtype)
    index = start_index
    while True:
        yield sample_chunk(data, chunk, batch, seq, seed, index)
        index += 1
