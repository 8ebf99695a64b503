"""CUDA graphs of the serving engine's decode units: the port's counterpart
of nanotpu's compiled decode chunk.

nanotpu jits a whole chunk, a ``lax.scan`` of decode steps or speculative
cycles (``make_chunk``), and compiles its large chunks ahead of time on a
background thread (``compile_large``). The port captures ONE unit, a decode
step or a speculative cycle at one K, as a CUDA graph at warm-up, and a
chunk replays it once a step. A chunk thus still stops at the most tokens a
row owes, where a graph of the whole chunk would fix its length.

A graph reads and writes fixed addresses. :class:`DecodeBuffers` holds the
carried per-row state (tokens, temperatures, done flags, budgets), a device
step counter and the chunk's output blocks; the engine's caches are
allocated once and written in place. A unit's body reads these tensors and
ends by copying its new values back into them, so one replay is one more
step of the same loop. top-k, top-p, the eos id and K are fixed per graph,
as nanotpu's jit closes over them. The engine's generator is registered
with every graph, so each replay draws fresh uniforms from where the last
draw left the generator.

Nothing here falls back to eager ops: a capture or a replay that fails
raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class DecodeBuffers:
    """The fixed device tensors a decode unit reads and writes: the carry
    (``tokens``, ``temps``, ``done``, ``remaining``, one entry a slot), the
    ``step`` counter that picks the output row, and the output blocks of a
    chunk of at most ``steps`` units: ``toks [steps, slots]`` for plain
    steps, ``emits[k] [steps, slots, k+1]`` and ``counts[k] [steps,
    slots]`` for speculative cycles at each K in ``ks``. Every slot starts
    frozen (done), as an empty slot is."""

    def __init__(self, slots: int, steps: int, ks, device):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tokens = zeros((slots,), torch.int64)
        self.temps = zeros((slots,), torch.float32)
        self.done = torch.ones((slots,), dtype=torch.bool, device=device)
        self.remaining = zeros((slots,), torch.int32)
        self.step = zeros((1,), torch.int64)
        self.toks = zeros((steps, slots), torch.int64)
        self.emits = {k: zeros((steps, slots, k + 1), torch.int64)
                      for k in ks if k > 0}
        self.counts = {k: zeros((steps, slots), torch.int32)
                       for k in ks if k > 0}

    def upload(self, tokens: np.ndarray, temps: np.ndarray, done: np.ndarray,
               remaining: np.ndarray) -> None:
        """Copy the host's mirrors into the carry, in place."""
        for dst, src in ((self.tokens, tokens), (self.temps, temps),
                         (self.done, done), (self.remaining, remaining)):
            dst.copy_(torch.from_numpy(src))

    def carry(self, tokens, done, remaining) -> None:
        """A unit's last writes: its new carry into the tensors it read."""
        self.tokens.copy_(tokens)
        self.done.copy_(done)
        self.remaining.copy_(remaining)

    def record(self, *outputs) -> None:
        """Write each (block, value) pair's value as row ``step`` of its
        block, then advance ``step``; :meth:`start` resets it."""
        for block, value in outputs:
            block.index_copy_(0, self.step, value[None])
        self.step.add_(1)

    def start(self) -> None:
        """Before a chunk: its first unit writes output row 0."""
        self.step.zero_()


class StepGraph:
    """``body`` (a unit of decode work on fixed tensors) captured as a CUDA
    graph. The body first runs ``WARMUP_RUNS`` times eagerly on ``stream``,
    as capture requires (libraries set up their per-stream state there),
    then once under capture on the same stream, into ``pool``, with
    ``generator`` registered. ``capture_s`` is the time all of that took,
    ``replays`` counts :meth:`replay` calls."""

    WARMUP_RUNS = 2

    def __init__(self, body, generator: torch.Generator, pool,
                 stream: torch.cuda.Stream):
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(self.WARMUP_RUNS):
                body()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        # thread_local: the engine captures on its own thread, and another
        # thread's CUDA calls do not touch this capture's stream
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            body()
        torch.cuda.synchronize()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1

    def release(self) -> None:
        """Drop the graph (and its share of the pool); counters stay."""
        self.graph = None
