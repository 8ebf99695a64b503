"""Model weights made from the run's seed, on the device, in the port's
parameter-tree layout (nanotpu's: ``[in, out]`` matrices used as
``x @ w``, one dict a layer). The same tensors go to the program and, cast
to float32, to the reference.

Each kind of matrix is drawn for all layers at once (one ``randn`` into a
``[layers, ...]`` stack in the served dtype, from a generator of its own
seeded by the run's seed and the kind's name), and each layer's leaf is a
view of its stack. So a kind can be drawn again alone, bit for bit, which
is how the training check gets the initial weights back.

The scales are the port's own init (``init_params``): normal at
1/sqrt(fan-in), the embedding and the router at 0.02, the residual
projections (``wo``, ``w_down``) scaled by 1/sqrt(2 layers); norm gains
float32 ones. Training from them is stable and the loss falls. Served,
they keep the model off the chaotic edge: Mistral-7B's bfloat16 logits lie
0.018 (RMS) from float32's, where at unit residual branches, or at twice
the query and key scales, they lie 0.5-1.2 away and bfloat16 rounding
alone reorders most greedy tokens.
"""

from __future__ import annotations

import hashlib
import math

import torch

_DENSE_KINDS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_MOE_KINDS = ("wq", "wk", "wv", "wo", "router", "w_gate", "w_up", "w_down")


def _seed(seed: int, kind: str) -> int:
    digest = hashlib.sha256(f"{seed}:{kind}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def kinds(shape) -> tuple[str, ...]:
    return ("embed", *(_MOE_KINDS if shape.experts else _DENSE_KINDS),
            "lm_head")


def _geometry(shape, kind: str) -> tuple[tuple, int]:
    """(stack shape, fan-in) of one kind."""
    L, D, F = shape.layers, shape.dim, shape.ffn
    q, kv = shape.heads * shape.head_dim, shape.kv_heads * shape.head_dim
    E = (shape.experts,) if shape.experts else ()
    return {
        "embed": ((shape.vocab, D), D),
        "lm_head": ((D, shape.vocab), D),
        "wq": ((L, D, q), D), "wk": ((L, D, kv), D), "wv": ((L, D, kv), D),
        "wo": ((L, q, D), q),
        "router": ((L, D, shape.experts), D),
        "w_gate": ((L, *E, D, F), D), "w_up": ((L, *E, D, F), D),
        "w_down": ((L, *E, F, D), F),
    }[kind]


def _std(shape, kind: str, fan_in: int) -> float:
    if kind in ("embed", "router"):
        return 0.02
    resid = 1.0 / math.sqrt(2 * shape.layers)
    return (resid if kind in ("wo", "w_down") else 1.0) / math.sqrt(fan_in)


def draw(shape, seed: int, kind: str, dtype, device):
    """One kind's stack, as the program is given it (the router in
    float32, every other matrix in ``dtype``)."""
    dims, fan_in = _geometry(shape, kind)
    dt = torch.float32 if kind == "router" else dtype
    gen = torch.Generator(device=device).manual_seed(_seed(seed, kind))
    w = torch.randn(dims, generator=gen, dtype=dt, device=device)
    return w.mul_(_std(shape, kind, fan_in))


def tree(shape, seed: int, dtype, device) -> dict:
    """The whole parameter tree."""
    stacks = {k: draw(shape, seed, k, dtype, device)
              for k in kinds(shape)}
    return tree_of(shape, stacks, device)


def tree_of(shape, stacks: dict, device) -> dict:
    """The port's tree over ``stacks`` (each layer's leaves views of them),
    with float32 ones for the norm gains."""
    def ones():
        return torch.ones((shape.dim,), dtype=torch.float32, device=device)

    ffn_key, norm_key = ("moe", "moe_norm") if shape.experts else ("mlp", "mlp_norm")
    ffn_kinds = (("router",) if shape.experts else ()) + ("w_gate", "w_up", "w_down")
    layers = []
    for i in range(shape.layers):
        layers.append({
            "attn": {k: stacks[k][i] for k in ("wq", "wk", "wv", "wo")},
            ffn_key: {k: stacks[k][i] for k in ffn_kinds},
            "attn_norm": ones(),
            norm_key: ones(),
        })
    return {"embed": stacks["embed"], "layers": layers, "final_norm": ones(),
            "lm_head": stacks["lm_head"]}


def kind_leaves(shape, tree_: dict, kind: str) -> list:
    """The leaves of ``tree_`` that a kind's stack holds, in stack order."""
    if kind in ("embed", "lm_head"):
        return [tree_[kind]]
    group = "attn" if kind in ("wq", "wk", "wv", "wo") else (
        "moe" if shape.experts else "mlp")
    return [layer[group][kind] for layer in tree_["layers"]]


def leaves(tree_) -> list:
    """The leaves of a tree in the port's order: dict keys as inserted,
    list items in order."""
    if isinstance(tree_, dict):
        return [leaf for v in tree_.values() for leaf in leaves(v)]
    if isinstance(tree_, (list, tuple)):
        return [leaf for v in tree_ for leaf in leaves(v)]
    return [tree_]


@torch.no_grad()
def change_norms(shape, seed: int, tree_: dict, dtype) -> list:
    """Per leaf, in :func:`leaves` order, the float32 norm of the leaf less
    its initial value, drawn again kind by kind from the seed."""
    norms = {}
    for kind in kinds(shape):
        start = draw(shape, seed, kind, dtype, tree_["embed"].device)
        now = kind_leaves(shape, tree_, kind)
        starts = [start] if kind in ("embed", "lm_head") else start.unbind(0)
        for leaf, leaf0 in zip(now, starts):
            norms[id(leaf)] = float(torch.linalg.vector_norm(
                leaf.float() - leaf0.float()))
        del start, starts
    out = []
    for leaf in leaves(tree_):
        if id(leaf) not in norms:  # a norm gain: it starts at one
            norms[id(leaf)] = float(torch.linalg.vector_norm(leaf.float() - 1))
        out.append(norms[id(leaf)])
    return out
