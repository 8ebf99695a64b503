"""The plain references against the port at tiny float32 sizes on the CPU:
the same weights give the same logits, losses, gradients and AdamW steps.
(Only this test imports the port beside the reference.)"""

from __future__ import annotations

import pytest
import torch

from gpubench.families import mistral, mixtral
from gpubench.reference import adamw, dense, moe
from gpubench.reference.common import Numerics
from gpubench.tests.tiny import DENSE, MOE
from gpubench.yardstick import weights
from gpubench.yardstick.flops import Shape

SEED = 2**32 + 3


def _tree(conf):
    return weights.tree(Shape.of(conf), SEED, torch.float32, "cpu")


def _tokens(conf, shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, conf["vocab_size"], shape, generator=g)


def test_dense_logits_equal_the_port_forward():
    from nanotpu_torch.models import llama

    cfg, _ = mistral.port(DENSE)
    tree = _tree(DENSE)
    toks = _tokens(DENSE, (37,))
    want = llama.forward(tree, toks[None], cfg)[0]  # flash's plain version
    got = dense.logits(tree, DENSE, toks.tolist(), range(0, 37))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # a window of positions is the same rows
    part = dense.logits(tree, DENSE, toks.tolist(), range(20, 30))
    torch.testing.assert_close(part, want[20:30], rtol=1e-4, atol=1e-4)


def test_moe_loss_and_gradients_equal_the_port():
    from nanotpu_torch.models import mixtral as port_mixtral

    cfg, loss_fn = mixtral.port(MOE)
    tree = _tree(MOE)
    leaves = weights.leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    toks = _tokens(MOE, (3, 41))
    want = loss_fn(tree, toks, cfg)
    want_g = torch.autograd.grad(want, leaves)
    got = mixtral.reference_loss(tree, MOE, toks)
    got_g = torch.autograd.grad(got, leaves)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert port_mixtral.MixtralConfig is type(cfg)


def test_capacity_drops_in_token_order():
    probs = torch.tensor([[0.6, 0.3, 0.1], [0.5, 0.4, 0.1], [0.2, 0.7, 0.1],
                          [0.7, 0.1, 0.2]])
    expert, weight, kept = moe.route(probs, top_k=2, capacity=2)
    assert expert.tolist() == [[0, 0, 1, 0], [1, 1, 0, 2]]
    # expert 0 is full after tokens 0 and 1: token 3's first choice and
    # token 2's second choice drop; expert 1 takes tokens 2 then 0, full
    # before token 1's second choice
    assert kept.tolist() == [[True, True, True, False],
                             [True, False, False, True]]
    torch.testing.assert_close(weight[:, 0], torch.tensor([2 / 3, 1 / 3]))


def test_two_adamw_steps_equal_the_ports():
    from nanotpu_torch.parallel.train import AdamW, TrainState, build_train_step

    opt = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
           "weight_decay": 0.1, "max_norm": 1.0}
    cfg, loss_fn = mixtral.port(MOE)
    toks = _tokens(MOE, (2, 2, 33), seed=5)
    port_tree = _tree(MOE)
    for p in weights.leaves(port_tree):
        p.requires_grad_(True)
    port_opt = AdamW(**opt)
    state = TrainState(port_tree, port_opt.init(port_tree), 0)
    step = build_train_step(cfg, port_opt, loss_fn=loss_fn)
    losses = []
    for batch in toks:
        state, loss = step(state, batch)
        losses.append(float(loss))
    ref_tree = _tree(MOE)
    got = adamw.two_steps(weights.leaves(ref_tree),
                          lambda b: mixtral.reference_loss(ref_tree, MOE, b),
                          [toks[0], toks[1]], opt)
    assert got["losses"] == pytest.approx(losses, abs=1e-5)
    # Adam's first update, lr g / (|g| + eps), swings across +-lr where g is
    # near nought, with the gradient's rounding: a few elements part by a
    # few hundredths of lr; a wrong update parts them all by about lr
    for a, b in zip(weights.leaves(ref_tree), weights.leaves(state.params)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-4,
                                   atol=opt["lr"] / 20)


def test_fp8_numerics_round_to_e4m3():
    num = Numerics("fp8")
    x = torch.tensor([[1.0, 0.3, -0.07]])
    w = torch.eye(3)
    got = num.mm(x, w)
    assert not torch.equal(got, x)
    torch.testing.assert_close(got, x, rtol=0.07, atol=0.0)
    assert torch.equal(Numerics().mm(x, w), x)


def test_fp8_gradients_stay_near_float32():
    # the control computes in float8, it does not freeze the step: every
    # leaf's gradient comes through the rounded products at about its
    # float32 norm (a gradient lost to rounding would read a gap near 1)
    import statistics

    tree = _tree(MOE)
    leaves = weights.leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    toks = _tokens(MOE, (2, 65))
    norms = {}
    for mode in ("float32", "fp8"):
        loss = mixtral.reference_loss(tree, MOE, toks, Numerics(mode))
        norms[mode] = [float(g.norm())
                       for g in torch.autograd.grad(loss, leaves)]
    ref, got = norms["float32"], norms["fp8"]
    floor = statistics.median(ref)
    gaps = [abs(a - b) / max(b, floor) for a, b in zip(got, ref)]
    assert statistics.median(gaps) < 0.05 and max(gaps) < 0.15, gaps
