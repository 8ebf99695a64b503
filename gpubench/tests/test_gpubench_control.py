"""``correct`` at a size the CPU holds: a sound run of every cell passes its
comparison; the controls (the program's int8 path for serving, the
reference in float8 for training) and each fault a cell can have, planted
in the program under the harness, fail it. The harness's look for a card
is skipped (the run is driven through :func:`gpubench.run.run_cell`);
everything after it runs as on the chip."""

from __future__ import annotations

import pytest
import torch

from gpubench.tests import tiny
from nanotpu_torch.models import mixtral as port_mixtral
from nanotpu_torch.parallel import train as port_train
from nanotpu_torch.serving import engine as port_engine

SERVE = tiny.serving_cells()
TRAIN = tiny.training_cells()


def _failed(line: dict) -> list[str]:
    return [k for k, c in line["compared"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("cell", SERVE + TRAIN)
def test_a_sound_run_is_correct(cell):
    line = tiny.run(cell)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("control", ["int8"])
@pytest.mark.parametrize("cell", SERVE)
def test_the_lower_precision_controls_fail_serving(cell, control):
    # two seconds: some hundreds of served tokens, among which int8's
    # errors reorder some (at 0.05-0.12 of a logit; float32 reads 0)
    line = tiny.run(cell, control=control, seconds=2.0)
    assert not line["correct"]
    assert _failed(line) == ["mean_gap"]


@pytest.mark.parametrize("control", ["fp8", "half_batch", "unchanged"])
@pytest.mark.parametrize("cell", TRAIN)
def test_the_reference_in_the_programs_place_fails_training(cell, control):
    line = tiny.run(cell, control=control)
    assert not line["correct"], line["compared"]


def _keep_state(cache_arr, new, offsets):
    return cache_arr  # the decode step writes nothing into its cache


def _alter_tokens(orig):
    def step(*args, **kwargs):
        cache, tokens, done, remaining = orig(*args, **kwargs)
        altered = (tokens + 1) % tiny.DENSE["vocab_size"]
        return cache, torch.where(done, tokens, altered), done, remaining
    return step


def _half_the_rows(orig):
    def step(*args, **kwargs):
        nxt, cache = orig(*args, **kwargs)
        half = nxt.shape[0] // 2
        return torch.cat([nxt[:half], nxt[:nxt.shape[0] - half]]), cache
    return step


SERVING_FAULTS = {
    "state unchanged": ("_write_rows", lambda orig: _keep_state),
    "token altered": ("serving_chunk_step", _alter_tokens),
    "half the batch left out": ("serving_step", _half_the_rows),
}


@pytest.mark.parametrize("fault", sorted(SERVING_FAULTS))
@pytest.mark.parametrize("cell", SERVE)
def test_serving_faults_fail(cell, fault, monkeypatch):
    name, wrap = SERVING_FAULTS[fault]
    monkeypatch.setattr(port_engine, name, wrap(getattr(port_engine, name)))
    line = tiny.run(cell)
    assert not line["correct"], line["compared"]


def _no_update(self, grads, opt_state, params, norm=None):
    return params, opt_state


def _half_batch(orig):
    def loss_fn(params, tokens, cfg, shard=None):
        return orig(params, tokens[: tokens.shape[0] // 2], cfg)
    return loss_fn


def _altered_loss(orig):
    def loss_fn(params, tokens, cfg, shard=None):
        return orig(params, tokens, cfg) + 0.1
    return loss_fn


TRAINING_FAULTS = {
    "state unchanged": (port_train.AdamW, "update", lambda orig: _no_update),
    "half the batch left out": (port_mixtral, "loss_fn", _half_batch),
    "answer altered": (port_mixtral, "loss_fn", _altered_loss),
}


@pytest.mark.parametrize("fault", sorted(TRAINING_FAULTS))
@pytest.mark.parametrize("cell", TRAIN)
def test_training_faults_fail(cell, fault, monkeypatch):
    owner, name, wrap = TRAINING_FAULTS[fault]
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    line = tiny.run(cell)
    assert not line["correct"], line["compared"]
