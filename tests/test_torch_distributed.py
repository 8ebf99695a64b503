"""nanotpu_torch's multi-process runtime: the gang environment read as
nanotpu reads it, and real trainer processes that join one gloo group from
an Indexed Job's environment and train together on the CPU.

Two groups of two ``python -m nanotpu_torch.parallel.train`` processes: the
first trains 8 steps over ``--dp 2`` and checkpoints, the second resumes
that checkpoint over ``--fsdp 2``. Each process prints the global batch's
loss, which must equal the other's and the loss of one process training on
the whole batch: the log's four decimals (half a unit, 5e-5) plus 1e-5 (f32:
the two sum the gradient in another order)."""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nanotpu.parallel import distributed as jdist
from nanotpu_torch.parallel import distributed as tdist
from nanotpu_torch.parallel import train as ttrain

REPO = Path(__file__).resolve().parent.parent
GANG_VARS = ("NANOTPU_COORDINATOR", "NANOTPU_NUM_PROCESSES", "NANOTPU_PROCESS_ID",
             "JOB_COMPLETION_INDEX", "JOB_INDEX", "GANG_SIZE",
             "COORDINATOR_SERVICE")

ENVS = {
    "explicit_wins": {"NANOTPU_COORDINATOR": "10.0.0.5:9999",
                      "NANOTPU_NUM_PROCESSES": "4", "NANOTPU_PROCESS_ID": "2",
                      "JOB_COMPLETION_INDEX": "9"},
    "indexed_job": {"JOB_COMPLETION_INDEX": "3", "GANG_SIZE": "8",
                    "COORDINATOR_SERVICE": "llama3-8b-0.llama3-8b"},
    "explicit_port_kept": {"JOB_INDEX": "0", "GANG_SIZE": "2",
                           "COORDINATOR_SERVICE": "svc:1234"},
    "empty": {},
    "gang_of_one": {"GANG_SIZE": "1", "JOB_INDEX": "0",
                    "COORDINATOR_SERVICE": "svc"},
}


@pytest.mark.parametrize("name", list(ENVS))
def test_process_info_equals_nanotpus(name):
    want = jdist.process_info_from_env(ENVS[name])
    got = tdist.process_info_from_env(ENVS[name])
    if want is None:
        assert got is None
    else:
        assert (got.coordinator, got.num_processes, got.process_id) == (
            want.coordinator, want.num_processes, want.process_id)
    assert tdist.DEFAULT_PORT == jdist.DEFAULT_PORT


def test_initialize_noop_without_env(monkeypatch):
    for k in GANG_VARS:
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert tdist.local_device("cpu") == torch.device("cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gang(argv, n=2):
    """``n`` trainer processes joined by the Indexed-Job contract; each
    one's logged (step, loss) pairs."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = {k: v for k, v in os.environ.items() if k not in GANG_VARS}
        env.update({"COORDINATOR_SERVICE": f"127.0.0.1:{port}",
                    "GANG_SIZE": str(n), "JOB_COMPLETION_INDEX": str(rank),
                    "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nanotpu_torch.parallel.train",
             "--device", "cpu", *argv],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    logs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-4000:]
            logs.append(err)
    finally:
        for p in procs:
            p.kill()
    out = []
    for rank, err in enumerate(logs):
        assert f"process {rank}/{n}" in err
        out.append([(int(line.split()[1]), float(line.split()[3]))
                    for line in err.splitlines() if line.startswith("step ")])
    return out, logs


#: the logged losses against one process's: rounding to 4 decimals and 1e-5
ATOL = 5e-5 + 1e-5
TRAIN = ["--steps", "8", "--batch", "8", "--seq", "65", "--data", "markov"]


def test_two_processes_train_as_one(tmp_path):
    """Two processes over --dp 2 print the same falling losses, those of
    one process on the whole batch; process 0 writes each checkpoint, the
    whole tree gathered."""
    ck = tmp_path / "ck"
    (a, b), logs = _gang(TRAIN + ["--dp", "2", "--checkpoint-dir", str(ck),
                                  "--save-every", "4"])
    assert all("joining torch.distributed (gloo)" in e for e in logs)
    assert [s for s, _ in a] == list(range(1, 9))
    assert a == b
    assert a[-1][1] < a[0][1]
    one = ttrain.run(["--device", "cpu"] + TRAIN)["losses"]
    np.testing.assert_allclose([v for _, v in a], [v for _, v in one],
                               atol=ATOL)
    assert sorted(p.name for p in ck.iterdir()) == ["step_4", "step_8"]
    blob = torch.load(ck / "step_8" / "state.pt", weights_only=True)
    assert blob["params"]["lm_head"].shape == (128, 512)
    assert int(blob["opt_state"]["count"]) == 8

    # resumed over fsdp 2: the restored tree is placed on the new mesh
    alone = tmp_path / "alone"
    shutil.copytree(ck, alone)
    resume = ["--steps", "2", "--batch", "8", "--seq", "65", "--data",
              "markov"]
    (a, b), _ = _gang(resume + ["--fsdp", "2", "--checkpoint-dir", str(ck)])
    assert a == b and [s for s, _ in a] == [9, 10]
    one = ttrain.run(["--device", "cpu", "--checkpoint-dir", str(alone)]
                     + resume)["losses"]
    np.testing.assert_allclose([v for _, v in a], [v for _, v in one],
                               atol=ATOL)
