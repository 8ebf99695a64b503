"""nanotpu_torch's device discovery against nanotpu's: the same probe
order (the runtime behind a gate, the environment, device files, a
default), each probe on its own, with the runtime, the environment and the
device files faked (the CPU has no card)."""

import fnmatch

import pytest
import torch

from nanotpu.agent import discovery as jdisc
from nanotpu_torch.agent import discovery as tdisc

GATE = "NANOTPU_AGENT_USE_TORCH"


@pytest.fixture()
def no_card_probes(monkeypatch):
    """Every probe but the one a test sets finds nothing: the gate shut,
    no NVIDIA_VISIBLE_DEVICES, no device files."""
    monkeypatch.delenv(GATE, raising=False)
    monkeypatch.delenv("NVIDIA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(tdisc.glob, "glob", lambda pattern: [])


def test_runtime_probe_reads_the_count_and_name(monkeypatch):
    monkeypatch.setenv(GATE, "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    found = tdisc._from_torch()
    assert found == tdisc.HostTopology(kind="NVIDIA H100 80GB HBM3",
                                       n_chips=2)
    assert found.device_path(1) == "/dev/nvidia1"


def test_runtime_probe_without_a_card_defers(monkeypatch):
    monkeypatch.setenv(GATE, "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tdisc._from_torch() is None


def test_runtime_probe_defers_when_the_driver_fails(monkeypatch):
    def fails():
        raise RuntimeError("CUDA driver initialization failed")

    monkeypatch.setenv(GATE, "1")
    monkeypatch.setattr(torch.cuda, "device_count", fails)
    assert tdisc._from_torch() is None


def test_closed_gate_initialises_no_cuda(monkeypatch, no_card_probes):
    """With the gate shut (unset, or any value but 1) discovery touches no
    ``torch.cuda`` call that could start the runtime."""
    def touched(*args):
        raise AssertionError("torch.cuda touched with the gate shut")

    for name in ("device_count", "get_device_name", "init"):
        monkeypatch.setattr(torch.cuda, name, touched)
    for gate in (None, "0", "true"):
        if gate is not None:
            monkeypatch.setenv(GATE, gate)
        assert tdisc._from_torch() is None
        assert tdisc.discover({}).n_chips == tdisc.DEFAULT_CHIPS
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("value,count,paths", [
    ("0", 1, ("/dev/nvidia0",)),
    ("0,1,2,3", 4, tuple(f"/dev/nvidia{i}" for i in range(4))),
    (" 1 , 3 ", 2, ("/dev/nvidia1", "/dev/nvidia3")),
    ("GPU-5c8e1a2b,GPU-9f0d3c4e", 2, ()),
])
def test_env_probe_counts_the_visible_devices(value, count, paths):
    found = tdisc._from_env({"NVIDIA_VISIBLE_DEVICES": value})
    assert (found.n_chips, found.device_paths) == (count, paths)
    assert found.kind == tdisc.DEFAULT_KIND


@pytest.mark.parametrize("value", ["all", "ALL", "none", "void", "", "  "])
def test_env_probe_defers_on_all_none_void_and_empty(value):
    assert tdisc._from_env({"NVIDIA_VISIBLE_DEVICES": value}) is None
    assert tdisc._from_env({}) is None


def test_devfile_probe_reads_the_card_files_in_order(monkeypatch):
    seen = []

    def fake_glob(pattern):
        seen.append(pattern)
        return ["/dev/nvidia10", "/dev/nvidia2", "/dev/nvidia0",
                "/dev/nvidia1"]

    monkeypatch.setattr(tdisc.glob, "glob", fake_glob)
    found = tdisc._from_devfiles()
    assert seen == ["/dev/nvidia[0-9]*"]
    assert found.n_chips == 4
    assert found.device_paths == ("/dev/nvidia0", "/dev/nvidia1",
                                  "/dev/nvidia2", "/dev/nvidia10")
    assert found.device_path(3) == "/dev/nvidia10"
    assert found.device_path(4) == "/dev/nvidia4"
    monkeypatch.setattr(tdisc.glob, "glob", lambda pattern: [])
    assert tdisc._from_devfiles() is None


def test_devfile_pattern_leaves_out_the_control_files():
    files = ["/dev/nvidia0", "/dev/nvidia7", "/dev/nvidiactl",
             "/dev/nvidia-uvm", "/dev/nvidia-uvm-tools", "/dev/nvidia-modeset",
             "/dev/nvidia-caps"]
    assert fnmatch.filter(files, "/dev/nvidia[0-9]*") == ["/dev/nvidia0",
                                                         "/dev/nvidia7"]


def test_default_is_one_hgx_host(no_card_probes):
    assert tdisc.discover({}) == tdisc.HostTopology(
        kind="NVIDIA H100 80GB HBM3", n_chips=8)


def _order(module, names, monkeypatch, found_at=None):
    """The probes ``discover`` calls, in order, each faked to find nothing
    (or, at ``found_at``, a host)."""
    seen = []
    host = tdisc.HostTopology(kind="found", n_chips=3)

    def fake(label):
        def probe(*args):
            seen.append(label)
            return host if label == found_at else None
        return probe

    for label, name in zip(("runtime", "env", "devfiles"), names):
        monkeypatch.setattr(module, name, fake(label))
    return seen, module.discover({})


def test_probe_order_is_nanotpus(monkeypatch):
    want, _ = _order(jdisc, ("_from_jax", "_from_env", "_from_devfiles"),
                     monkeypatch)
    got, host = _order(tdisc, ("_from_torch", "_from_env", "_from_devfiles"),
                       monkeypatch)
    assert got == want == ["runtime", "env", "devfiles"]
    assert host.n_chips == tdisc.DEFAULT_CHIPS


@pytest.mark.parametrize("first", ["runtime", "env", "devfiles"])
def test_the_first_probe_that_finds_wins(monkeypatch, first):
    seen, host = _order(tdisc, ("_from_torch", "_from_env", "_from_devfiles"),
                        monkeypatch, found_at=first)
    assert (host.kind, host.n_chips) == ("found", 3)
    assert seen == ["runtime", "env", "devfiles"][:seen.index(first) + 1]


def test_discover_reads_the_environment_it_is_given(no_card_probes):
    found = tdisc.discover({"NVIDIA_VISIBLE_DEVICES": "4,5"})
    assert found.n_chips == 2
    assert found.device_paths == ("/dev/nvidia4", "/dev/nvidia5")
