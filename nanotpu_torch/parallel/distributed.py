"""Multi-process runtime: gang pods -> one ``torch.distributed`` job, the
port of ``nanotpu/parallel/distributed.py``.

Each process derives (coordinator, num_processes, process_id) from the same
environment nanotpu reads (an Indexed Job's ``JOB_COMPLETION_INDEX``, the
gang size, the headless service of pod 0, or the explicit ``NANOTPU_*``
triple) and joins one process group with a ``tcp://`` rendezvous at the
coordinator. After that the meshes of :mod:`nanotpu_torch.parallel.mesh`
span every process.

nanotpu runs one process a host, which sees all of that host's chips. The
port runs one process a card, PyTorch's idiom: process ``i`` uses
``cuda:(i % torch.cuda.device_count())``, so a host of four cards runs four
processes.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

log = logging.getLogger("nanotpu_torch.distributed")

DEFAULT_PORT = 8476


@dataclass(frozen=True)
class ProcessInfo:
    coordinator: str  # host:port of process 0
    num_processes: int
    process_id: int


def process_info_from_env(env: dict[str, str] | None = None) -> ProcessInfo | None:
    """The process triple from the pod environment, nanotpu's rules.

    Recognized (first match wins):
    - explicit: NANOTPU_COORDINATOR, NANOTPU_NUM_PROCESSES, NANOTPU_PROCESS_ID
    - Indexed Job: JOB_COMPLETION_INDEX (or the batch.kubernetes.io
      annotation exported as JOB_INDEX) + GANG_SIZE + COORDINATOR_SERVICE
      (headless-service DNS of pod 0, DEFAULT_PORT unless it names one)

    Returns None when the process is not part of a multi-process gang.
    """
    env = dict(os.environ if env is None else env)
    if "NANOTPU_COORDINATOR" in env:
        return ProcessInfo(
            coordinator=env["NANOTPU_COORDINATOR"],
            num_processes=int(env["NANOTPU_NUM_PROCESSES"]),
            process_id=int(env["NANOTPU_PROCESS_ID"]),
        )
    idx = env.get("JOB_COMPLETION_INDEX", env.get("JOB_INDEX", ""))
    size = env.get("GANG_SIZE", "")
    svc = env.get("COORDINATOR_SERVICE", "")
    if not (idx and size and svc):
        return None
    n = int(size)
    if n <= 1:
        return None
    coord = svc if ":" in svc else f"{svc}:{DEFAULT_PORT}"
    return ProcessInfo(coordinator=coord, num_processes=n, process_id=int(idx))


def local_device(device=None) -> torch.device:
    """This process's device: ``cuda:(rank % device_count)`` for a CUDA
    device in a joined group, else ``device`` itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and dist.is_initialized():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def initialize(info: ProcessInfo | None = None, device=None) -> bool:
    """Join the process group if this process is part of a gang: ``nccl``
    for a ``cuda`` device (the default), ``gloo`` for ``cpu``, rendezvous
    at ``tcp://<coordinator>``. A CUDA process first makes its card,
    :func:`local_device`, the current one.

    Returns False and does nothing without a gang environment; returns
    True, and joins nothing again, when the group already exists."""
    info = info or process_info_from_env()
    if info is None:
        log.info("no multi-process environment; staying single-process")
        return False
    if dist.is_initialized():
        return True
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(info.process_id % torch.cuda.device_count())
    backend = "nccl" if dev.type == "cuda" else "gloo"
    log.info("joining torch.distributed (%s): coordinator=%s process %d/%d",
             backend, info.coordinator, info.process_id, info.num_processes)
    dist.init_process_group(
        backend, init_method=f"tcp://{info.coordinator}",
        world_size=info.num_processes, rank=info.process_id,
    )
    return True
