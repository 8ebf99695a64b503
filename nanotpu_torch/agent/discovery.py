"""Local GPU discovery for a node agent, the port of
``nanotpu/agent/discovery.py``.

nanotpu's agent finds a host's TPU chips; the port's finds its NVIDIA
cards, trying, in nanotpu's order:

1. **the runtime**: ``torch.cuda`` (the count and the name of card 0),
   only with ``NANOTPU_AGENT_USE_TORCH=1``, so that the agent never starts
   CUDA where none exists (nanotpu gates its JAX probe the same way);
2. **the environment**: ``NVIDIA_VISIBLE_DEVICES`` as the NVIDIA container
   toolkit sets it, a comma-separated list of indices or UUIDs (``all``
   defers to the next probe; ``none``, ``void`` or empty expose no card
   and defer too);
3. **device files**: each card appears as ``/dev/nvidiaN``;
4. a default of one host: 8 cards, as on an HGX H100 board.

The record holds the card kind, the count and the device paths. It has no
node labels: nanotpu's label vocabulary and torus belong to the TPU
control plane, which the port does not carry.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import re

log = logging.getLogger("nanotpu_torch.agent.discovery")

#: what the probes that cannot read a card's name assume, and the default
#: host's card count (an HGX H100 board)
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"
DEFAULT_CHIPS = 8


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """What the agent knows about this host's cards."""

    kind: str  # the card's name, as torch.cuda.get_device_name gives it
    n_chips: int
    device_paths: tuple[str, ...] = ()  # /dev/nvidiaN per card, may be empty

    def device_path(self, chip: int) -> str:
        if chip < len(self.device_paths):
            return self.device_paths[chip]
        return f"/dev/nvidia{chip}"


def _from_torch() -> HostTopology | None:
    if os.environ.get("NANOTPU_AGENT_USE_TORCH") != "1":
        return None
    import torch

    try:
        n = torch.cuda.device_count()
        kind = torch.cuda.get_device_name(0) if n else ""
    except RuntimeError as exc:  # a driver that fails to initialise
        log.warning("torch discovery failed: %s", exc)
        return None
    if not n:
        return None
    return HostTopology(kind=kind, n_chips=n)


def _from_env(env: dict[str, str]) -> HostTopology | None:
    visible = env.get("NVIDIA_VISIBLE_DEVICES", "").strip()
    if visible.lower() in ("", "all", "none", "void"):
        return None
    ids = [x.strip() for x in visible.split(",") if x.strip()]
    # indices name the device files; UUIDs do not
    paths = (tuple(f"/dev/nvidia{x}" for x in ids)
             if all(x.isdigit() for x in ids) else ())
    return HostTopology(kind=DEFAULT_KIND, n_chips=len(ids),
                        device_paths=paths)


def _from_devfiles() -> HostTopology | None:
    paths = sorted(glob.glob("/dev/nvidia[0-9]*"),
                   key=lambda p: int(re.sub(r"\D", "", p) or 0))
    if not paths:
        return None
    return HostTopology(kind=DEFAULT_KIND, n_chips=len(paths),
                        device_paths=tuple(paths))


def discover(env: dict[str, str] | None = None) -> HostTopology:
    env = dict(os.environ if env is None else env)
    for probe in (_from_torch, lambda: _from_env(env), _from_devfiles):
        found = probe()
        if found is not None:
            log.info("discovered GPU host: kind=%s cards=%d", found.kind,
                     found.n_chips)
            return found
    log.info("no GPU runtime detected; defaulting to one host of %d cards",
             DEFAULT_CHIPS)
    return HostTopology(kind=DEFAULT_KIND, n_chips=DEFAULT_CHIPS)
