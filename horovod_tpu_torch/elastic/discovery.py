"""Host and device discovery for elastic training.

Port of ``horovod_tpu/elastic/discovery.py`` (upstream
``horovod/runner/elastic/discovery.py``): ``HostDiscovery`` and its two
kinds, a fixed host table and a user script printing ``host:slots``
lines, as they are; and ``DeviceDiscovery``, whose default probe is this
process's visible CUDA devices (the reference's is ``jax.devices()``), or
the CPU when asked for it.
"""

from __future__ import annotations

import subprocess
from typing import Callable, List, Optional, Sequence

__all__ = ["HostDiscovery", "FixedHostDiscovery", "ScriptHostDiscovery",
           "DeviceDiscovery"]


class HostDiscovery:
    """Interface: ``find_available_hosts_and_slots() -> {host: slots}``."""

    def find_available_hosts_and_slots(self) -> dict:
        raise NotImplementedError


class FixedHostDiscovery(HostDiscovery):
    def __init__(self, hosts: dict):
        self._hosts = dict(hosts)

    def find_available_hosts_and_slots(self) -> dict:
        return dict(self._hosts)


class ScriptHostDiscovery(HostDiscovery):
    """Runs a user script printing ``hostname:slots`` per line (exact
    upstream contract for ``--host-discovery-script``)."""

    def __init__(self, script: str, timeout_s: float = 30.0):
        self._script = script
        self._timeout = timeout_s

    def find_available_hosts_and_slots(self) -> dict:
        out = subprocess.run(
            self._script, shell=True, capture_output=True, text=True,
            timeout=self._timeout, check=True).stdout
        hosts = {}
        for line in out.splitlines():
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                h, s = line.rsplit(":", 1)
                hosts[h] = int(s)
            else:
                hosts[line] = 1
        return hosts


class DeviceDiscovery:
    """Which devices are currently usable by this process.

    ``probe`` defaults to this process's visible CUDA devices, or to the
    CPU with ``device="cpu"`` (or, with ``device=None``, when the port was
    initialized on the CPU). Tests inject a fake to simulate the loss or
    the replacement of a device. Probing counts devices and creates no
    CUDA context.
    """

    def __init__(self, probe: Optional[Callable[[], Sequence]] = None,
                 device: Optional[str] = None):
        self._probe = probe
        self._device = device

    def _default_probe(self) -> List:
        import torch
        kind = self._device
        if kind is None:
            from horovod_tpu_torch import core
            kind = (core.device().type if core.is_initialized()
                    else "cuda")
        if kind == "cpu":
            return [torch.device("cpu")]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def find_available_devices(self) -> List:
        return list((self._probe or self._default_probe)())
