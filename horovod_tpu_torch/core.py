"""Runtime state: ``init`` / ``shutdown`` and the rank queries.

Port of ``horovod_tpu/core.py`` (``init`` and the size/rank functions) onto
``torch.distributed``. One process drives one device. ``init()`` selects
CUDA with the NCCL backend; without a GPU it raises instead of falling back.
``init(device="cpu")`` selects the CPU with gloo (tests, CPU runs).

The rendezvous comes from the environment (``config.py``): ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` as ``python -m horovod_tpu_torch.runner`` sets them. A
one-process world with no ``MASTER_*`` gets a private store on a free
localhost port, so a single script needs no launcher.
"""

from __future__ import annotations

import datetime
import threading
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch import config as _config

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "cross_rank", "cross_size", "device",
           "backend", "build_info"]

_LOCK = threading.Lock()


@dataclass(frozen=True)
class _Context:
    device: torch.device
    backend: str
    rank: int
    size: int
    local_rank: int
    local_size: int
    owns_group: bool


_CTX: Optional[_Context] = None


def _resolve_device(device, local_rank: int) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"init(device={device!r}): expected 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "horovod_tpu_torch.init(): no CUDA device is available. The "
            "port runs on the GPU unless asked otherwise; pass "
            "device='cpu' to run on the CPU with gloo.")
    index = local_rank if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no GPU: "
                           f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


# How long a rank waits for the others at rendezvous and in a collective.
_TIMEOUT = datetime.timedelta(seconds=300)


def init(device: Union[str, torch.device, None] = None) -> None:
    """Join the job (``hvd.init()``).

    ``device`` None or ``"cuda"``: this process's GPU (``LOCAL_RANK``) and
    NCCL; ``"cpu"``: the CPU and gloo. Re-entrant: a second call with the
    same device is a no-op.
    """
    global _CTX
    with _LOCK:
        cfg = _config.refresh()
        dev = _resolve_device(device, cfg.local_rank)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if _CTX is not None:
            if _CTX.device != dev:
                raise RuntimeError(f"already initialized on {_CTX.device}; "
                                   f"call shutdown() before init on {dev}")
            return
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        owns = False
        if not dist.is_initialized():
            if cfg.master_addr is None:
                # One-process world: a private store on a free local port.
                store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                      timeout=_TIMEOUT)
                dist.init_process_group(backend, store=store, rank=0,
                                        world_size=1, timeout=_TIMEOUT)
            else:
                dist.init_process_group(
                    backend,
                    init_method=f"tcp://{cfg.master_addr}:{cfg.master_port}",
                    rank=cfg.rank, world_size=cfg.world_size,
                    timeout=_TIMEOUT)
            owns = True
        elif dist.get_world_size() != cfg.world_size:
            raise RuntimeError(
                f"torch.distributed is already initialized with world "
                f"{dist.get_world_size()}, but WORLD_SIZE={cfg.world_size}")
        _CTX = _Context(device=dev, backend=backend, rank=dist.get_rank(),
                        size=dist.get_world_size(),
                        local_rank=cfg.local_rank,
                        local_size=cfg.local_size, owns_group=owns)
        from horovod_tpu_torch import process_set as _ps
        _ps._reset_for_init()


def shutdown() -> None:
    """Leave the job (``hvd.shutdown``); destroys the process group when
    ``init`` created it."""
    global _CTX
    with _LOCK:
        if _CTX is None:
            return
        from horovod_tpu_torch import process_set as _ps
        _ps._reset_for_shutdown()
        if _CTX.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _CTX = None


def is_initialized() -> bool:
    return _CTX is not None


def _ctx() -> _Context:
    if _CTX is None:
        raise RuntimeError("horovod_tpu_torch is not initialized: call "
                           "hvd.init() first")
    return _CTX


def rank() -> int:
    return _ctx().rank


def size() -> int:
    return _ctx().size


def local_rank() -> int:
    return _ctx().local_rank


def local_size() -> int:
    return _ctx().local_size


def cross_rank() -> int:
    """Index of this process's host (ranks are packed host by host)."""
    c = _ctx()
    return c.rank // c.local_size


def cross_size() -> int:
    """Number of hosts."""
    c = _ctx()
    return -(-c.size // c.local_size)


def device() -> torch.device:
    """The device this process drives."""
    return _ctx().device


def backend() -> str:
    return _ctx().backend


def build_info() -> dict:
    """Capability flags (``hvd.nccl_built()`` and friends)."""
    from horovod_tpu_torch.ops import _build
    return {
        "nccl_built": bool(dist.is_nccl_available()),
        "gloo_built": bool(dist.is_gloo_available()),
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "kernels_built": _build.built(),
        "backend": _CTX.backend if _CTX is not None else None,
    }
