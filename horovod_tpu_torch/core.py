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

The controller (``collective.py``) runs its host rounds -- negotiation and
object collectives -- on a control group over the whole world. On a NCCL
world ``init`` makes it a gloo group, created on every rank before any
process set, so no control round goes through NCCL (upstream Horovod's
controller runs over MPI or Gloo beside its NCCL data plane). On a gloo
world the world group serves. ``init`` also resets the negotiation history
and the span ids, starts the timeline when ``HOROVOD_TIMELINE`` is set, runs
the clock-anchor barrier in a world larger than one, and starts the metrics
flusher and the stall watchdog (``metrics.on_init``); ``shutdown`` writes
the timeline and stops them.
"""

from __future__ import annotations

import datetime
import threading
import time
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch import config as _config

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "cross_rank", "cross_size", "device",
           "backend", "build_info", "init_epoch"]

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
    control: object         # the process group of the controller's rounds


_CTX: Optional[_Context] = None
# Number of inits in this process; stamped on timeline phases and anchors.
_INIT_EPOCH = 0


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
    global _CTX, _INIT_EPOCH
    with _LOCK:
        t0 = time.perf_counter()
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
        # Collective over the world: every rank makes it here, before any
        # process set's group.
        control = (dist.new_group(backend="gloo") if backend == "nccl"
                   else dist.group.WORLD)
        _CTX = _Context(device=dev, backend=backend, rank=dist.get_rank(),
                        size=dist.get_world_size(),
                        local_rank=cfg.local_rank,
                        local_size=cfg.local_size, owns_group=owns,
                        control=control)
        from horovod_tpu_torch import collective as _coll
        from horovod_tpu_torch import metrics as _metrics
        from horovod_tpu_torch import process_set as _ps
        from horovod_tpu_torch import timeline as _tl
        _coll._reset_negotiation()
        _ps._reset_for_init()
        _INIT_EPOCH += 1
        if cfg.timeline_path and _tl.get_timeline() is None:
            _tl.start_timeline(cfg.timeline_path)
        if _CTX.size > 1:
            t = _tl.get_timeline()
            if t is not None and t.rank is None:
                # Started before the world was up: move onto this rank's
                # shard (the events so far go to the base path).
                _tl.init_timeline(t.path)
            # Clock anchor: every rank leaves this barrier at nearly the
            # same instant. Unconditional, so that HOROVOD_TIMELINE set on
            # only some ranks cannot deadlock init.
            dist.barrier(group=control)
        _tl.emit_clock_anchor(epoch=_INIT_EPOCH)
        _metrics.on_init(cfg, init_seconds=time.perf_counter() - t0,
                         world=_CTX.size)


def shutdown() -> None:
    """Leave the job (``hvd.shutdown``); destroys the process group when
    ``init`` created it."""
    global _CTX
    with _LOCK:
        if _CTX is None:
            return
        from horovod_tpu_torch import collective as _coll
        from horovod_tpu_torch import metrics as _metrics
        from horovod_tpu_torch import process_set as _ps
        from horovod_tpu_torch import timeline as _tl
        # The trace is written before the groups go: it needs none of them.
        _tl.shutdown_timeline()
        _coll._reset_negotiation()
        _ps._reset_for_shutdown()
        if dist.is_initialized():
            if _CTX.owns_group:
                dist.destroy_process_group()
            elif _CTX.control is not dist.group.WORLD:
                dist.destroy_process_group(_CTX.control)
        _CTX = None
        # Stops the watchdog and the flusher (one last write); metric
        # values survive shutdown.
        _metrics.on_shutdown()


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


def control_group():
    """The process group of the controller's host rounds (gloo)."""
    return _ctx().control


def init_epoch() -> int:
    """How many times ``init`` has set up a world in this process."""
    return _INIT_EPOCH


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
