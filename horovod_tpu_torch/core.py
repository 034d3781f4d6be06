"""Runtime state: ``init`` / ``shutdown`` and the rank queries.

Port of ``horovod_tpu/core.py`` (``init`` and the size/rank functions) onto
``torch.distributed``. One process drives one device. ``init()`` selects
CUDA with the NCCL backend; without a GPU it raises instead of falling back.
``init(device="cpu")`` selects the CPU with gloo (tests, CPU runs).

The rendezvous comes from the environment (``config.py``): ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` as ``python -m horovod_tpu_torch.runner`` sets them. A
one-process world with no ``MASTER_*`` gets a private store on a free
localhost port, so a single script needs no launcher. Rank 0 serves the
rendezvous store for as long as its process lives, and each ``init`` forms
its world under a prefix of its own over it, so an elastic reset
(``shutdown()`` + ``init()`` on the same address) never meets the store
of the world before, nor the addresses that world left there.

The controller (``collective.py``) runs its host rounds -- negotiation and
object collectives -- on a control group over the whole world. On a NCCL
world ``init`` makes it a gloo group, created on every rank before any
process set, so no control round goes through NCCL (upstream Horovod's
controller runs over MPI or Gloo beside its NCCL data plane). On a gloo
world the world group serves. ``init`` also resets the negotiation history
and the span ids, starts the timeline when ``HOROVOD_TIMELINE`` is set, runs
the clock-anchor barrier in a world larger than one, and starts the metrics
flusher and the stall watchdog (``metrics.on_init``) and arms the flight
recorder under ``HOROVOD_BLACKBOX`` (``blackbox.on_init``); ``shutdown``
writes the timeline and stops them.

``init`` detects the world's topology (``parallel/mesh.py``:
``HOROVOD_TOPOLOGY``, else hosts x GPUs a host, else a ring; ``topology()``)
and, when it has two or more dims, makes the sub-group of every line of
the torus along each dim, on every rank in one order: the phases of the
``_2d`` allreduce lowerings (``overlap.py``). It also sets the reference's
``config_allreduce_algorithm``, ``config_allreduce_wire``,
``config_overlap_chunks`` and ``config_topology`` gauges.

``HOROVOD_MESH`` (``"dpXxmpY"``) factors the world into the named 2-D
``("dp", "mp")`` mesh (``parallel/mesh.py``): ``init`` checks it against
the world and the detected topology before it forms the group (a spec
that does not factor the world fails at ``init``), then builds
:func:`mesh2d` over the world, whose dp and mp process sets each rank
takes with ``mesh2d().process_set("dp")``, and sets the reference's
``config_mesh_dp`` / ``config_mesh_mp`` gauges. Unset, the mesh is dp =
world, mp = 1. Each ``init`` rebuilds it for its world.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch import config as _config

__all__ = ["init", "shutdown", "is_initialized", "rank", "size",
           "local_rank", "local_size", "cross_rank", "cross_size", "device",
           "backend", "build_info", "init_epoch", "topology",
           "topology_str", "mesh2d", "mesh_spec", "dp_size", "mp_size",
           "dp_rank", "mp_rank", "nccl_built", "gloo_built", "mpi_built",
           "cuda_built", "rocm_built", "mpi_enabled", "gloo_enabled",
           "mpi_threads_supported"]

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
    topology: tuple = ()    # detected dims, (world,) for a ring
    # This rank's line along each dim above 1: (group, extent), the
    # phases of the _2d lowerings; empty on a ring.
    phases: tuple = ()
    mesh_dims: tuple = (1, 1)   # (dp, mp)
    mesh2d: object = None       # parallel.mesh.Mesh over the world


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

# (MASTER_ADDR, MASTER_PORT) -> [the rendezvous store there, the number of
# worlds this process has formed over it] (see the module docstring).
_STORES: dict = {}


def _rendezvous(cfg):
    """The store of this init's world: the process's store at the
    configured address, under the prefix of its next world. The ranks of
    one address are launched together and re-form together, so they count
    its worlds alike."""
    entry = _STORES.get((cfg.master_addr, cfg.master_port))
    if entry is None:
        store = dist.TCPStore(cfg.master_addr, cfg.master_port,
                              is_master=cfg.rank == 0, timeout=_TIMEOUT,
                              wait_for_workers=False)
        entry = _STORES[(cfg.master_addr, cfg.master_port)] = [store, 0]
    entry[1] += 1
    return dist.PrefixStore(f"hvd/world{entry[1]}", entry[0])


def init(device: Union[str, torch.device, None] = None) -> None:
    """Join the job (``hvd.init()``).

    ``device`` None or ``"cuda"``: this process's GPU (``LOCAL_RANK``) and
    NCCL; ``"cpu"``: the CPU and gloo. Re-entrant: a second call with the
    same device is a no-op. After ``shutdown()`` it forms a new group (an
    elastic reset: ``init_epoch()`` + 1, an ``elastic_epoch`` marker and a
    fresh clock anchor in the timeline). A hot spare
    (``HVD_TPU_ELASTIC_SPARE=1``) must be promoted first.
    """
    global _CTX, _INIT_EPOCH
    if os.environ.get("HVD_TPU_ELASTIC_SPARE") == "1":
        # A spare that skipped the standby barrier would form a world of
        # its own and could publish manifests into the job's directory.
        raise RuntimeError(
            "this process was launched as an elastic hot spare "
            "(HVD_TPU_ELASTIC_SPARE=1) and has not been promoted: call "
            "hvd.elastic.standby_if_spare() before hvd.init(); promotion "
            "installs the rendezvous contract and clears the flag")
    # The launcher's failure stamp is consumed process-wide: only the
    # first restore after this (re)init may record the recovery time.
    from horovod_tpu_torch import checkpoint_sharded as _cks
    _cks.stash_failure_stamp()
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
        from horovod_tpu_torch.parallel import mesh as _mesh
        if cfg.mesh:
            # dp x mp factoring, checked against the world and its
            # topology before any group forms: a spec that does not factor
            # the world fails here, not at the first collective.
            _mesh.validate_mesh(*_mesh.parse_mesh(cfg.mesh), cfg.world_size,
                                _mesh.detect_topology(
                                    cfg.world_size, cfg.local_size,
                                    cfg.topology))
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
                    backend, store=_rendezvous(cfg), rank=cfg.rank,
                    world_size=cfg.world_size, timeout=_TIMEOUT)
            owns = True
        elif dist.get_world_size() != cfg.world_size:
            raise RuntimeError(
                f"torch.distributed is already initialized with world "
                f"{dist.get_world_size()}, but WORLD_SIZE={cfg.world_size}")
        # Collective over the world: every rank makes it here, before any
        # process set's group.
        control = (dist.new_group(backend="gloo") if backend == "nccl"
                   else dist.group.WORLD)
        world = dist.get_world_size()
        topo = _mesh.detect_topology(world, cfg.local_size, cfg.topology)
        dims = (_mesh.validate_mesh(*_mesh.parse_mesh(cfg.mesh), world, topo)
                if cfg.mesh else (world, 1))
        _CTX = _Context(device=dev, backend=backend, rank=dist.get_rank(),
                        size=world, local_rank=cfg.local_rank,
                        local_size=cfg.local_size, owns_group=owns,
                        control=control, topology=topo,
                        phases=_make_phases(topo, dist.get_rank()),
                        mesh_dims=dims)
        from horovod_tpu_torch import collective as _coll
        from horovod_tpu_torch import metrics as _metrics
        from horovod_tpu_torch import process_set as _ps
        from horovod_tpu_torch import timeline as _tl
        _coll._reset_negotiation()
        _ps._reset_for_init()
        # The mesh's process sets, on every rank in one order.
        _CTX = dataclasses.replace(_CTX, mesh2d=_mesh.make_mesh2d(
            *dims, devices=list(range(world))))
        _INIT_EPOCH += 1
        if _INIT_EPOCH > 1:
            # A re-init (elastic reset, re-mesh) runs every step's first
            # call again by design: not churn to blame on an argument. Each
            # collective's and lowering's first issue counts again, as the
            # reference's cleared caches compile again.
            from horovod_tpu_torch import profiler as _prof
            _prof.registry.reanchor()
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
        if _INIT_EPOCH > 1 and _tl.get_timeline() is not None:
            _tl.get_timeline().marker("elastic_epoch", category="trace",
                                      epoch=_INIT_EPOCH, world=_CTX.size)
        _set_config_gauges(cfg, topo)
        _metrics.on_init(cfg, init_seconds=time.perf_counter() - t0,
                         world=_CTX.size)
        # The flight recorder (HOROVOD_BLACKBOX): arm its rings, install
        # the fatal-signal / excepthook dump triggers and point the stdlib
        # faulthandler (HOROVOD_FAULTHANDLER=0 opts out) at its directory.
        from horovod_tpu_torch import blackbox as _blackbox
        _blackbox.on_init(cfg)


def _make_phases(topo: tuple, rank: int) -> tuple:
    """The sub-group of every line of the torus along each dim above 1,
    made on every rank in one order (``dist.new_group`` is collective over
    the world); returns this rank's line of each dim as (group, extent)."""
    from horovod_tpu_torch.overlap import torus_lines
    dims = tuple(d for d in topo if d > 1)
    if len(dims) < 2:
        return ()
    phases = []
    for lines in torus_lines(dims):
        for line in lines:
            g = dist.new_group(line)
            if rank in line:
                phases.append((g, len(line)))
    return tuple(phases)


def _set_config_gauges(cfg, topo: tuple) -> None:
    """The reference's config gauges: one algorithm and one wire label at
    1, the chunk count, and the topology's dims (unused slots 0)."""
    from horovod_tpu_torch import metrics as _metrics
    from horovod_tpu_torch.overlap import ALGORITHMS, WIRES
    for a in ALGORITHMS:
        _metrics.gauge("config_allreduce_algorithm", algorithm=a).set(
            1 if a == cfg.allreduce_algorithm else 0)
    for w in WIRES:
        _metrics.gauge("config_allreduce_wire", wire=w).set(
            1 if w == cfg.allreduce_wire else 0)
    _metrics.gauge("config_overlap_chunks").set(cfg.overlap_chunks)
    for i in range(max(len(topo), 4)):
        _metrics.gauge("config_topology", dim=str(i)).set(
            topo[i] if i < len(topo) else 0)
    dp, mp = _CTX.mesh_dims
    _metrics.gauge("config_mesh_dp").set(dp)
    _metrics.gauge("config_mesh_mp").set(mp)


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
        # Stops the recorder's feeds; its rings survive like metric values
        # do, so a dump_postmortem() after shutdown still publishes.
        from horovod_tpu_torch import blackbox as _blackbox
        _blackbox.on_shutdown()


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


def topology() -> tuple:
    """The world's dims: ``(2, 2)`` under ``HOROVOD_TOPOLOGY=2x2``,
    ``(hosts, gpus_per_host)`` on several hosts of several GPUs,
    ``(world,)`` on a ring."""
    return _ctx().topology


def topology_str() -> str:
    """:func:`topology` as an ``"XxY"`` spec string (``"8"`` for 1-D)."""
    return "x".join(str(d) for d in _ctx().topology)


def torus_phases() -> tuple:
    """This rank's (group, extent) along each dim of the topology above 1
    (the ``_2d`` lowerings' phases); empty on a ring."""
    return _ctx().phases


def mesh2d():
    """The named 2-D ``("dp", "mp")`` mesh over the world
    (``HOROVOD_MESH``; dp = world x mp = 1 when unset)."""
    return _ctx().mesh2d


def mesh_spec() -> str:
    """The active dp x mp factoring as a ``"dpXxmpY"`` spec string."""
    from horovod_tpu_torch.parallel.mesh import format_mesh
    return format_mesh(*_ctx().mesh_dims)


def dp_size() -> int:
    """Data-parallel degree of the mesh (the world when unset)."""
    return _ctx().mesh_dims[0]


def mp_size() -> int:
    """Model-parallel degree of the mesh (1 when unset)."""
    return _ctx().mesh_dims[1]


def dp_rank() -> int:
    """This rank's dp coordinate: ``rank // mp``."""
    c = _ctx()
    return c.rank // c.mesh_dims[1]


def mp_rank() -> int:
    """This rank's mp coordinate: ``rank % mp``."""
    c = _ctx()
    return c.rank % c.mesh_dims[1]


def init_epoch() -> int:
    """How many times ``init`` has set up a world in this process."""
    return _INIT_EPOCH


# Upstream Horovod's build and runtime flags, reporting this port's build
# (the PyTorch it runs on) and the backend ``init`` chose. The reference
# answers False to every one (no MPI, NCCL, Gloo, CUDA or ROCm on a TPU).

def nccl_built() -> bool:
    """Whether this PyTorch has NCCL (``init`` picks it on the GPU)."""
    return bool(dist.is_nccl_available())


def gloo_built() -> bool:
    """Whether this PyTorch has Gloo (the CPU backend and the controller's
    rounds)."""
    return bool(dist.is_gloo_available())


def mpi_built() -> bool:
    """Whether this PyTorch has MPI (``init`` never picks it)."""
    return bool(dist.is_mpi_available())


def cuda_built() -> bool:
    """Whether this PyTorch is built for CUDA."""
    return torch.version.cuda is not None


def rocm_built() -> bool:
    """Whether this PyTorch is built for ROCm."""
    return getattr(torch.version, "hip", None) is not None


def mpi_enabled() -> bool:
    """Whether ``init`` runs the world on MPI: never."""
    return _CTX is not None and _CTX.backend == "mpi"


def gloo_enabled() -> bool:
    """Whether ``init`` runs the world's collectives on Gloo (the CPU)."""
    return _CTX is not None and _CTX.backend == "gloo"


def mpi_threads_supported() -> bool:
    """Whether MPI runs with multi-threading: no MPI, so False."""
    return mpi_enabled()


def build_info() -> dict:
    """The build and runtime flags in one dict: ``nccl_built()``,
    ``gloo_built()``, the CUDA version, whether a card is there, whether
    the kernels are built, the backend ``init`` chose (None before it),
    the profiler's knobs (``profile_on_stall``, ``profile_dir``,
    ``profiler_cost``: None, True or False), and the config bus's
    ``config_epoch`` and ``config``: the resolved value of every knob of
    its registry by env name, the auth token as a boolean only."""
    from horovod_tpu_torch import confbus
    from horovod_tpu_torch.ops import _build
    cfg = _config.get_config()
    return {
        "nccl_built": nccl_built(),
        "gloo_built": gloo_built(),
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "kernels_built": _build.built(),
        "backend": _CTX.backend if _CTX is not None else None,
        "profile_on_stall": cfg.profile_on_stall,
        "profile_dir": cfg.profile_dir,
        "profiler_cost": cfg.profiler_cost,
        "config_epoch": confbus.epoch(),
        "config": confbus.resolved_values(),
    }
