"""The knobs this port reads, from the environment.

Port of the slice of ``horovod_tpu/config.py`` that the data-parallel path
and its controller use: the fusion threshold, hierarchical Adasum, the
timeline, the metrics flusher, the stall check and the rendezvous
contract. Each is read by :func:`get_config` (cached; :func:`refresh`
re-reads) and validated when read, so a bad value fails at ``init()`` and
not at the first collective.

* ``HOROVOD_FUSION_THRESHOLD`` -- bytes per fusion bucket (default 64 MB).
  Parsed as the reference parses it: ``int(value)`` when set and non-empty.
* ``HOROVOD_HIERARCHICAL_ALLREDUCE`` -- Adasum averages within each node
  before combining across nodes (``1``, ``true`` or ``yes``; as the
  reference reads it).
* ``HOROVOD_TIMELINE`` -- path of the Chrome trace that ``init()`` starts
  (one shard per rank when the world is larger than 1).
  ``HOROVOD_TIMELINE_MARK_CYCLES`` is not read: it changes nothing in the
  reference either, which has no controller cycle to mark.
* ``HOROVOD_METRICS_FILE`` / ``HOROVOD_METRICS_INTERVAL`` -- the metrics
  snapshot file (``.prom`` / ``.txt``: Prometheus text, else JSON) and its
  write period in seconds (default 10, at least 0.05);
  ``HOROVOD_METRICS_GRAD_NORM`` records the gradient-norm gauge.
* ``HOROVOD_STALL_CHECK_DISABLE`` / ``HOROVOD_STALL_CHECK_TIME_SECONDS``
  -- the stall watchdog that ``init()`` starts, and its threshold (60 s).
* ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_SIZE`` -- this
  process's place in the job (defaults 0 / 1 / ``RANK`` / ``WORLD_SIZE``),
  integers with ``0 <= rank < world_size`` and
  ``0 <= local_rank < local_size <= world_size``.
* ``MASTER_ADDR`` / ``MASTER_PORT`` -- the rendezvous store. Both or neither;
  a world of more than one process needs both.
* ``HOROVOD_ALLREDUCE_ALGORITHM`` -- the per-bucket allreduce lowering, one
  of ``overlap.ALGORITHMS`` (default ``auto``); ``HOROVOD_ALLREDUCE_WIRE``
  -- the default wire precision, one of ``overlap.WIRES`` (``fp32``;
  empty, ``none`` and ``off`` mean ``fp32``); ``HOROVOD_OVERLAP_CHUNKS`` --
  the pipeline depth of the ``chunked_*`` lowerings (default 4, at least
  1); ``HOROVOD_TOPOLOGY`` -- the torus dims the ``_2d`` lowerings run on
  (``"2x2"``; their product must equal the world, checked at ``init``);
  ``HOROVOD_MESH`` -- the dp x mp factoring of the world (``"dp2xmp2"``;
  grammar checked here, stored in its canonical form; ``init`` checks
  that it factors the world and nests with the topology; unset: dp =
  world, mp = 1); ``HOROVOD_MP_RULES`` -- the model-parallel rule set of
  ``parallel.mp.mp_partition_rules``, which ``mp.tensor_parallel``
  applies: ``auto`` (default, the model family's split), ``megatron``
  (the explicit column / row split) or ``off`` (no weight is split: under
  mp > 1 ``tensor_parallel`` leaves the model whole on every rank and
  ``mp.vocab_parallel_loss`` is ``loss_fn``; a debugging escape hatch).
  The reference's ``HOROVOD_XLA_LATENCY_HIDING`` sets XLA compiler flags
  and has no counterpart here.
* ``HOROVOD_AUTOTUNE`` -- the online tuner of ``DistributedOptimizer``
  (``autotune.py``); ``HOROVOD_AUTOTUNE_MODE`` ``ladder`` (default),
  ``bayes`` or ``bayes-compression``; ``HOROVOD_AUTOTUNE_LOG`` -- the file
  rank 0 appends the converged point to; ``HOROVOD_AUTOTUNE_PROBES`` /
  ``HOROVOD_AUTOTUNE_SAMPLES`` -- the Bayesian budget (6 probes of 10
  steps).
* ``HOROVOD_FAULT_PLAN`` -- the fault-injection schedule of ``faults.py``,
  parsed here so a typo'd plan fails at ``init()``;
  ``HOROVOD_ELASTIC_TIMEOUT`` -- seconds (600) of the elastic rendezvous;
  ``HOROVOD_PREEMPTION_NOTICE`` -- seconds (30, at least 0) of notice a
  preempted host gets, the budget a checkpoint cadence is judged against.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

__all__ = ["Config", "get_config", "refresh"]

_MB = 1024 * 1024


def _env_bytes(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


@dataclass(frozen=True)
class Config:
    fusion_threshold_bytes: int = 64 * _MB
    hierarchical_allreduce: bool = False
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_size: int = 1
    master_addr: Optional[str] = None
    master_port: Optional[int] = None
    timeline_path: Optional[str] = None
    metrics_file: Optional[str] = None
    metrics_interval_seconds: float = 10.0
    metrics_grad_norm: bool = False
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    allreduce_algorithm: str = "auto"
    allreduce_wire: str = "fp32"
    overlap_chunks: int = 4
    topology: Optional[str] = None
    mesh: Optional[str] = None
    mp_rules: str = "auto"
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_mode: str = "ladder"
    autotune_probes: int = 6
    autotune_samples: int = 10
    elastic_timeout_seconds: float = 600.0
    preemption_notice_seconds: float = 30.0
    fault_plan: str = ""


def _env_algorithm() -> str:
    from horovod_tpu_torch.overlap import ALGORITHMS
    v = (os.environ.get("HOROVOD_ALLREDUCE_ALGORITHM", "auto")
         .strip().lower() or "auto")
    if v not in ALGORITHMS:
        raise ValueError(
            f"HOROVOD_ALLREDUCE_ALGORITHM={v!r}: expected one of "
            f"{ALGORITHMS}")
    return v


def _env_wire() -> str:
    from horovod_tpu_torch.overlap import WIRES
    v = os.environ.get("HOROVOD_ALLREDUCE_WIRE", "").strip().lower()
    if v in ("", "none", "off"):
        return "fp32"
    if v not in WIRES:
        raise ValueError(
            f"HOROVOD_ALLREDUCE_WIRE={v!r}: expected one of {WIRES}")
    return v


def _env_topology() -> Optional[str]:
    v = os.environ.get("HOROVOD_TOPOLOGY", "").strip().lower()
    if not v:
        return None
    from horovod_tpu_torch.parallel.mesh import parse_topology
    dims = parse_topology(v)   # grammar check: a typo'd spec fails here
    return "x".join(str(d) for d in dims)


def _env_mesh() -> Optional[str]:
    v = os.environ.get("HOROVOD_MESH", "").strip().lower()
    if not v:
        return None
    from horovod_tpu_torch.parallel.mesh import format_mesh, parse_mesh
    dp, mp = parse_mesh(v)   # grammar check: a typo'd spec fails here
    return format_mesh(dp, mp)


_MP_RULE_SETS = ("auto", "megatron", "off")


def _env_mp_rules() -> str:
    v = (os.environ.get("HOROVOD_MP_RULES", "auto").strip().lower()
         or "auto")
    if v not in _MP_RULE_SETS:
        raise ValueError(
            f"HOROVOD_MP_RULES={v!r}: expected one of {_MP_RULE_SETS}")
    return v


def _env_chunks() -> int:
    v = os.environ.get("HOROVOD_OVERLAP_CHUNKS")
    if not v:
        from horovod_tpu_torch.overlap import DEFAULT_CHUNKS
        return DEFAULT_CHUNKS
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"HOROVOD_OVERLAP_CHUNKS={v!r}: expected a positive integer")
    if n < 1:
        raise ValueError(
            f"HOROVOD_OVERLAP_CHUNKS={n}: chunk count must be >= 1")
    return n


def _env_fault_plan() -> str:
    v = os.environ.get("HOROVOD_FAULT_PLAN", "").strip()
    if v:
        from horovod_tpu_torch.faults import parse_plan
        parse_plan(v)   # grammar check: a bad plan fails here, at init
    return v


def _read() -> Config:
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    if world < 1:
        raise ValueError(f"WORLD_SIZE={world} must be >= 1")
    if not 0 <= rank < world:
        raise ValueError(f"RANK={rank} is outside [0, WORLD_SIZE={world})")
    local_size = _env_int("LOCAL_SIZE", world)
    local_rank = _env_int("LOCAL_RANK", rank % local_size
                          if local_size > 0 else 0)
    if not 1 <= local_size <= world:
        raise ValueError(f"LOCAL_SIZE={local_size} is outside "
                         f"[1, WORLD_SIZE={world}]")
    if not 0 <= local_rank < local_size:
        raise ValueError(f"LOCAL_RANK={local_rank} is outside "
                         f"[0, LOCAL_SIZE={local_size})")
    addr = os.environ.get("MASTER_ADDR") or None
    port_s = os.environ.get("MASTER_PORT") or None
    if (addr is None) != (port_s is None):
        raise ValueError("MASTER_ADDR and MASTER_PORT must be set together")
    port = None
    if port_s is not None:
        port = _env_int("MASTER_PORT", 0)
        if not 0 < port < 65536:
            raise ValueError(f"MASTER_PORT={port} is not a TCP port")
    if world > 1 and addr is None:
        raise ValueError(f"WORLD_SIZE={world} needs MASTER_ADDR and "
                         "MASTER_PORT (the launcher sets them)")
    return Config(
        fusion_threshold_bytes=_env_bytes("HOROVOD_FUSION_THRESHOLD",
                                          64 * _MB),
        hierarchical_allreduce=os.environ.get(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", "").lower() in ("1", "true",
                                                              "yes"),
        rank=rank, world_size=world, local_rank=local_rank,
        local_size=local_size, master_addr=addr, master_port=port,
        timeline_path=os.environ.get("HOROVOD_TIMELINE") or None,
        metrics_file=os.environ.get("HOROVOD_METRICS_FILE") or None,
        metrics_interval_seconds=max(
            0.05, _env_float("HOROVOD_METRICS_INTERVAL", 10.0)),
        metrics_grad_norm=_env_bool("HOROVOD_METRICS_GRAD_NORM"),
        stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
        stall_check_time_seconds=_env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0),
        allreduce_algorithm=_env_algorithm(),
        allreduce_wire=_env_wire(),
        overlap_chunks=_env_chunks(),
        topology=_env_topology(),
        mesh=_env_mesh(),
        mp_rules=_env_mp_rules(),
        autotune=_env_bool("HOROVOD_AUTOTUNE"),
        autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG") or None,
        autotune_mode=(os.environ.get("HOROVOD_AUTOTUNE_MODE", "ladder")
                       .strip().lower() or "ladder"),
        autotune_probes=int(_env_float("HOROVOD_AUTOTUNE_PROBES", 6)),
        autotune_samples=int(_env_float("HOROVOD_AUTOTUNE_SAMPLES", 10)),
        elastic_timeout_seconds=_env_float("HOROVOD_ELASTIC_TIMEOUT", 600.0),
        preemption_notice_seconds=max(
            0.0, _env_float("HOROVOD_PREEMPTION_NOTICE", 30.0)),
        fault_plan=_env_fault_plan())


_CONFIG: Optional[Config] = None


def get_config() -> Config:
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = _read()
    return _CONFIG


def refresh() -> Config:
    """Re-read the environment (``init()`` does, like upstream's
    ``horovod_init``)."""
    global _CONFIG
    _CONFIG = _read()
    return _CONFIG
