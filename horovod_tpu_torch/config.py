"""The knobs this port reads, from the environment.

Port of ``horovod_tpu/config.py``: every field of the reference's
``Config``, with the reference's default and the reference's parser, plus
the rendezvous fields the port reads itself. Each is read by
:func:`get_config` (cached; :func:`refresh` re-reads) and validated when
read, so a bad value fails at ``init()`` and not at the first collective.
A :func:`refresh` after the first read routes every changed value through
the config bus (``confbus.note_refresh``: a WARN line, an epoch, a ledger
line, a ``CONFIG`` timeline marker and a flight-recorder record each), and
sets the ``horovod_tpu_torch`` logger's level from ``HOROVOD_LOG_LEVEL``.

* ``HOROVOD_FUSION_THRESHOLD`` -- bytes per fusion bucket (default 64 MB).
  Parsed as the reference parses it: ``int(value)`` when set and non-empty.
* ``HOROVOD_HIERARCHICAL_ALLREDUCE`` -- Adasum averages within each node
  before combining across nodes (``1``, ``true`` or ``yes``; as the
  reference reads it). The config bus registers it as the reference does,
  as a knob read at the call site, outside its audit.
* ``HOROVOD_TIMELINE`` -- path of the Chrome trace that ``init()`` starts
  (one shard per rank when the world is larger than 1).
  ``HOROVOD_TIMELINE_MARK_CYCLES`` is read and recorded and changes
  nothing: the reference has no controller cycle to mark either.
* ``HOROVOD_METRICS_FILE`` / ``HOROVOD_METRICS_INTERVAL`` -- the metrics
  snapshot file (``.prom`` / ``.txt``: Prometheus text, else JSON) and its
  write period in seconds (default 10, at least 0.05);
  ``HOROVOD_METRICS_GRAD_NORM`` records the gradient-norm gauge.
* ``HOROVOD_STALL_CHECK_DISABLE`` / ``HOROVOD_STALL_CHECK_TIME_SECONDS``
  -- the stall watchdog that ``init()`` starts, and its threshold (60 s;
  ``set_config`` retargets the running watchdog).
* ``HOROVOD_LOG_LEVEL`` -- ``trace``, ``debug``, ``info``, ``warning``
  (default), ``error`` or ``fatal``: the level of the
  ``horovod_tpu_torch`` logger (an unknown word reads as ``warning``).
* ``HOROVOD_PROFILE_ON_STALL`` -- a stall (and, once serving is ported, a
  deadline breach) fires one bounded ``torch.profiler`` capture
  (``profiler.maybe_trigger``); ``HOROVOD_PROFILE_DIR`` -- where captures
  land (default ``/tmp/horovod_profile``); ``HOROVOD_PROFILE_SECONDS`` --
  the length of a triggered capture (5, at least 0.1);
  ``HOROVOD_PROFILE_MAX_CAPTURES`` -- triggered captures a process (2, a
  positive integer); ``HOROVOD_PROFILER_COST`` -- the cost capture of
  ``profiler.instrument``: unset lets each call site choose (instrumented
  steps on), ``1`` / ``0`` force it on or off everywhere.
* ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_SIZE`` -- this
  process's place in the job (defaults 0 / 1 / ``RANK`` / ``WORLD_SIZE``),
  integers with ``0 <= rank < world_size`` and
  ``0 <= local_rank < local_size <= world_size``.
* ``MASTER_ADDR`` / ``MASTER_PORT`` -- the rendezvous store. Both or neither;
  a world of more than one process needs both. These and the four above
  change on every elastic re-form, so the config bus leaves them out of
  its audit (the reference's ``Config`` has no such fields).
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
* ``HOROVOD_XLA_LATENCY_HIDING`` and ``HOROVOD_TRACE_JAX_PROFILER`` are
  read as the reference reads them and change nothing here: the first sets
  XLA compiler flags, the second wraps collectives in JAX profiler
  annotations, and neither compiler nor profiler is in this port (the
  port's collectives carry their op ids in the timeline and in
  ``torch.profiler`` records already).
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
  preempted host gets, the budget a checkpoint cadence is judged against;
  ``HOROVOD_BARRIER_TIMEOUT`` -- the reference's subset-barrier wait (600,
  at least 1), read and recorded: the port's ``barrier`` waits on its
  process group's own timeout.
* ``HOROVOD_SERVE_AUTH_TOKEN`` -- the shared secret that gates
  ``POST /config`` on the scrape endpoint (``metrics.metrics_http``): at
  least 8 characters, refused otherwise, and never echoed (not in an
  error, not in the config's ``repr``, not in a postmortem bundle's
  ``config.json``, not in the config bus's ledger or views). The
  reference's transport hello reads it too (ROADMAP.md section A item 10).
* ``HOROVOD_SERVE_*`` (slots, lengths, KV pool, prefix cache, speculative
  decode, transport, breakers, hedging, the fleet supervisor),
  ``HOROVOD_REQUEST_TRACE*`` and ``HOROVOD_METRICS_PORT`` -- the serving
  plane's knobs, read and validated as the reference reads them. Their
  consumers are the serving modules (ROADMAP.md section A item 10); until
  those come the config bus holds them (the mutable ones apply, the
  shape-affecting ones are refused) and nothing else reads them.
* ``HOROVOD_HEALTH_*``, ``HOROVOD_FLEET_SCRAPE_INTERVAL`` and
  ``HOROVOD_SLO_*`` -- the continuous health plane's tick, window,
  hysteresis, scrape period and declared SLOs (``HOROVOD_HEALTH_ALERTS_FILE``
  is also the alerts log whose rotation-aware tail a bundle carries). The
  plane itself is ROADMAP.md section A item 9c-ii-b.
* ``HOROVOD_CONFIG_LEDGER`` -- the config bus's JSONL audit ledger (unset:
  the in-memory ring only); ``HOROVOD_CONFIG_EXPERIMENT_WINDOW`` -- the
  seconds (10, > 0) a mutation's measured-effect window observes its
  target metric; ``HOROVOD_CONFIG_REVERT_ON_REGRESSION=1`` -- revert a
  mutation whose window comes back ``regressed`` (``confbus.py``).
* ``HOROVOD_BLACKBOX`` -- arms the flight recorder (``blackbox.py``):
  bounded rings of the last ``HOROVOD_BLACKBOX_SECONDS`` (120, > 0) of
  timeline events, registry snapshots, alerts and fault injections.
  Bundles publish into ``HOROVOD_BLACKBOX_DIR`` (default
  ``<tmpdir>/horovod_blackbox``) as ``postmortem-<label>-<ts>/``
  directories, at most ``HOROVOD_BLACKBOX_MAX_BUNDLES`` (8) kept, oldest
  evicted first. ``HOROVOD_BLACKBOX_DUMP_ON`` picks the automatic
  triggers that publish (a comma list of ``signal``, ``stall``,
  ``alert``, ``engine``, ``fault``; ``none`` or ``off`` leaves only
  explicit ``dump_postmortem()``); an unknown trigger raises.
  ``HOROVOD_FAULTHANDLER=0`` keeps ``init()`` from pointing the stdlib
  ``faulthandler`` at the blackbox directory.
* The upstream variables in :data:`_INERT_VARS` are accepted and recorded
  in ``Config.inert`` with the reason each changes nothing here.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
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


def _env_posint(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a positive integer")
    if n < 1:
        raise ValueError(f"{name}={n}: must be >= 1")
    return n


def _env_posfloat(name: str, default: float) -> float:
    x = _env_float(name, default)
    if x <= 0:
        raise ValueError(f"{name}={x:g}: must be > 0")
    return x


def _env_nonneg_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a non-negative integer")
    if n < 0:
        raise ValueError(f"{name}={n}: must be >= 0")
    return n


def _env_nonneg_float(name: str, default: float) -> float:
    x = _env_float(name, default)
    if x < 0:
        raise ValueError(f"{name}={x:g}: must be >= 0")
    return x


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v.strip() == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r} is not an integer") from None


@dataclass
class Config:
    # The port's own: the rendezvous contract and hierarchical Adasum. Not
    # in the reference's Config, so outside the config bus's audit.
    hierarchical_allreduce: bool = False
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    local_size: int = 1
    master_addr: Optional[str] = None
    master_port: Optional[int] = None
    # The reference's fields, in its order.
    fusion_threshold_bytes: int = 64 * _MB
    allreduce_algorithm: str = "auto"
    allreduce_wire: str = "fp32"
    overlap_chunks: int = 4
    xla_latency_hiding: bool = False      # read and recorded; no effect
    topology: Optional[str] = None
    mesh: Optional[str] = None
    mp_rules: str = "auto"
    timeline_path: Optional[str] = None
    timeline_mark_cycles: bool = False    # read and recorded; no effect
    trace_jax_profiler: bool = False      # read and recorded; no effect
    autotune: bool = False
    autotune_log: Optional[str] = None
    autotune_mode: str = "ladder"
    autotune_probes: int = 6
    autotune_samples: int = 10
    metrics_file: Optional[str] = None
    metrics_interval_seconds: float = 10.0
    metrics_grad_norm: bool = False
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    profile_on_stall: bool = False
    profile_dir: str = "/tmp/horovod_profile"
    profile_seconds: float = 5.0
    profile_max_captures: int = 2
    # Tri-state: None (unset) lets each call site pick its default.
    profiler_cost: Optional[bool] = None
    serve_slots: int = 8
    serve_max_len: int = 512
    serve_block_size: int = 16
    serve_queue_limit: int = 128
    serve_prefill_chunk: int = 8
    serve_kv_quant: str = ""
    serve_prefix_cache: bool = False
    serve_spec_k: int = 0
    serve_spec_proposer: str = "ngram"
    serve_heartbeat_seconds: float = 2.0
    serve_rpc_timeout_seconds: float = 5.0
    serve_role: str = "both"
    serve_kv_wire: str = ""
    serve_affinity: str = "auto"
    serve_transport: str = "stream"
    serve_auth_token: str = field(default="", repr=False)
    serve_max_retries: int = 3
    serve_hedge_ms: float = 0.0
    serve_breaker_failures: int = 3
    serve_breaker_reset_seconds: float = 1.0
    serve_fleet_restart_budget: int = 5
    serve_fleet_backoff_seconds: float = 0.5
    serve_fleet_backoff_cap_seconds: float = 10.0
    serve_fleet_crash_loop_k: int = 3
    serve_fleet_crash_loop_window_seconds: float = 30.0
    serve_fleet_probe_seconds: float = 0.5
    serve_fleet_spares: int = 0
    serve_fleet_prefill: int = 0
    serve_fleet_prefill_spares: int = 0
    request_trace: bool = False
    request_trace_dir: Optional[str] = None
    request_trace_decode_every: int = 16
    # 0 = off; "auto" is stored as -1 (an ephemeral bind).
    metrics_port: int = 0
    health_interval_seconds: float = 2.0
    health_window_seconds: float = 30.0
    health_fire_n: int = 2
    health_clear_m: int = 2
    health_alerts_file: Optional[str] = None
    fleet_scrape_interval_seconds: float = 1.0
    slo_ttft_p99_ms: float = 0.0
    slo_error_rate: float = 0.0
    slo_burn_threshold: float = 2.0
    blackbox: bool = False
    blackbox_seconds: float = 120.0
    blackbox_dir: Optional[str] = None
    blackbox_max_bundles: int = 8
    blackbox_dump_on: str = "signal,stall,alert,engine,fault"
    faulthandler_enable: bool = True
    elastic_timeout_seconds: float = 600.0
    preemption_notice_seconds: float = 30.0
    fault_plan: str = ""
    barrier_timeout_seconds: float = 600.0   # read and recorded; no effect
    config_ledger_file: Optional[str] = None
    config_experiment_window_seconds: float = 10.0
    config_revert_on_regression: bool = False
    log_level: str = "warning"
    # Accepted-but-inert upstream variables that are set, with the reason.
    inert: dict = field(default_factory=dict)


# Upstream variables whose mechanism the port has no use for; accepted so
# launch scripts run unchanged, recorded in Config.inert. The names are the
# reference's; each reason is the port's own.
_INERT_VARS = {
    "HOROVOD_CYCLE_TIME": "no controller cycle: each collective negotiates "
                          "when it is called",
    "HOROVOD_CACHE_CAPACITY": "the negotiation response cache is unbounded "
                              "host-side",
    "HOROVOD_BATCH_D2D_MEMCOPIES": "fusion packs a bucket with one "
                                   "torch.cat; there is no batched copy "
                                   "to switch",
    "HOROVOD_NUM_NCCL_STREAMS": "collectives run on the stream "
                                "torch.distributed gives each process "
                                "group",
    "HOROVOD_MPI_THREADS_DISABLE": "no MPI backend: NCCL on the GPU, gloo "
                                   "on the CPU",
    "HOROVOD_GLOO_TIMEOUT_SECONDS": "rendezvous rides torch.distributed's "
                                    "TCPStore, whose timeout is fixed",
}


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


_DUMP_ON_TOKENS = ("signal", "stall", "alert", "engine", "fault")


def _env_dump_on() -> str:
    v = os.environ.get("HOROVOD_BLACKBOX_DUMP_ON")
    if v is None or not v.strip():
        return ",".join(_DUMP_ON_TOKENS)
    if v.strip().lower() in ("none", "off"):
        return ""
    toks = [t.strip().lower() for t in v.split(",") if t.strip()]
    bad = sorted(set(toks) - set(_DUMP_ON_TOKENS))
    if bad:
        raise ValueError(
            f"HOROVOD_BLACKBOX_DUMP_ON: unknown trigger(s) {bad}; "
            f"choose from {', '.join(_DUMP_ON_TOKENS)} (or 'none')")
    return ",".join(dict.fromkeys(toks))


def _env_auth_token() -> str:
    # Shared secret of POST /config (and of the reference's transport
    # hello). Validated for plausibility here but NEVER echoed: error
    # messages and the config's repr must not leak the value.
    v = os.environ.get("HOROVOD_SERVE_AUTH_TOKEN", "").strip()
    if v and len(v) < 8:
        raise ValueError("HOROVOD_SERVE_AUTH_TOKEN: token too short "
                         "(need >= 8 characters; value not shown)")
    return v


def _env_kv_quant() -> str:
    v = os.environ.get("HOROVOD_SERVE_KV_QUANT", "").strip().lower()
    if v in ("", "none", "off", "0"):
        return ""
    if v not in ("int8", "fp8"):
        raise ValueError(f"HOROVOD_SERVE_KV_QUANT={v!r}: expected "
                         f"'int8', 'fp8', or unset")
    return v


_SPEC_PROPOSERS = ("ngram",)


def _env_spec_proposer() -> str:
    v = (os.environ.get("HOROVOD_SERVE_SPEC_PROPOSER", "ngram")
         .strip().lower() or "ngram")
    if v not in _SPEC_PROPOSERS:
        raise ValueError(f"HOROVOD_SERVE_SPEC_PROPOSER={v!r}: expected "
                         f"one of {_SPEC_PROPOSERS}")
    return v


_SERVE_ROLES = ("prefill", "decode", "both")

#: migration wire formats -- "" follows the pool storage dtype.
_KV_WIRE_FORMATS = ("", "fp32", "bf16", "int8", "fp8")


def _env_serve_role() -> str:
    v = (os.environ.get("HOROVOD_SERVE_ROLE", "both").strip().lower()
         or "both")
    if v not in _SERVE_ROLES:
        raise ValueError(f"HOROVOD_SERVE_ROLE={v!r}: expected one of "
                         f"{_SERVE_ROLES}")
    return v


def _env_kv_wire() -> str:
    v = os.environ.get("HOROVOD_SERVE_KV_WIRE", "").strip().lower()
    if v in ("", "none", "off", "0"):
        return ""
    if v not in _KV_WIRE_FORMATS:
        raise ValueError(f"HOROVOD_SERVE_KV_WIRE={v!r}: expected one of "
                         f"'fp32', 'bf16', 'int8', 'fp8', or unset "
                         f"(follow the KV pool's storage dtype)")
    return v


def _env_serve_affinity() -> str:
    v = (os.environ.get("HOROVOD_SERVE_AFFINITY", "auto").strip().lower()
         or "auto")
    if v in ("1", "true", "yes"):
        v = "on"
    elif v in ("0", "false", "no"):
        v = "off"
    if v not in ("auto", "on", "off"):
        raise ValueError(f"HOROVOD_SERVE_AFFINITY={v!r}: expected "
                         f"'auto', 'on', or 'off'")
    return v


def _env_serve_transport() -> str:
    v = (os.environ.get("HOROVOD_SERVE_TRANSPORT", "stream")
         .strip().lower() or "stream")
    if v not in ("stream", "legacy"):
        raise ValueError(f"HOROVOD_SERVE_TRANSPORT={v!r}: expected "
                         f"'stream' (persistent multiplexed v2 wire) or "
                         f"'legacy' (one-shot JSON RPC)")
    return v


def _env_metrics_port() -> int:
    v = os.environ.get("HOROVOD_METRICS_PORT", "").strip().lower()
    if not v:
        return 0
    if v == "auto":
        return -1          # ephemeral bind
    try:
        n = int(v)
    except ValueError:
        raise ValueError(f"HOROVOD_METRICS_PORT={v!r}: expected a port "
                         f"number, 'auto', or unset")
    if n < 0:
        raise ValueError(f"HOROVOD_METRICS_PORT={n}: must be >= 0 "
                         f"(or 'auto')")
    return n


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
        hierarchical_allreduce=os.environ.get(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", "").lower() in ("1", "true",
                                                              "yes"),
        rank=rank, world_size=world, local_rank=local_rank,
        local_size=local_size, master_addr=addr, master_port=port,
        fusion_threshold_bytes=_env_bytes("HOROVOD_FUSION_THRESHOLD",
                                          64 * _MB),
        allreduce_algorithm=_env_algorithm(),
        allreduce_wire=_env_wire(),
        overlap_chunks=_env_chunks(),
        xla_latency_hiding=_env_bool("HOROVOD_XLA_LATENCY_HIDING"),
        topology=_env_topology(),
        mesh=_env_mesh(),
        mp_rules=_env_mp_rules(),
        timeline_path=os.environ.get("HOROVOD_TIMELINE") or None,
        timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
        trace_jax_profiler=_env_bool("HOROVOD_TRACE_JAX_PROFILER"),
        autotune=_env_bool("HOROVOD_AUTOTUNE"),
        autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG") or None,
        autotune_mode=(os.environ.get("HOROVOD_AUTOTUNE_MODE", "ladder")
                       .strip().lower() or "ladder"),
        autotune_probes=int(_env_float("HOROVOD_AUTOTUNE_PROBES", 6)),
        autotune_samples=int(_env_float("HOROVOD_AUTOTUNE_SAMPLES", 10)),
        metrics_file=os.environ.get("HOROVOD_METRICS_FILE") or None,
        metrics_interval_seconds=max(
            0.05, _env_float("HOROVOD_METRICS_INTERVAL", 10.0)),
        metrics_grad_norm=_env_bool("HOROVOD_METRICS_GRAD_NORM"),
        stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
        stall_check_time_seconds=_env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0),
        profile_on_stall=_env_bool("HOROVOD_PROFILE_ON_STALL"),
        profile_dir=(os.environ.get("HOROVOD_PROFILE_DIR")
                     or "/tmp/horovod_profile"),
        profile_seconds=max(
            0.1, _env_float("HOROVOD_PROFILE_SECONDS", 5.0)),
        profile_max_captures=_env_posint(
            "HOROVOD_PROFILE_MAX_CAPTURES", 2),
        profiler_cost=(None if os.environ.get("HOROVOD_PROFILER_COST",
                                              "").strip() == ""
                       else _env_bool("HOROVOD_PROFILER_COST")),
        serve_slots=_env_posint("HOROVOD_SERVE_SLOTS", 8),
        serve_max_len=_env_posint("HOROVOD_SERVE_MAX_LEN", 512),
        serve_block_size=_env_posint("HOROVOD_SERVE_BLOCK_SIZE", 16),
        serve_queue_limit=_env_posint("HOROVOD_SERVE_QUEUE_LIMIT", 128),
        serve_prefill_chunk=_env_posint("HOROVOD_SERVE_PREFILL_CHUNK", 8),
        serve_kv_quant=_env_kv_quant(),
        serve_prefix_cache=_env_bool("HOROVOD_SERVE_PREFIX_CACHE"),
        serve_spec_k=_env_nonneg_int("HOROVOD_SERVE_SPEC_K", 0),
        serve_spec_proposer=_env_spec_proposer(),
        serve_heartbeat_seconds=max(
            0.1, _env_float("HOROVOD_SERVE_HEARTBEAT", 2.0)),
        serve_rpc_timeout_seconds=_env_posfloat(
            "HOROVOD_SERVE_RPC_TIMEOUT", 5.0),
        serve_role=_env_serve_role(),
        serve_kv_wire=_env_kv_wire(),
        serve_affinity=_env_serve_affinity(),
        serve_transport=_env_serve_transport(),
        serve_auth_token=_env_auth_token(),
        serve_max_retries=_env_nonneg_int(
            "HOROVOD_SERVE_MAX_RETRIES", 3),
        serve_hedge_ms=_env_nonneg_float("HOROVOD_SERVE_HEDGE_MS", 0.0),
        serve_breaker_failures=_env_posint(
            "HOROVOD_SERVE_BREAKER_FAILURES", 3),
        serve_breaker_reset_seconds=_env_posfloat(
            "HOROVOD_SERVE_BREAKER_RESET", 1.0),
        serve_fleet_restart_budget=_env_nonneg_int(
            "HOROVOD_SERVE_FLEET_RESTART_BUDGET", 5),
        serve_fleet_backoff_seconds=_env_posfloat(
            "HOROVOD_SERVE_FLEET_BACKOFF", 0.5),
        serve_fleet_backoff_cap_seconds=_env_posfloat(
            "HOROVOD_SERVE_FLEET_BACKOFF_CAP", 10.0),
        serve_fleet_crash_loop_k=_env_posint(
            "HOROVOD_SERVE_FLEET_CRASH_LOOP_K", 3),
        serve_fleet_crash_loop_window_seconds=_env_posfloat(
            "HOROVOD_SERVE_FLEET_CRASH_LOOP_WINDOW", 30.0),
        serve_fleet_probe_seconds=_env_posfloat(
            "HOROVOD_SERVE_FLEET_PROBE", 0.5),
        serve_fleet_spares=_env_nonneg_int(
            "HOROVOD_SERVE_FLEET_SPARES", 0),
        serve_fleet_prefill=_env_nonneg_int(
            "HOROVOD_SERVE_FLEET_PREFILL", 0),
        serve_fleet_prefill_spares=_env_nonneg_int(
            "HOROVOD_SERVE_FLEET_PREFILL_SPARES", 0),
        request_trace=_env_bool("HOROVOD_REQUEST_TRACE"),
        request_trace_dir=os.environ.get("HOROVOD_REQUEST_TRACE_DIR")
        or None,
        request_trace_decode_every=_env_posint(
            "HOROVOD_REQUEST_TRACE_DECODE_EVERY", 16),
        metrics_port=_env_metrics_port(),
        health_interval_seconds=max(
            0.05, _env_float("HOROVOD_HEALTH_INTERVAL", 2.0)),
        health_window_seconds=_env_posfloat("HOROVOD_HEALTH_WINDOW", 30.0),
        health_fire_n=_env_posint("HOROVOD_HEALTH_FIRE_N", 2),
        health_clear_m=_env_posint("HOROVOD_HEALTH_CLEAR_M", 2),
        health_alerts_file=os.environ.get("HOROVOD_HEALTH_ALERTS_FILE")
        or None,
        fleet_scrape_interval_seconds=_env_posfloat(
            "HOROVOD_FLEET_SCRAPE_INTERVAL", 1.0),
        slo_ttft_p99_ms=_env_nonneg_float("HOROVOD_SLO_TTFT_P99_MS", 0.0),
        slo_error_rate=_env_nonneg_float("HOROVOD_SLO_ERROR_RATE", 0.0),
        slo_burn_threshold=_env_posfloat("HOROVOD_SLO_BURN_THRESHOLD", 2.0),
        blackbox=_env_bool("HOROVOD_BLACKBOX"),
        blackbox_seconds=_env_posfloat("HOROVOD_BLACKBOX_SECONDS", 120.0),
        blackbox_dir=os.environ.get("HOROVOD_BLACKBOX_DIR") or None,
        blackbox_max_bundles=_env_posint(
            "HOROVOD_BLACKBOX_MAX_BUNDLES", 8),
        blackbox_dump_on=_env_dump_on(),
        faulthandler_enable=_env_bool("HOROVOD_FAULTHANDLER", True),
        elastic_timeout_seconds=_env_float("HOROVOD_ELASTIC_TIMEOUT", 600.0),
        preemption_notice_seconds=max(
            0.0, _env_float("HOROVOD_PREEMPTION_NOTICE", 30.0)),
        fault_plan=_env_fault_plan(),
        barrier_timeout_seconds=max(
            1.0, _env_float("HOROVOD_BARRIER_TIMEOUT", 600.0)),
        config_ledger_file=os.environ.get("HOROVOD_CONFIG_LEDGER") or None,
        config_experiment_window_seconds=_env_posfloat(
            "HOROVOD_CONFIG_EXPERIMENT_WINDOW", 10.0),
        config_revert_on_regression=_env_bool(
            "HOROVOD_CONFIG_REVERT_ON_REGRESSION"),
        log_level=os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower(),
        inert={k: reason for k, reason in _INERT_VARS.items()
               if os.environ.get(k)})


_CONFIG: Optional[Config] = None

_LOG_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
               "info": logging.INFO, "warning": logging.WARNING,
               "error": logging.ERROR, "fatal": logging.CRITICAL}


def log_level_of(name: str) -> int:
    """The ``logging`` level of a ``HOROVOD_LOG_LEVEL`` word (an unknown
    word reads as ``warning``, as in the reference)."""
    return _LOG_LEVELS.get(str(name), logging.WARNING)


def get_config() -> Config:
    """The active configuration (reads the environment on first use)."""
    return _CONFIG if _CONFIG is not None else refresh()


def refresh() -> Config:
    """Re-read the environment (``init()`` does, like upstream's
    ``horovod_init``)."""
    global _CONFIG
    cfg = _read()
    prev, _CONFIG = _CONFIG, cfg
    if prev is not None:
        # A refresh after the first read must not change resolved values
        # silently: every diff goes through the config bus, so env
        # mutations and set_config share one audit trail.
        try:
            from horovod_tpu_torch import confbus
            confbus.note_refresh(prev, cfg)
        except Exception:
            pass   # auditing must never turn refresh() into a crash
    logging.getLogger("horovod_tpu_torch").setLevel(
        log_level_of(cfg.log_level))
    return cfg
