"""The config bus: the process's runtime-mutable knobs, with an audit
ledger and measured-effect windows (``hvd.set_config``).

Port of ``horovod_tpu/confbus.py``. ``config.py`` resolves every
``HOROVOD_*`` knob from the environment; this module lets an operator or an
actuator change the knobs that may change while the process runs, and
records every change:

* A **typed registry** over the config surface: every knob declares its
  ``Config`` field, its validator (the same ``_env_*`` parser
  ``config.refresh()`` uses, so a bus mutation and an env change can never
  resolve a value differently), its scope (``process|engine|fleet``), and
  whether it is **shape-affecting**. Shape-affecting knobs (the serving
  slots and lengths, the mesh, the fusion threshold, the allreduce
  lowering, ...) are refused with a typed reason: the buffers, bucket plans
  and programs built for one shape are not rebuilt under a running step.
  The registry's names, fields, scopes and flags are the reference's.
* :func:`set_config` -- the one mutation path. An applied mutation writes
  the env var and the live ``Config`` together, bumps the monotone
  ``config_epoch`` gauge, appends a JSONL **audit ledger** line
  (``HOROVOD_CONFIG_LEDGER``; who/what/old/new/reason/epoch, size-rotated
  like ``alerts.jsonl``), emits a ``CONFIG`` timeline marker and
  ``config_mutations_total{knob,outcome}``, notifies subscribers, and
  records a "config" event in the flight recorder (``blackbox.note_config``).
  The bus itself retargets the running stall watchdog
  (``HOROVOD_STALL_CHECK_TIME_SECONDS``) and the ``horovod_tpu_torch``
  logger (``HOROVOD_LOG_LEVEL``). ``config.refresh()`` routes every
  resolved-value change through the same path (:func:`note_refresh`), so
  env changes and bus mutations share one audit trail. The port's own
  fields (the rendezvous contract, which every elastic re-form changes,
  and ``hierarchical_allreduce``) stay outside the audit, as they are
  outside the reference's ``Config``.
* **Measured-effect windows**: a mutated knob with a declared target
  metric opens an experiment window over the bound
  :class:`~horovod_tpu_torch.timeseries.TimeSeriesStore`; before/after
  ``rate()`` / ``quantile()`` deltas are published as
  ``config_experiment_effect{knob}`` with a ledger verdict
  (``improved|regressed|inconclusive``). With
  ``HOROVOD_CONFIG_REVERT_ON_REGRESSION=1`` a ``regressed`` mutation is
  reverted, itself a ledgered and marked mutation. Until the continuous
  doctor is ported (ROADMAP.md section A item 9c-ii-b) nothing binds a
  store or polls the windows on its own: the caller does
  (:func:`bind_store`, :func:`poll_experiments`).

``hvd.metrics_http()`` serves ``GET /config`` (:func:`config_view`) and an
auth-token-gated ``POST /config`` (:func:`set_config`). The fleet's
``set_config`` RPC comes with the serving transport (ROADMAP.md section A
item 10). The auth token is not a knob: it is never mutable via the bus
and its value never appears in ledger lines, HTTP replies, build_info or
the log.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from horovod_tpu_torch import config as _config
from horovod_tpu_torch import metrics

logger = logging.getLogger("horovod_tpu_torch")

__all__ = [
    "KnobSpec", "set_config", "registry", "mutable_knobs", "epoch",
    "reset",
    "resolved_values", "overrides", "config_view", "subscribe",
    "unsubscribe", "bind_store", "poll_experiments",
    "pending_experiments", "recent_regressions", "ledger_tail",
    "note_refresh", "KNOWN_ENV",
]

#: rotate the config ledger past this size (base + one ``.1`` generation
#: kept — the same policy as health.ALERTS_ROTATE_BYTES, so postmortem
#: tooling reads both logs identically).
LEDGER_ROTATE_BYTES = 1 << 20

#: relative before→after change below which an experiment cannot call a
#: winner: CPU-proxy windows are noisy, so ±10% is "inconclusive".
EFFECT_THRESHOLD = 0.10

metrics.set_help("config_epoch",
                 "Monotone config-mutation epoch: bumps once per applied "
                 "knob mutation (bus, RPC fan-out, or env refresh diff).")
metrics.set_help("config_mutations_total",
                 "Config-bus mutations by knob and outcome "
                 "(applied/refused/rejected/unknown/partial).")
metrics.set_help("config_experiment_effect",
                 "Measured effect of the last experiment window per knob: "
                 "signed relative change of the target metric, oriented "
                 "so positive = improvement.")


# ---------------------------------------------------------------------------
# knob registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One ``HOROVOD_*`` knob's contract with the mutation bus."""

    env: str                         #: HOROVOD_* variable name
    field: Optional[str]             #: Config attribute (None = call-site)
    scope: str = "process"           #: process | engine | fleet
    mutable: bool = False            #: accepted by set_config
    shape_affecting: bool = False    #: refused: would retrace/recompile
    reason: str = ""                 #: why immutable / refusal text
    #: validator: the existing config._env_* parser for this knob — it
    #: reads os.environ, so the bus applies a candidate value to the env
    #: first and lets the *same* code path that init() trusts judge it.
    parser: Optional[Callable[[], Any]] = None
    #: measured-effect target: (mode, metric, better) with mode in
    #: rate|quantile|gauge and better in lower|higher.
    target: Optional[Tuple[str, str, str]] = None
    secret: bool = False             #: value never exported anywhere


_REGISTRY: Dict[str, KnobSpec] = {}


def _add(env: str, field: Optional[str] = None, **kw: Any) -> None:
    _REGISTRY[env] = KnobSpec(env=env, field=field, **kw)


_IMMUTABLE_REASON = ("resolved once at init; restart the process (or "
                     "refresh() after changing the environment) to change it")


def _shape_reason(env: str, what: str) -> str:
    return (f"{env} is shape-affecting ({what}): a live mutation would "
            f"retrace/recompile jitted programs (the decode_compiles==1 "
            f"contract), so it is refused; change it via drain-respawn "
            f"with new environment, not the config bus")


# Shape-affecting knobs: refused at mutate time with a typed reason.
_SHAPE: Dict[str, Tuple[str, str]] = {
    "HOROVOD_SERVE_SLOTS": ("serve_slots", "decode batch dimension"),
    "HOROVOD_SERVE_MAX_LEN": ("serve_max_len",
                              "KV pool / attention shapes"),
    "HOROVOD_SERVE_BLOCK_SIZE": ("serve_block_size",
                                 "paged-KV block shape"),
    "HOROVOD_SERVE_PREFILL_CHUNK": ("serve_prefill_chunk",
                                    "prefill program shape"),
    "HOROVOD_SERVE_QUEUE_LIMIT": ("serve_queue_limit",
                                  "admission queue bound fixed at "
                                  "engine construction"),
    "HOROVOD_SERVE_KV_QUANT": ("serve_kv_quant",
                               "KV pool storage layout"),
    "HOROVOD_SERVE_SPEC_K": ("serve_spec_k",
                             "decode program draft width"),
    "HOROVOD_SERVE_SPEC_PROPOSER": ("serve_spec_proposer",
                                    "draft lane wiring"),
    "HOROVOD_MESH": ("mesh", "device mesh factoring"),
    "HOROVOD_TOPOLOGY": ("topology", "torus factoring"),
    "HOROVOD_FUSION_THRESHOLD": ("fusion_threshold_bytes",
                                 "fusion bucket shapes"),
    "HOROVOD_OVERLAP_CHUNKS": ("overlap_chunks",
                               "chunked-allreduce pipeline shape"),
    "HOROVOD_ALLREDUCE_ALGORITHM": ("allreduce_algorithm",
                                    "collective lowering"),
    "HOROVOD_ALLREDUCE_WIRE": ("allreduce_wire",
                               "collective wire dtype"),
    "HOROVOD_MP_RULES": ("mp_rules", "partition rule set"),
}
for _env, (_fld, _what) in _SHAPE.items():
    _add(_env, _fld, shape_affecting=True, reason=_shape_reason(_env, _what))


def _p(fn: Callable, *args: Any) -> Callable[[], Any]:
    return lambda: fn(*args)


# Runtime-mutable knobs: validator = the config._env_* parser, plus the
# declared measured-effect target metric where one exists.
_add("HOROVOD_SERVE_HEDGE_MS", "serve_hedge_ms", mutable=True,
     scope="fleet",
     parser=_p(_config._env_nonneg_float, "HOROVOD_SERVE_HEDGE_MS", 0.0),
     target=("rate", "transport_hedges_total", "lower"))
_add("HOROVOD_SERVE_RPC_TIMEOUT", "serve_rpc_timeout_seconds",
     mutable=True, scope="fleet",
     parser=_p(_config._env_posfloat, "HOROVOD_SERVE_RPC_TIMEOUT", 5.0),
     target=("rate", "transport_retries_total", "lower"))
_add("HOROVOD_SERVE_MAX_RETRIES", "serve_max_retries", mutable=True,
     scope="fleet",
     parser=_p(_config._env_nonneg_int, "HOROVOD_SERVE_MAX_RETRIES", 3),
     target=("rate", "transport_retries_total", "lower"))
_add("HOROVOD_SERVE_BREAKER_FAILURES", "serve_breaker_failures",
     mutable=True, scope="fleet",
     parser=_p(_config._env_posint, "HOROVOD_SERVE_BREAKER_FAILURES", 3))
_add("HOROVOD_SERVE_BREAKER_RESET", "serve_breaker_reset_seconds",
     mutable=True, scope="fleet",
     parser=_p(_config._env_posfloat, "HOROVOD_SERVE_BREAKER_RESET", 1.0))
_add("HOROVOD_SERVE_PREFIX_CACHE", "serve_prefix_cache", mutable=True,
     scope="engine",
     parser=_p(_config._env_bool, "HOROVOD_SERVE_PREFIX_CACHE"),
     target=("gauge", "prefix_cache_hit_rate", "higher"))
_add("HOROVOD_REQUEST_TRACE_DECODE_EVERY", "request_trace_decode_every",
     mutable=True, scope="engine",
     parser=_p(_config._env_posint,
               "HOROVOD_REQUEST_TRACE_DECODE_EVERY", 16))
_add("HOROVOD_STALL_CHECK_TIME_SECONDS", "stall_check_time_seconds",
     mutable=True, scope="process",
     parser=_p(_config._env_float,
               "HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0))
_add("HOROVOD_HEALTH_INTERVAL", "health_interval_seconds", mutable=True,
     scope="process",
     parser=lambda: max(0.05,
                        _config._env_float("HOROVOD_HEALTH_INTERVAL", 2.0)))
_add("HOROVOD_HEALTH_WINDOW", "health_window_seconds", mutable=True,
     scope="process",
     parser=_p(_config._env_posfloat, "HOROVOD_HEALTH_WINDOW", 30.0))
_add("HOROVOD_HEALTH_FIRE_N", "health_fire_n", mutable=True,
     scope="process",
     parser=_p(_config._env_posint, "HOROVOD_HEALTH_FIRE_N", 2))
_add("HOROVOD_HEALTH_CLEAR_M", "health_clear_m", mutable=True,
     scope="process",
     parser=_p(_config._env_posint, "HOROVOD_HEALTH_CLEAR_M", 2))
_add("HOROVOD_SLO_TTFT_P99_MS", "slo_ttft_p99_ms", mutable=True,
     scope="process",
     parser=_p(_config._env_nonneg_float, "HOROVOD_SLO_TTFT_P99_MS", 0.0))
_add("HOROVOD_SLO_ERROR_RATE", "slo_error_rate", mutable=True,
     scope="process",
     parser=_p(_config._env_nonneg_float, "HOROVOD_SLO_ERROR_RATE", 0.0))
_add("HOROVOD_SLO_BURN_THRESHOLD", "slo_burn_threshold", mutable=True,
     scope="process",
     parser=_p(_config._env_posfloat, "HOROVOD_SLO_BURN_THRESHOLD", 2.0))
_add("HOROVOD_SERVE_FLEET_PROBE", "serve_fleet_probe_seconds",
     mutable=True, scope="fleet",
     parser=_p(_config._env_posfloat, "HOROVOD_SERVE_FLEET_PROBE", 0.5))
_add("HOROVOD_METRICS_INTERVAL", "metrics_interval_seconds", mutable=True,
     scope="process",
     parser=lambda: max(0.05,
                        _config._env_float("HOROVOD_METRICS_INTERVAL",
                                           10.0)))
_add("HOROVOD_LOG_LEVEL", "log_level", mutable=True, scope="process",
     parser=lambda: os.environ.get("HOROVOD_LOG_LEVEL",
                                   "warning").lower())
_add("HOROVOD_CONFIG_REVERT_ON_REGRESSION", "config_revert_on_regression",
     mutable=True, scope="process",
     parser=_p(_config._env_bool, "HOROVOD_CONFIG_REVERT_ON_REGRESSION"))
_add("HOROVOD_CONFIG_EXPERIMENT_WINDOW",
     "config_experiment_window_seconds", mutable=True, scope="process",
     parser=_p(_config._env_posfloat,
               "HOROVOD_CONFIG_EXPERIMENT_WINDOW", 10.0))

# The transport auth secret: validated at init, never mutable, never
# exported — config.py's "value not shown" contract extends to the bus.
_add("HOROVOD_SERVE_AUTH_TOKEN", "serve_auth_token", secret=True,
     reason="auth secret: not mutable via the config bus; its value is "
            "never shown in ledgers, markers, or /config")

# Everything else config.refresh() resolves: registered (the drift test
# and GET /config see the full surface) but immutable via the bus.
_IMMUTABLE_FIELDS: Dict[str, str] = {
    "HOROVOD_XLA_LATENCY_HIDING": "xla_latency_hiding",
    "HOROVOD_TIMELINE": "timeline_path",
    "HOROVOD_TIMELINE_MARK_CYCLES": "timeline_mark_cycles",
    "HOROVOD_TRACE_JAX_PROFILER": "trace_jax_profiler",
    "HOROVOD_AUTOTUNE": "autotune",
    "HOROVOD_AUTOTUNE_LOG": "autotune_log",
    "HOROVOD_AUTOTUNE_MODE": "autotune_mode",
    "HOROVOD_AUTOTUNE_PROBES": "autotune_probes",
    "HOROVOD_AUTOTUNE_SAMPLES": "autotune_samples",
    "HOROVOD_METRICS_FILE": "metrics_file",
    "HOROVOD_METRICS_GRAD_NORM": "metrics_grad_norm",
    "HOROVOD_STALL_CHECK_DISABLE": "stall_check_disable",
    "HOROVOD_PROFILE_ON_STALL": "profile_on_stall",
    "HOROVOD_PROFILE_DIR": "profile_dir",
    "HOROVOD_PROFILE_SECONDS": "profile_seconds",
    "HOROVOD_PROFILE_MAX_CAPTURES": "profile_max_captures",
    "HOROVOD_PROFILER_COST": "profiler_cost",
    "HOROVOD_SERVE_HEARTBEAT": "serve_heartbeat_seconds",
    "HOROVOD_SERVE_ROLE": "serve_role",
    "HOROVOD_SERVE_KV_WIRE": "serve_kv_wire",
    "HOROVOD_SERVE_AFFINITY": "serve_affinity",
    "HOROVOD_SERVE_TRANSPORT": "serve_transport",
    "HOROVOD_SERVE_FLEET_RESTART_BUDGET": "serve_fleet_restart_budget",
    "HOROVOD_SERVE_FLEET_BACKOFF": "serve_fleet_backoff_seconds",
    "HOROVOD_SERVE_FLEET_BACKOFF_CAP": "serve_fleet_backoff_cap_seconds",
    "HOROVOD_SERVE_FLEET_CRASH_LOOP_K": "serve_fleet_crash_loop_k",
    "HOROVOD_SERVE_FLEET_CRASH_LOOP_WINDOW":
        "serve_fleet_crash_loop_window_seconds",
    "HOROVOD_SERVE_FLEET_SPARES": "serve_fleet_spares",
    "HOROVOD_SERVE_FLEET_PREFILL": "serve_fleet_prefill",
    "HOROVOD_SERVE_FLEET_PREFILL_SPARES": "serve_fleet_prefill_spares",
    "HOROVOD_REQUEST_TRACE": "request_trace",
    "HOROVOD_REQUEST_TRACE_DIR": "request_trace_dir",
    "HOROVOD_METRICS_PORT": "metrics_port",
    "HOROVOD_HEALTH_ALERTS_FILE": "health_alerts_file",
    "HOROVOD_FLEET_SCRAPE_INTERVAL": "fleet_scrape_interval_seconds",
    "HOROVOD_BLACKBOX": "blackbox",
    "HOROVOD_BLACKBOX_SECONDS": "blackbox_seconds",
    "HOROVOD_BLACKBOX_DIR": "blackbox_dir",
    "HOROVOD_BLACKBOX_MAX_BUNDLES": "blackbox_max_bundles",
    "HOROVOD_BLACKBOX_DUMP_ON": "blackbox_dump_on",
    "HOROVOD_FAULTHANDLER": "faulthandler_enable",
    "HOROVOD_ELASTIC_TIMEOUT": "elastic_timeout_seconds",
    "HOROVOD_PREEMPTION_NOTICE": "preemption_notice_seconds",
    "HOROVOD_FAULT_PLAN": "fault_plan",
    "HOROVOD_BARRIER_TIMEOUT": "barrier_timeout_seconds",
    "HOROVOD_CONFIG_LEDGER": "config_ledger_file",
}
for _env, _fld in _IMMUTABLE_FIELDS.items():
    _add(_env, _fld, reason=_IMMUTABLE_REASON)

# Documented HOROVOD_* variables outside the bus's Config surface -- known
# to the drift test, invisible to the bus (the reference's set).
_CALL_SITE_ENV: Dict[str, str] = {
    "HOROVOD_HIERARCHICAL_ALLREDUCE":
        "read into the port's own Config field hierarchical_allreduce, "
        "which collective/adasum read; outside the bus's audit",
    "HOROVOD_PEAK_TFLOPS": "roofline calibration, read by profiler",
    "HOROVOD_HBM_GBPS": "roofline calibration, read by profiler",
    "HOROVOD_REQTRACE_LABEL":
        "process label of the request-trace shard (serving, not ported "
        "yet)",
}
for _env, _why in _CALL_SITE_ENV.items():
    _add(_env, None, reason=_why)

#: every HOROVOD_* variable the codebase understands — registry knobs,
#: call-site knobs, and the accepted-but-inert set. The doc-drift tier-1
#: test holds the documented env tables to exactly this surface.
KNOWN_ENV = frozenset(_REGISTRY) | frozenset(_config._INERT_VARS)

_FIELD_TO_ENV: Dict[str, str] = {
    s.field: s.env for s in _REGISTRY.values() if s.field}

#: the port's own ``Config`` fields, which the reference's ``Config`` does
#: not have: the rendezvous contract changes on every elastic re-form
#: (``shutdown()`` + ``init()``), and ``hierarchical_allreduce`` is the
#: call-site knob above. :func:`note_refresh` audits none of them.
_UNAUDITED_FIELDS = frozenset({
    "hierarchical_allreduce", "rank", "world_size", "local_rank",
    "local_size", "master_addr", "master_port"})


def registry() -> Dict[str, KnobSpec]:
    """The full knob registry, by env var name (a copy)."""
    return dict(_REGISTRY)


def mutable_knobs() -> List[str]:
    """Env names :func:`set_config` accepts, sorted."""
    return sorted(e for e, s in _REGISTRY.items() if s.mutable)


# ---------------------------------------------------------------------------
# bus state
# ---------------------------------------------------------------------------

_LOCK = threading.RLock()
_EPOCH = 0
_LEDGER_MEM: Deque[Dict[str, Any]] = deque(maxlen=512)
_SUBS: List[Callable[[str, Any, Any, int], None]] = []
_EXPERIMENTS: List[Dict[str, Any]] = []
_REGRESSIONS: Deque[Dict[str, Any]] = deque(maxlen=64)
_STORE: Optional[Any] = None     # timeseries.TimeSeriesStore


def epoch() -> int:
    """The process's monotone config epoch (0 = never mutated)."""
    return _EPOCH


def reset() -> None:
    """Reset the bus to its never-mutated state: epoch 0, empty ledger
    memory, no subscribers, no open experiments, no bound store. For
    tests and smoke harness retries (pairs with
    ``metrics.reset_metrics()``); the persisted ledger file is left
    alone — it is an audit log."""
    global _EPOCH, _STORE
    with _LOCK:
        _EPOCH = 0
        _LEDGER_MEM.clear()
        _SUBS.clear()
        _EXPERIMENTS.clear()
        _REGRESSIONS.clear()
        _STORE = None


def subscribe(fn: Callable[[str, Any, Any, int], None]) -> Callable:
    """Register ``fn(env, old, new, epoch)`` to run after every applied
    mutation (bus, RPC, or env-refresh diff). Returns ``fn`` so callers
    can hold it for :func:`unsubscribe`. Subscriber exceptions are
    logged, never propagated into the mutation path."""
    with _LOCK:
        if fn not in _SUBS:
            _SUBS.append(fn)
    return fn


def unsubscribe(fn: Callable) -> None:
    with _LOCK:
        if fn in _SUBS:
            _SUBS.remove(fn)


def bind_store(store: Any) -> None:
    """Bind the :class:`~horovod_tpu_torch.timeseries.TimeSeriesStore`
    experiment windows measure against (the reference's continuous doctor
    binds its own store on construction; tests bind canned ones)."""
    global _STORE
    _STORE = store


def ledger_tail(n: int = 50) -> List[Dict[str, Any]]:
    """The last ``n`` in-memory ledger records (persisted ones too when
    ``HOROVOD_CONFIG_LEDGER`` is set — this is the always-on view)."""
    with _LOCK:
        return list(_LEDGER_MEM)[-int(n):]


def _append_ledger(rec: Dict[str, Any]) -> None:
    with _LOCK:
        _LEDGER_MEM.append(dict(rec))
    path = getattr(_config.get_config(), "config_ledger_file", None)
    if not path:
        return
    try:
        # Same rotation policy as alerts.jsonl: size-gated, base + one
        # .1 generation — a chatty experiment loop can't fill a disk.
        try:
            if os.path.getsize(path) >= LEDGER_ROTATE_BYTES:
                os.replace(path, path + ".1")
        except OSError:
            pass
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
    except OSError:
        logger.exception("confbus: cannot append %s", path)


def _note_blackbox(event: str, **fields: Any) -> None:
    try:
        from horovod_tpu_torch import blackbox
        blackbox.note_config(event, **fields)
    except Exception:
        pass


def _fmt_env(value: Any) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if value is None:
        return ""
    return str(value)


def _who(origin: str) -> str:
    return f"{origin}:pid{os.getpid()}"


def _resolve(name: str) -> Tuple[str, Optional[KnobSpec]]:
    """Accept an env var name or a Config field name."""
    if name in _REGISTRY:
        return name, _REGISTRY[name]
    env = _FIELD_TO_ENV.get(name)
    if env is not None:
        return env, _REGISTRY[env]
    return str(name), None


def _builtin_react(env: str, new: Any) -> None:
    """Reactions the bus owns directly (everything else subscribes)."""
    if env == "HOROVOD_LOG_LEVEL":
        logging.getLogger("horovod_tpu_torch").setLevel(
            _config.log_level_of(new))
    elif env == "HOROVOD_STALL_CHECK_TIME_SECONDS":
        wd = metrics.get_stall_watchdog()
        if wd is not None:
            wd.timeout_s = float(new)


def _notify(env: str, old: Any, new: Any, ep: int) -> None:
    try:
        _builtin_react(env, new)
    except Exception:
        logger.exception("confbus: builtin reaction failed for %s", env)
    with _LOCK:
        subs = list(_SUBS)
    for fn in subs:
        try:
            fn(env, old, new, ep)
        except Exception:
            logger.exception("confbus: subscriber %r failed for %s",
                             fn, env)


# ---------------------------------------------------------------------------
# the mutation path
# ---------------------------------------------------------------------------

def _refusal(env: str, spec: Optional[KnobSpec], outcome: str, code: str,
             error: str, *, reason: str, origin: str) -> Dict[str, Any]:
    rec = {"ts": time.time(), "event": "mutation", "knob": env,
           "field": spec.field if spec else None, "outcome": outcome,
           "code": code, "error": error, "who": _who(origin),
           "origin": origin, "reason": reason, "epoch": _EPOCH}
    metrics.counter("config_mutations_total", knob=env,
                    outcome=outcome).inc()
    metrics._timeline_marker("CONFIG", category="config",
                             event="mutation", knob=env, outcome=outcome,
                             code=code, origin=origin)
    _append_ledger(rec)
    _note_blackbox("mutation", knob=env, outcome=outcome, code=code,
                   origin=origin)
    return {"ok": False, "outcome": outcome, "code": code, "knob": env,
            "error": error, "epoch": _EPOCH}


def set_config(name: str, value: Any, *, reason: str = "",
               origin: str = "api",
               experiment: bool = True) -> Dict[str, Any]:
    """Mutate one runtime knob through the observable bus
    (``hvd.set_config``). ``name`` is the ``HOROVOD_*`` env var (or its
    ``Config`` field name); ``reason`` is the operator's free-text
    attribution, ``origin`` says which path carried the mutation
    (``api``/``rpc``/``http``/``revert``/``env-refresh``).

    Returns a typed result dict (never raises on refusal/rejection):
    ``outcome`` is ``applied`` — env + live ``Config`` updated, epoch
    bumped, ledger/marker/counter written, subscribers notified, and an
    experiment window opened when the knob declares a target metric — or
    ``refused`` (shape-affecting/immutable/secret, with ``code``),
    ``rejected`` (validator said no), or ``unknown``."""
    env, spec = _resolve(name)
    if spec is None:
        return _refusal(env, None, "unknown", "unknown",
                        f"unknown knob {name!r}: not a registered "
                        f"HOROVOD_* configuration variable",
                        reason=reason, origin=origin)
    if spec.secret:
        return _refusal(env, spec, "refused", "secret", spec.reason,
                        reason=reason, origin=origin)
    if spec.shape_affecting:
        return _refusal(env, spec, "refused", "shape_affecting",
                        spec.reason, reason=reason, origin=origin)
    if not spec.mutable or spec.parser is None or spec.field is None:
        return _refusal(env, spec, "refused", "immutable",
                        f"{env} is not runtime-mutable: {spec.reason}",
                        reason=reason, origin=origin)

    global _EPOCH
    with _LOCK:
        cfg = _config.get_config()
        old = getattr(cfg, spec.field)
        prev_env = os.environ.get(env)
        os.environ[env] = _fmt_env(value)
        try:
            new = spec.parser()
        except (ValueError, TypeError) as e:
            if prev_env is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = prev_env
            return _refusal(env, spec, "rejected", "invalid", str(e),
                            reason=reason, origin=origin)
        # The env var and the live Config move together: a later
        # refresh() re-resolves the same value and audits no diff.
        setattr(cfg, spec.field, new)
        _EPOCH += 1
        ep = _EPOCH

    metrics.gauge("config_epoch").set(float(ep))
    metrics.counter("config_mutations_total", knob=env,
                    outcome="applied").inc()
    metrics._timeline_marker("CONFIG", category="config",
                             event="mutation", knob=env, old=old, new=new,
                             epoch=ep, origin=origin)
    rec = {"ts": time.time(), "event": "mutation", "knob": env,
           "field": spec.field, "old": old, "new": new,
           "outcome": "applied", "who": _who(origin), "origin": origin,
           "reason": reason, "epoch": ep, "scope": spec.scope}
    _append_ledger(rec)
    _note_blackbox("mutation", knob=env, old=old, new=new, epoch=ep,
                   origin=origin, reason=reason)
    _notify(env, old, new, ep)

    opened = False
    if experiment and spec.target is not None and new != old:
        opened = _open_experiment(spec, old, new, ep, origin)
    return {"ok": True, "outcome": "applied", "knob": env,
            "field": spec.field, "old": old, "new": new, "epoch": ep,
            "scope": spec.scope, "experiment": opened}


def note_refresh(prev: Any, cfg: Any) -> None:
    """Audit hook for ``config.refresh()``: WARN a knob-by-knob diff of
    any resolved-value change after init and route each through the same
    bus path (epoch bump, ledger, marker, counter, subscribers) — env
    mutations and bus mutations share one audit trail."""
    global _EPOCH
    diffs: List[Tuple[str, Any, Any]] = []
    for f in dataclasses.fields(cfg):
        if f.name in _UNAUDITED_FIELDS:
            continue
        old, new = getattr(prev, f.name), getattr(cfg, f.name)
        if old != new:
            diffs.append((f.name, old, new))
    for fname, old, new in diffs:
        env = _FIELD_TO_ENV.get(fname, fname)
        spec = _REGISTRY.get(env)
        if spec is not None and spec.secret:
            old_s, new_s = ("<set>" if old else "<unset>",
                            "<set>" if new else "<unset>")
            old = new = None
        else:
            old_s, new_s = repr(old), repr(new)
        logger.warning("config: refresh() changed %s (%s): %s -> %s "
                       "(audited as config epoch %d)",
                       env, fname, old_s, new_s, _EPOCH + 1)
        with _LOCK:
            _EPOCH += 1
            ep = _EPOCH
        metrics.gauge("config_epoch").set(float(ep))
        metrics.counter("config_mutations_total", knob=env,
                        outcome="applied").inc()
        metrics._timeline_marker("CONFIG", category="config",
                                 event="mutation", knob=env,
                                 epoch=ep, origin="env-refresh")
        _append_ledger({"ts": time.time(), "event": "mutation",
                        "knob": env, "field": fname, "old": old,
                        "new": new, "outcome": "applied",
                        "who": _who("env-refresh"),
                        "origin": "env-refresh",
                        "reason": "refresh() re-resolved from environment",
                        "epoch": ep})
        _note_blackbox("mutation", knob=env, epoch=ep,
                       origin="env-refresh")
        _notify(env, old, new, ep)


# ---------------------------------------------------------------------------
# measured-effect windows
# ---------------------------------------------------------------------------

def _measure(target: Tuple[str, str, str], window_s: float,
             now: Optional[float] = None) -> Optional[float]:
    store = _STORE
    if store is None:
        return None
    mode, metric, _ = target
    try:
        if mode == "rate":
            return float(store.rate(metric, window_s, now=now))
        if mode == "quantile":
            return store.quantile(metric, 0.99, window_s, now=now)
        return store.latest(metric)
    except Exception:
        return None


def _open_experiment(spec: KnobSpec, old: Any, new: Any, ep: int,
                     origin: str) -> bool:
    cfg = _config.get_config()
    win = float(getattr(cfg, "config_experiment_window_seconds", 10.0))
    t0 = time.time()
    before = _measure(spec.target, win, now=t0)
    with _LOCK:
        # A re-mutation supersedes the knob's open window: the old
        # before/after pair no longer measures one change.
        for e in [e for e in _EXPERIMENTS if e["knob"] == spec.env]:
            _EXPERIMENTS.remove(e)
            _append_ledger({"ts": t0, "event": "experiment",
                            "knob": spec.env, "epoch": e["epoch"],
                            "verdict": "superseded"})
        _EXPERIMENTS.append({
            "knob": spec.env, "field": spec.field, "epoch": ep,
            "t0": t0, "window_s": win, "old": old, "new": new,
            "origin": origin, "before": before,
            "mode": spec.target[0], "metric": spec.target[1],
            "better": spec.target[2]})
    return True


def pending_experiments() -> List[Dict[str, Any]]:
    """Open experiment windows (served by ``GET /config``)."""
    with _LOCK:
        return [dict(e) for e in _EXPERIMENTS]


def _judge(before: Optional[float], after: Optional[float],
           better: str) -> Tuple[str, Optional[float]]:
    if before is None or after is None:
        return "inconclusive", None
    delta = after - before
    rel = delta / max(abs(before), 1e-9)
    effect = -rel if better == "lower" else rel   # positive = improvement
    if abs(delta) < 1e-9:
        return "inconclusive", effect
    if effect <= -EFFECT_THRESHOLD:
        return "regressed", effect
    if effect >= EFFECT_THRESHOLD:
        return "improved", effect
    return "inconclusive", effect


def poll_experiments(now: Optional[float] = None) -> List[Dict[str, Any]]:
    """Evaluate experiment windows that have elapsed: publish
    ``config_experiment_effect{knob}``, write the ledger verdict, record
    regressions for the doctor, and — with
    ``HOROVOD_CONFIG_REVERT_ON_REGRESSION=1`` — auto-revert a regressed
    mutation. The reference's continuous doctor calls this every tick;
    tests and tools call it directly. Returns the completed experiment records."""
    now = time.time() if now is None else float(now)
    with _LOCK:
        due = [e for e in _EXPERIMENTS if now - e["t0"] >= e["window_s"]]
        for e in due:
            _EXPERIMENTS.remove(e)
    done: List[Dict[str, Any]] = []
    for e in due:
        after = _measure((e["mode"], e["metric"], e["better"]),
                         e["window_s"], now=now)
        verdict, effect = _judge(e["before"], after, e["better"])
        if effect is not None:
            metrics.gauge("config_experiment_effect",
                          knob=e["knob"]).set(effect)
        metrics._timeline_marker("CONFIG", category="config",
                                 event="experiment", knob=e["knob"],
                                 verdict=verdict, epoch=e["epoch"])
        rec = {"ts": now, "event": "experiment", "knob": e["knob"],
               "metric": e["metric"], "mode": e["mode"],
               "before": e["before"], "after": after,
               "effect": effect, "verdict": verdict,
               "epoch": e["epoch"], "old": e["old"], "new": e["new"]}
        _append_ledger(rec)
        _note_blackbox("experiment", knob=e["knob"], verdict=verdict,
                       effect=effect, epoch=e["epoch"])
        if verdict == "regressed":
            reg = {"ts": now, "knob": e["knob"], "metric": e["metric"],
                   "before": e["before"], "after": after,
                   "effect": effect, "epoch": e["epoch"],
                   "reverted": False}
            cfg = _config.get_config()
            if getattr(cfg, "config_revert_on_regression", False) \
                    and e["origin"] != "revert":
                res = set_config(
                    e["knob"], e["old"],
                    reason=f"auto-revert: {e['metric']} regressed "
                           f"({e['before']:.4g} -> {after:.4g} over "
                           f"{e['window_s']:g}s)",
                    origin="revert", experiment=False)
                reg["reverted"] = bool(res.get("ok"))
                reg["revert_epoch"] = res.get("epoch")
            with _LOCK:
                _REGRESSIONS.append(reg)
        done.append(rec)
    return done


def recent_regressions(window_s: float,
                       now: Optional[float] = None
                       ) -> List[Dict[str, Any]]:
    """Regressed-verdict records inside the window (the source of the
    reference's ``config_regression`` finding)."""
    now = time.time() if now is None else float(now)
    with _LOCK:
        return [dict(r) for r in _REGRESSIONS
                if now - r["ts"] <= float(window_s)]


# ---------------------------------------------------------------------------
# views (GET /config, build_info)
# ---------------------------------------------------------------------------

def resolved_values() -> Dict[str, Any]:
    """Currently-resolved value per registered knob, by env var name.
    The auth token is exported as a boolean (enabled) only."""
    cfg = _config.get_config()
    out: Dict[str, Any] = {}
    for env, spec in sorted(_REGISTRY.items()):
        if spec.field is None:
            continue
        v = getattr(cfg, spec.field)
        out[env] = bool(v) if spec.secret else v
    return out


def overrides() -> Dict[str, Dict[str, Any]]:
    """Knobs whose resolved value differs from the dataclass default (the
    drift view of ``GET /config``)."""
    defaults = _config.Config()
    cfg = _config.get_config()
    out: Dict[str, Dict[str, Any]] = {}
    for env, spec in sorted(_REGISTRY.items()):
        if spec.field is None:
            continue
        v, d = getattr(cfg, spec.field), getattr(defaults, spec.field)
        if v != d:
            if spec.secret:
                v, d = bool(v), bool(d)
            out[env] = {"value": v, "default": d}
    return out


def config_view() -> Dict[str, Any]:
    """The ``GET /config`` document: epoch, resolved values, non-default
    overrides, mutability surface, open experiments, ledger tail."""
    return {"epoch": epoch(),
            "values": resolved_values(),
            "overrides": overrides(),
            "mutable": mutable_knobs(),
            "shape_affecting": sorted(
                e for e, s in _REGISTRY.items() if s.shape_affecting),
            "pending_experiments": pending_experiments(),
            "ledger_tail": ledger_tail(20)}
