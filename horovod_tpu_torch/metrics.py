"""Metrics: counters, gauges, histograms, their exporters, and the
collective stall watchdog.

Port of the core of ``horovod_tpu/metrics.py``: a thread-safe in-process
registry that the controller writes to --

* ``collective.py``: per-collective call counts, bytes, dispatch latency,
  negotiation rounds (full vs cached fast path) and the cross-rank arrival
  spread;
* ``fusion.py``: fusion-bucket fill ratio and flush causes, counted per
  call (the reference counts per compilation: its fusion runs at trace
  time);
* ``optimizer.py``: the gradient-norm gauge (``HOROVOD_METRICS_GRAD_NORM``);
* ``core.py``: init spans and the world-size gauge.

Public surface (also ``hvd.metrics()`` / ``hvd.reset_metrics``):

* :func:`snapshot` -- one consistent dict of every registered series. The
  module itself is callable (``hvd.metrics()``) and returns this snapshot.
* :func:`to_prometheus` / :func:`to_json` -- the exporters, byte for byte
  the reference's (same ``horovod_tpu_`` prefix and ``# HELP`` table, so
  scrapes of both packages are the same); :func:`start_metrics_flusher`
  writes periodic snapshots to ``HOROVOD_METRICS_FILE``.
* :class:`StallWatchdog` -- a monitor thread that fires when a collective
  has been pending longer than a timeout, naming the tensor, process set
  and waiting ranks. It and the flusher only read host tables (the
  pending-collective table, the arrival records): a thread that touched
  CUDA or ``torch.distributed`` could deadlock against the NCCL stream.

* :func:`metrics_http` / :class:`MetricsHTTPServer` -- the live scrape
  endpoint (``hvd.metrics_http``): ``/metrics`` for Prometheus,
  ``/metrics.json``, ``/trace``, ``/healthz``, ``/config`` and
  ``POST /config`` (gated by ``HOROVOD_SERVE_AUTH_TOKEN``). Its threads
  read the registry only. Nothing starts it but a call: not ``init()``.
  ``/config`` is the config bus's (``confbus.py``). Where the module behind
  a route is not ported yet (``serving.reqtrace``, ``health``) the route
  gives the reference's own fallback; ``/doctor`` serves
  ``profiler.doctor()``.

A snapshot copies the series maps under the registry's lock and reads
the values outside it, each histogram in one acquisition of its own lock,
so a scrape taken while a step writes never shows a histogram whose count
disagrees with its buckets (counters only grow, so no counter reads below
an earlier scrape's either).

A stall fire hands off to the profiler (``profiler.maybe_trigger``: one
bounded capture under ``HOROVOD_PROFILE_ON_STALL=1``) and to the flight
recorder (``blackbox.on_stall``: a ``stall`` bundle under
``HOROVOD_BLACKBOX=1``, debounced).
Importing this module starts no thread: ``init()`` starts the watchdog and
the flusher.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import re
import threading
import time
from bisect import bisect_left
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("horovod_tpu_torch")

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "registry",
    "counter", "gauge", "histogram", "event",
    "snapshot", "reset_metrics", "to_prometheus", "to_json", "set_help",
    "collective_summary",
    "start_metrics_flusher", "stop_metrics_flusher",
    "register_atexit_drain",
    "collective_begin", "collective_end", "pending_collectives",
    "StallWatchdog", "start_stall_watchdog", "stop_stall_watchdog",
    "get_stall_watchdog",
    "LATENCY_BUCKETS", "SIZE_BUCKETS", "RATIO_BUCKETS",
    "SERVE_LATENCY_BUCKETS", "on_init", "on_shutdown",
    "MetricsHTTPServer", "metrics_http",
]

# Fixed bucket edges (upper bounds, seconds / bytes / ratio). Fixed — not
# adaptive — so snapshots from different ranks and different times merge.
LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
SIZE_BUCKETS: Tuple[float, ...] = tuple(
    float(256 << (2 * i)) for i in range(12))      # 256 B .. 512 MB
RATIO_BUCKETS: Tuple[float, ...] = tuple(i / 10.0 for i in range(1, 11))
# Serving latencies (TTFT / TPOT / push lag): the v2 stream wire put
# client TTFT around 10ms and per-token push lag well under 1ms, which
# LATENCY_BUCKETS is too coarse to resolve — an explicit set dense from
# 250µs through the tens-of-ms band. Passed explicitly (buckets=) at
# every observe site of serve_ttft_seconds / serve_tpot_seconds /
# transport_stream_push_lag_seconds: the registry freezes a family's
# layout at first registration, so every site must agree.
SERVE_LATENCY_BUCKETS: Tuple[float, ...] = (
    2.5e-4, 5e-4, 7.5e-4, 1e-3, 1.5e-3, 2.5e-3, 4e-3, 6e-3, 1e-2,
    1.5e-2, 2.5e-2, 4e-2, 6e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: float = 1) -> None:
        if hasattr(n, "item"):
            n = n.item()   # numpy/torch scalar -> python: keeps JSON exportable
        if n < 0:
            raise ValueError(f"counters only go up (got {n})")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins scalar (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (thread-safe): per-bucket counts + sum +
    count, Prometheus-compatible (buckets are upper bounds; an implicit
    +Inf bucket catches the tail)."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] including the +Inf bucket
        (the reference's public API; the port's own readers use
        :meth:`state`)."""
        return self.state()[2]

    def state(self) -> Tuple[int, float, List[Tuple[float, int]]]:
        """``(count, sum, cumulative())`` read in one acquisition of the
        lock: the +Inf bucket always equals the count."""
        with self._lock:
            count, total, counts = self._count, self._sum, list(self._counts)
        out, running = [], 0
        for le, c in zip(list(self.buckets) + [float("inf")], counts):
            running += c
            out.append((le, running))
        return count, total, out


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Thread-safe name+labels keyed store of counters/gauges/histograms."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, Dict[tuple, Counter]] = {}
        self._gauges: Dict[str, Dict[tuple, Gauge]] = {}
        self._hists: Dict[str, Dict[tuple, Histogram]] = {}
        self._hist_buckets: Dict[str, Tuple[float, ...]] = {}

    def counter(self, name: str, /, **labels) -> Counter:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            m = series.get(key)
            if m is None:
                m = series[key] = Counter()
            return m

    def gauge(self, name: str, /, **labels) -> Gauge:
        key = _label_key(labels)
        with self._lock:
            series = self._gauges.setdefault(name, {})
            m = series.get(key)
            if m is None:
                m = series[key] = Gauge()
            return m

    def histogram(self, name: str, /,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels) -> Histogram:
        key = _label_key(labels)
        with self._lock:
            series = self._hists.setdefault(name, {})
            m = series.get(key)
            if m is None:
                # First registration fixes the bucket layout for the name;
                # later series of the same name share it so exports merge.
                bk = self._hist_buckets.setdefault(
                    name, tuple(buckets) if buckets else LATENCY_BUCKETS)
                m = series[key] = Histogram(bk)
            return m

    def event(self, name: str, /, **args) -> None:
        """Count a notable occurrence and cross-link it into the active
        timeline as an instant marker (``args`` become marker args, not
        metric labels — high-cardinality values must not mint series)."""
        self.counter(name + "_total").inc()
        _timeline_marker(name, **args)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._hist_buckets.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = {n: dict(s) for n, s in self._counters.items()}
            gauges = {n: dict(s) for n, s in self._gauges.items()}
            hists = {n: dict(s) for n, s in self._hists.items()}
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for n, series in counters.items():
            out["counters"][n] = [
                {"labels": dict(k), "value": m.value}
                for k, m in sorted(series.items())]
        for n, series in gauges.items():
            out["gauges"][n] = [
                {"labels": dict(k), "value": m.value}
                for k, m in sorted(series.items())]
        for n, series in hists.items():
            rows = []
            for k, m in sorted(series.items()):
                count, total, cum = m.state()
                rows.append({"labels": dict(k), "count": count, "sum": total,
                             "buckets": [[le, c] for le, c in cum]})
            out["histograms"][n] = rows
        out["pending_collectives"] = pending_collectives()
        return out


#: the process-global registry every instrumentation site writes to
registry = Registry()

# Module-level conveniences bound to the global registry.
def counter(name: str, /, **labels) -> Counter:
    return registry.counter(name, **labels)


def gauge(name: str, /, **labels) -> Gauge:
    return registry.gauge(name, **labels)


def histogram(name: str, /, buckets: Optional[Tuple[float, ...]] = None,
              **labels) -> Histogram:
    return registry.histogram(name, buckets=buckets, **labels)


def event(name: str, /, **args) -> None:
    registry.event(name, **args)


def snapshot() -> Dict[str, Any]:
    """One consistent dict of every registered metric (``hvd.metrics()``)."""
    return registry.snapshot()


def reset_metrics() -> None:
    """Drop every registered series (``hvd.reset_metrics()``). Pending
    collective entries are kept — they describe in-flight work, not
    accumulated history."""
    registry.reset()


def _timeline_marker(name: str, category: str = "metrics", **args) -> None:
    """Instant marker in the active timeline, if any (metric events and
    traces tell one story); never raises into the instrumented hot path."""
    try:
        from horovod_tpu_torch import timeline as _tl
        t = _tl.get_timeline()
        if t is not None:
            t.marker(name, category=category, **args)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "horovod_tpu_"

#: ``# HELP`` text by metric family (pre-prefix name). Instrumentation
#: sites may add their own via :func:`set_help`; families without an entry
#: export with a ``# TYPE`` header only.
_HELP: Dict[str, str] = {
    "collective_calls_total": "Eager collective dispatches by kind.",
    "collective_bytes_total": "Payload bytes moved by eager collectives.",
    "collective_dispatch_seconds": "Host dispatch latency per collective.",
    "collective_compile_total": "First dispatches of a new program.",
    "collective_compile_seconds": "Trace + XLA compile latency.",
    "collective_traced_total": "In-jit collective lowerings (per trace).",
    "collective_arrival_spread_seconds":
        "First-to-last rank arrival spread per collective.",
    "negotiation_rounds_total": "Multi-process negotiation rounds by path.",
    "fusion_fill_ratio": "Fusion bucket fill vs HOROVOD_FUSION_THRESHOLD.",
    "stall_events_total": "Stall watchdog fires.",
    "world_size": "Devices in the global communicator.",
    "program_compiles_total": "Fingerprinted compilations per program.",
    "recompiles_total":
        "Signature-change recompilations per program (profiler.py).",
    "expected_recompiles_total":
        "Recompilations tagged by-design (autotuner rebuilds); the "
        "doctor skips these programs.",
    "recompile_blame_total":
        "Recompilations blamed on one argument's signature change.",
    "program_flops": "Executed FLOPs per call (XLA cost analysis).",
    "program_bytes_accessed": "HBM bytes accessed per call.",
    "program_peak_hbm_bytes": "Peak device memory of the compiled program.",
    "program_mfu": "Model-FLOPs utilization (analytic, remat-invariant).",
    "program_expected_mfu":
        "Doctor threshold: program_mfu below 0.8x this is a finding.",
    "program_hfu": "Hardware-FLOPs utilization (counts remat recompute).",
    "hbm_bandwidth_utilization": "Bytes-accessed rate over device HBM BW.",
    "program_step_seconds": "Observed (synced) step time per program.",
    "allreduce_algorithm_total":
        "Per-bucket allreduce lowerings by resolved algorithm "
        "(trace-time: one count per compiled bucket).",
    "allreduce_wire_bytes_total":
        "Bytes a compiled allreduce bucket puts on the wire per ring "
        "traversal, by algorithm and wire format (quantized wires count "
        "1-byte payload + fp32 block scales).",
    "allreduce_compression_ratio":
        "Bucket logical bytes over wire bytes for the last compiled "
        "bucket of each wire format (~3.9 for int8/fp8 vs fp32).",
    "config_allreduce_wire":
        "Resolved HOROVOD_ALLREDUCE_WIRE (one-hot over wire labels).",
    "memory_pressure_total": "Device HBM high-water crossings.",
    "serve_requests_total": "Serving requests by terminal status.",
    "serve_ttft_seconds": "Serving time-to-first-token.",
    "serve_tpot_seconds": "Serving time-per-output-token.",
    "prefix_cache_hit_rate":
        "Fraction of admissions that attached shared-prefix KV blocks "
        "from the radix index (per engine, since start).",
    "prefix_tokens_reused_total":
        "Prompt tokens served from the shared-prefix KV cache instead "
        "of being prefilled.",
    "kv_blocks_shared":
        "Paged KV blocks currently referenced by more than one holder "
        "(slot tables + prefix index).",
    "spec_tokens_proposed_total":
        "Draft tokens fed to the speculative verify lane by the "
        "proposer.",
    "spec_tokens_accepted_total":
        "Draft tokens accepted by the verify chain (equal to the "
        "model's own greedy picks).",
    "spec_acceptance_rate":
        "spec_tokens_accepted_total / spec_tokens_proposed_total "
        "(per engine, since start).",
    "serve_prompt_overlap_rate":
        "Fraction of admissions whose leading prompt chunk repeats an "
        "earlier admission — workload shareability, tracked whether or "
        "not the prefix cache is enabled.",
    "prefix_cache_evictions":
        "LRU evictions of index-only prefix blocks under pool "
        "pressure (per engine, since start).",
    "fleet_replicas":
        "Fleet supervisor replica counts by lifecycle state "
        "(live/starting/restarting/quarantined/spare).",
    "fleet_target_replicas": "Configured serving-fleet target size.",
    "fleet_restarts_total":
        "Replica restarts by typed reason (exit/unreachable/rolling).",
    "fleet_promotion_seconds":
        "Warm-spare promotion latency (death observed -> spare serving "
        "in the dead rank's slot).",
    "rolling_restart_seconds":
        "Per-replica drain+restart+readmit latency during "
        "fleet.rolling_restart().",
    "transport_membership_total":
        "RemoteDispatcher membership changes (join/readmit/leave).",
    "transport_stream_push_lag_seconds":
        "v2 stream wire: engine token callback -> frame on the socket.",
    "serve_queue_wait_seconds": "Serving submit -> admission wait.",
}


def set_help(name: str, text: str) -> None:
    """Register ``# HELP`` text for a metric family (one line; newlines
    and backslashes are escaped at export)."""
    _HELP[name] = str(text)


def _prom_name(name: str) -> str:
    return _PREFIX + _NAME_RE.sub("_", name)


def _help_escape(v: str) -> str:
    # Exposition format: HELP text escapes backslash and newline only
    # (quotes are literal there, unlike in label values).
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _family_header(lines: List[str], emitted: set, name: str,
                   mtype: str) -> bool:
    """``# HELP`` (when known) + ``# TYPE``, exactly once per family.
    Returns False when the family name was already exported under
    another kind (the same name registered as counter AND gauge): the
    caller must then skip that series entirely — a second sample set
    under one name is a duplicate timeseries, which scrapers reject."""
    pname = _prom_name(name)
    if pname in emitted:
        return False
    emitted.add(pname)
    if name in _HELP:
        lines.append(f"# HELP {pname} {_help_escape(_HELP[name])}")
    lines.append(f"# TYPE {pname} {mtype}")
    return True


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_NAME_RE.sub("_", k)}="{_escape(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _prom_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) and not v.is_integer() \
        else str(int(v))


def to_prometheus(snap: Optional[Dict[str, Any]] = None) -> str:
    """Render a snapshot in the Prometheus text exposition format
    (version 0.0.4: ``# HELP``/``# TYPE`` once per family, escaped label
    values, ``_bucket{le=...}`` cumulative histograms with
    ``_sum``/``_count``)."""
    snap = snap if snap is not None else snapshot()
    lines: List[str] = []
    emitted: set = set()
    for name, series in sorted(snap.get("counters", {}).items()):
        pname = _prom_name(name)
        if not _family_header(lines, emitted, name, "counter"):
            continue
        for s in series:
            lines.append(
                f"{pname}{_prom_labels(s['labels'])} {_prom_num(s['value'])}")
    for name, series in sorted(snap.get("gauges", {}).items()):
        pname = _prom_name(name)
        if not _family_header(lines, emitted, name, "gauge"):
            continue
        for s in series:
            lines.append(
                f"{pname}{_prom_labels(s['labels'])} {_prom_num(s['value'])}")
    for name, series in sorted(snap.get("histograms", {}).items()):
        pname = _prom_name(name)
        if not _family_header(lines, emitted, name, "histogram"):
            continue
        for s in series:
            for le, c in s["buckets"]:
                le_label = f'le="{_prom_num(le)}"'
                lines.append(
                    f"{pname}_bucket{_prom_labels(s['labels'], le_label)}"
                    f" {c}")
            lines.append(f"{pname}_sum{_prom_labels(s['labels'])}"
                         f" {repr(float(s['sum']))}")
            lines.append(f"{pname}_count{_prom_labels(s['labels'])}"
                         f" {s['count']}")
    return "\n".join(lines) + "\n"


def to_json(snap: Optional[Dict[str, Any]] = None) -> str:
    """Render a snapshot as JSON (round-trips through ``json.loads``)."""
    snap = snap if snap is not None else snapshot()
    return json.dumps({"timestamp": time.time(), **snap})


def collective_summary() -> Dict[str, Dict[str, Any]]:
    """Compact per-kind collective counters for bench/report embedding:
    ``{kind: {"calls": n, "bytes": b}}``."""
    snap = registry.snapshot()
    out: Dict[str, Dict[str, Any]] = {}
    for name, field in (("collective_calls_total", "calls"),
                        ("collective_bytes_total", "bytes"),
                        ("collective_traced_total", "traced_lowerings")):
        for s in snap["counters"].get(name, []):
            kind = s["labels"].get("kind", "unknown")
            out.setdefault(kind, {})[field] = int(s["value"])
    return out


# ---------------------------------------------------------------------------
# background snapshot flusher (HOROVOD_METRICS_FILE / HOROVOD_METRICS_INTERVAL)
# ---------------------------------------------------------------------------

_FLUSHER_LOCK = threading.Lock()
_FLUSHER: Optional["_Flusher"] = None
_ATEXIT_REGISTERED = False
_ATEXIT_DRAINS: List[Callable[[], None]] = []


def register_atexit_drain(fn: Callable[[], None]) -> None:
    """Register ``fn`` with the shared interpreter-exit drain (one
    ``atexit`` hook for the whole metrics plane). The flusher's final
    write registers here (the reference's health plane registers its
    threads the same way). Idempotent per function; drains run in
    registration order and an exception in one never skips the rest."""
    global _ATEXIT_REGISTERED
    with _FLUSHER_LOCK:
        if fn not in _ATEXIT_DRAINS:
            _ATEXIT_DRAINS.append(fn)
        if not _ATEXIT_REGISTERED:
            import atexit
            atexit.register(_run_atexit_drains)
            _ATEXIT_REGISTERED = True


def _run_atexit_drains() -> None:
    with _FLUSHER_LOCK:
        drains = list(_ATEXIT_DRAINS)
    for fn in drains:
        try:
            fn()
        except Exception:
            logger.exception("atexit drain %r failed", fn)


def _drain_flusher_at_exit() -> None:
    """Interpreter-exit drain: short-lived processes (serving replicas,
    one-shot bench runs) that never call ``hvd.shutdown()`` must still
    land their FINAL snapshot — without this, a process whose lifetime
    is shorter than ``HOROVOD_METRICS_INTERVAL`` exports nothing at
    all. Mirrors the timeline's atexit flush (``timeline.init_timeline``)."""
    stop_metrics_flusher(final_write=True)


class _Flusher:
    def __init__(self, path: str, interval_s: float):
        self.path = path
        self.interval_s = max(0.05, float(interval_s))
        # Format follows the extension: .prom/.txt scrape as Prometheus
        # textfile-collector input, anything else is JSON.
        self._prom = path.endswith((".prom", ".txt"))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-metrics-flusher", daemon=True)
        self._thread.start()

    def write(self) -> None:
        # Everything inside the guard: an export error (e.g. a user-held
        # metric fed an unserializable value) must log and skip this
        # flush, not silently kill the thread for the rest of the run.
        try:
            payload = to_prometheus() if self._prom else to_json()
            # pid + thread id: stop()'s final write must never share a tmp
            # file with a loop write that outlived the join timeout.
            tmp = (f"{self.path}.tmp.{os.getpid()}"
                   f".{threading.get_ident()}")
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)   # atomic: scrapers never see torn
        except Exception:
            logger.exception("metrics flush to %s failed", self.path)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.write()

    def stop(self, final_write: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if final_write:
            self.write()


def start_metrics_flusher(path: Optional[str] = None,
                          interval_s: Optional[float] = None) -> None:
    """Start (or retarget) the background snapshot writer. Defaults come
    from ``HOROVOD_METRICS_FILE`` / ``HOROVOD_METRICS_INTERVAL`` via
    :mod:`horovod_tpu_torch.config`; idempotent for an unchanged target."""
    global _FLUSHER
    from horovod_tpu_torch import core
    from horovod_tpu_torch.config import get_config
    cfg = get_config()
    path = path or cfg.metrics_file
    if not path:
        raise ValueError("pass a path or set HOROVOD_METRICS_FILE")
    interval_s = interval_s if interval_s is not None \
        else cfg.metrics_interval_seconds
    if core.is_initialized() and core.size() > 1:
        # One registry per process: every rank writing the SAME file
        # would have scrapers read whichever rank flushed last. Fan the
        # path out per rank (metrics.json -> metrics.r3.json).
        root, ext = os.path.splitext(path)
        path = f"{root}.r{core.rank()}{ext}"
    with _FLUSHER_LOCK:
        if _FLUSHER is not None:
            if (_FLUSHER.path == path
                    and _FLUSHER.interval_s == max(0.05, float(interval_s))):
                return
            _FLUSHER.stop(final_write=False)
        _FLUSHER = _Flusher(path, interval_s)
    register_atexit_drain(_drain_flusher_at_exit)


def stop_metrics_flusher(final_write: bool = True) -> None:
    global _FLUSHER
    with _FLUSHER_LOCK:
        if _FLUSHER is not None:
            _FLUSHER.stop(final_write=final_write)
            _FLUSHER = None


# ---------------------------------------------------------------------------
# pending-collective table + stall watchdog
# ---------------------------------------------------------------------------

_PENDING_LOCK = threading.Lock()
_PENDING: Dict[int, Dict[str, Any]] = {}
_PENDING_SEQ = itertools.count(1)


def collective_begin(kind: str, name: Optional[str] = None, nbytes: int = 0,
                     ranks: Optional[tuple] = None,
                     op_id: Optional[int] = None) -> int:
    """Register an in-flight collective (negotiation + dispatch window);
    returns a token for :func:`collective_end`. The stall watchdog reads
    this table. ``op_id`` is the span context minted at enqueue — the same
    id the timeline phases and merged trace carry."""
    tok = next(_PENDING_SEQ)
    entry = {"token": tok, "kind": kind,
             "tensor": name if name else f"{kind}#{tok}",
             "bytes": int(nbytes),
             "ranks": None if ranks is None else tuple(ranks),
             "op_id": op_id,
             "start": time.monotonic(), "fired": False}
    with _PENDING_LOCK:
        _PENDING[tok] = entry
    return tok


def collective_end(token: int) -> None:
    with _PENDING_LOCK:
        _PENDING.pop(token, None)


def pending_collectives(older_than_s: float = 0.0) -> List[Dict[str, Any]]:
    """Snapshot of in-flight collectives pending longer than
    ``older_than_s`` seconds: tensor, kind, process set, age, bytes."""
    now = time.monotonic()
    out = []
    with _PENDING_LOCK:
        entries = list(_PENDING.values())
    for e in entries:
        age = now - e["start"]
        if age >= older_than_s:
            out.append({"tensor": e["tensor"], "kind": e["kind"],
                        "process_set": ("global" if e["ranks"] is None
                                        else list(e["ranks"])),
                        "pending_s": age, "bytes": e["bytes"],
                        "op_id": e.get("op_id")})
    return out


class StallWatchdog:
    """Monitor thread that fires when any collective stays pending longer
    than ``timeout_s`` (default ``HOROVOD_STALL_CHECK_TIME_SECONDS``).

    Covers every eager collective on every path: each fire produces a
    report dict naming the ``tensor``, the ``process_set``, and the
    ``waiting_ranks``, invokes
    ``on_stall(report)``, logs a warning, bumps ``stall_events_total``, and
    drops an instant marker into the active timeline. One fire per stuck
    op; a new op stalls afresh.
    """

    def __init__(self, timeout_s: Optional[float] = None,
                 on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
                 poll_s: float = 1.0):
        if timeout_s is None:
            from horovod_tpu_torch.config import get_config
            timeout_s = get_config().stall_check_time_seconds
        self.timeout_s = float(timeout_s)
        self._on_stall = on_stall
        self._poll_s = poll_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-stall-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def check_once(self) -> List[Dict[str, Any]]:
        """One scan (also what the thread runs every ``poll_s``); returns
        the reports fired this scan — callable directly from tests or a
        training loop without the thread."""
        fired: List[Dict[str, Any]] = []
        now = time.monotonic()
        with _PENDING_LOCK:
            entries = [e for e in _PENDING.values()
                       if not e["fired"] and now - e["start"] > self.timeout_s]
            for e in entries:
                e["fired"] = True
        late = self._likely_late_processes()
        for e in entries:
            report = {
                "tensor": e["tensor"], "kind": e["kind"],
                "op_id": e.get("op_id"),
                "process_set": ("global" if e["ranks"] is None
                                else list(e["ranks"])),
                "waiting_ranks": self._waiting_ranks(e["ranks"]),
                "likely_late_processes": late,
                "pending_s": now - e["start"], "bytes": e["bytes"],
            }
            fired.append(report)
            self._fire(report)
        # The reference also reads its native coordinator's stall table
        # here; the port has no native coordinator yet (ROADMAP.md §A).
        return fired

    def _likely_late_processes(self):
        """Which PROCESSES (ranks: one process drives one device here, so
        the negotiation participants are the ranks) have been arriving late recently, from the arrival
        waits negotiation rounds piggyback — the attribution half of a
        stall report: the waiting ranks say who is stuck, the late
        processes say which host to look at. Only a RECENT record is trusted: the piggyback
        covers completed rounds, so during a long stall the newest record
        predates the stuck op and naming its late ranks would misdirect."""
        try:
            from horovod_tpu_torch.collective import negotiation_arrival_stats
            stats = negotiation_arrival_stats(1)
            if not stats:
                return None
            rec = stats[-1]
            age = time.monotonic() - rec.get("ts", 0.0)
            if age > max(60.0, 2 * self.timeout_s):
                return None
            return rec["late_processes"]
        except Exception:
            return None

    @staticmethod
    def _waiting_ranks(ranks: Optional[tuple]):
        """Best effort: the member ranks the pending op is still
        synchronizing with (per-rank completion is not observable from one
        host: NCCL owns the device schedule)."""
        if ranks is not None:
            return list(ranks)
        try:
            from horovod_tpu_torch import core
            return list(range(core.size())) if core.is_initialized() else None
        except Exception:
            return None

    def _fire(self, report: Dict[str, Any]) -> None:
        self.stall_count += 1
        registry.counter("stall_events_total").inc()
        logger.warning(
            "horovod_tpu_torch: collective stalled: %s %r pending %.1fs on "
            "process set %s (waiting ranks: %s, likely late processes: %s, "
            "%d bytes)",
            report["kind"], report["tensor"], report["pending_s"],
            report["process_set"], report["waiting_ranks"],
            report.get("likely_late_processes"), report["bytes"])
        _timeline_marker("collective_stall", **{
            k: v for k, v in report.items() if k != "pending_s"},
            pending_s=round(report["pending_s"], 3))
        if self._on_stall is not None:
            try:
                self._on_stall(report)
            except Exception:
                logger.exception("stall callback failed")
        # HOROVOD_PROFILE_ON_STALL=1: one bounded capture of the stalled
        # window (the profiler gates on the knob and its own budget).
        try:
            from horovod_tpu_torch import profiler as _profiler
            _profiler.maybe_trigger(
                f"stall_{report['kind']}_{report['tensor']}")
        except Exception:
            pass
        # The flight recorder: ring the stall and publish a postmortem
        # bundle (HOROVOD_BLACKBOX_DUMP_ON gates it, debounced).
        try:
            from horovod_tpu_torch import blackbox as _blackbox
            _blackbox.on_stall(report)
        except Exception:
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            self.check_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


_WATCHDOG_LOCK = threading.Lock()
_WATCHDOG: Optional[StallWatchdog] = None


def start_stall_watchdog(timeout_s: Optional[float] = None,
                         on_stall: Optional[Callable] = None,
                         poll_s: float = 1.0) -> StallWatchdog:
    """Start (or return) the process-global stall watchdog. ``init()``
    calls this (argument-free) unless ``HOROVOD_STALL_CHECK_DISABLE`` is
    set. Calling again with explicit ``timeout_s``/``on_stall`` REPLACES
    the running instance — the auto-started default must not silently
    swallow a user's tighter timeout or alerting callback."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            if timeout_s is None and on_stall is None:
                return _WATCHDOG
            _WATCHDOG.stop()
            _WATCHDOG = None
        _WATCHDOG = StallWatchdog(timeout_s=timeout_s,
                                  on_stall=on_stall,
                                  poll_s=poll_s).start()
        return _WATCHDOG


def stop_stall_watchdog() -> None:
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None:
            _WATCHDOG.stop()
            _WATCHDOG = None


def get_stall_watchdog() -> Optional[StallWatchdog]:
    return _WATCHDOG


# ---------------------------------------------------------------------------
# lifecycle hooks (called by core.init / core.shutdown)
# ---------------------------------------------------------------------------

def on_init(cfg, init_seconds: float, world: int) -> None:
    registry.counter("init_total").inc()
    registry.histogram("init_seconds").observe(init_seconds)
    registry.gauge("world_size").set(world)
    _timeline_marker("init", world=world,
                     init_s=round(init_seconds, 4))
    if cfg.metrics_file:
        start_metrics_flusher(cfg.metrics_file, cfg.metrics_interval_seconds)
    if not cfg.stall_check_disable:
        # Argument-free: StallWatchdog reads HOROVOD_STALL_CHECK_TIME_*
        # itself, and a user's later explicit start_stall_watchdog(...)
        # must win over this auto-start.
        start_stall_watchdog()


def on_shutdown() -> None:
    registry.counter("shutdown_total").inc()
    stop_stall_watchdog()
    stop_metrics_flusher(final_write=True)


# ---------------------------------------------------------------------------
# live scrape endpoint (hvd.metrics_http)
# ---------------------------------------------------------------------------

class MetricsHTTPServer:
    """Tiny stdlib HTTP endpoint for live scraping (the reference's,
    ``horovod_tpu/metrics.py:935``).

    ``GET /metrics`` (and ``/``) returns :func:`to_prometheus` (text
    exposition 0.0.4) -- what Prometheus scrapes instead of tailing
    ``HOROVOD_METRICS_FILE``. ``GET /metrics.json`` is the same snapshot as
    :func:`to_json`. ``GET /trace`` returns the request-trace span buffer
    as a Chrome-trace document (empty ``traceEvents`` until request
    tracing is ported, ROADMAP.md section A item 10). ``GET /healthz``
    answers 200/503 from the health plane's alerts (``{"status": "ok",
    "ok": true, "alerts": []}`` until it is ported, item 9c-ii-b). ``GET
    /config`` serves ``confbus.config_view()`` (the epoch, the resolved
    values with the auth token as a boolean, the overrides, the mutable and
    shape-affecting knobs, open experiments and the ledger's tail; ``{"epoch":
    0, "values": {}}`` should the bus fail to import); ``POST /config``
    applies one ``confbus.set_config`` mutation (``{"name", "value",
    "reason"}``, origin ``http``), gated on ``HOROVOD_SERVE_AUTH_TOKEN``:
    403 with no token configured, 401 on a mismatch, 400 on a malformed
    body, 200 with the typed result for an applied, refused, rejected or
    unknown knob, 500 should the bus raise. The token is never echoed.
    ``GET /doctor`` serves the health plane's last windowed report, or
    while that plane is not ported (item 9c-ii-b) a one-shot
    ``profiler.doctor()``. Unknown
    paths 404. Requests are
    not logged. Serves on daemon threads that read the registry only;
    :meth:`stop` shuts it down."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:           # noqa: N802 -- stdlib API
                path = self.path.split("?", 1)[0]
                code = 200
                if path in ("/metrics", "/"):
                    body = to_prometheus().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = to_json().encode("utf-8")
                    ctype = "application/json"
                elif path == "/trace":
                    try:
                        from horovod_tpu_torch.serving import reqtrace
                        evs = reqtrace.events()
                    except Exception:
                        evs = []
                    body = json.dumps(
                        {"traceEvents": evs, "displayTimeUnit": "ms"},
                        default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/doctor":
                    try:
                        from horovod_tpu_torch import health as _health
                        rep = _health.last_report()
                    except Exception:
                        rep = None
                    if rep is None:
                        from horovod_tpu_torch import profiler as _profiler
                        rep = _profiler.doctor()
                    body = json.dumps(rep, default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    try:
                        from horovod_tpu_torch import health as _health
                        verdict = _health.healthz()
                    except Exception:
                        verdict = {"status": "ok", "ok": True, "alerts": []}
                    code = 200 if verdict.get("ok", True) else 503
                    body = json.dumps(verdict, default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/config":
                    try:
                        from horovod_tpu_torch import confbus
                        view = confbus.config_view()
                    except Exception:
                        view = {"epoch": 0, "values": {}}
                    body = json.dumps(view, default=str).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self) -> None:          # noqa: N802 -- stdlib API
                path = self.path.split("?", 1)[0]
                if path != "/config":
                    self.send_error(404)
                    return
                # Mutations over HTTP are gated on the shared secret: no
                # token configured means the write surface is OFF (403),
                # and a mismatched token is 401. The token value itself
                # is never echoed in any reply.
                import hmac as _hmac
                from horovod_tpu_torch.config import get_config as _cfg
                token = _cfg().serve_auth_token
                if not token:
                    self._reply(403, {
                        "ok": False,
                        "error": "POST /config disabled: no "
                                 "HOROVOD_SERVE_AUTH_TOKEN configured"})
                    return
                got = self.headers.get("X-Auth-Token", "")
                if not _hmac.compare_digest(got, token):
                    self._reply(401, {"ok": False,
                                      "error": "bad auth token"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, OSError):
                    self._reply(400, {"ok": False,
                                      "error": "malformed JSON body"})
                    return
                try:
                    from horovod_tpu_torch import confbus
                    res = confbus.set_config(
                        str(req.get("name")), req.get("value"),
                        reason=str(req.get("reason") or ""),
                        origin="http")
                except Exception as e:   # noqa: BLE001 -- typed reply
                    self._reply(500, {"ok": False,
                                      "error": f"set_config: {e!r}"})
                    return
                # Refusals/rejections are 200s with the typed result --
                # policy answers, not HTTP failures.
                self._reply(200, res)

            def _reply(self, code: int, doc) -> None:
                body = json.dumps(doc, default=str).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass                            # scrapes are not stderr news

            def log_error(self, *args) -> None:
                pass                            # 404s included: a collector
                                                # probing a restarting
                                                # process is routine

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=f"hvd-metrics-http-{self.port}")
        self._thread.start()

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)


def metrics_http(port: int = 0, host: str = "127.0.0.1", *,
                 fallback_ports: int = 0) -> MetricsHTTPServer:
    """Start the live scrape endpoint (``hvd.metrics_http``).

    ``port=0`` binds an ephemeral port (the server object's ``.port``
    says which). ``fallback_ports=k`` retries ``port+1 .. port+k`` when
    the requested port is taken, so co-hosted processes under one port
    base do not collide. Raises ``OSError`` when nothing in the range
    binds."""
    last: Optional[OSError] = None
    for p in range(port, port + max(0, int(fallback_ports)) + 1):
        try:
            return MetricsHTTPServer(p, host)
        except OSError as e:
            last = e
            if port == 0:
                break
    raise last if last is not None else OSError("metrics_http: no port")


# ``hvd.metrics`` must be BOTH this submodule (so ``from
# horovod_tpu_torch.metrics import ...`` works everywhere) and the upstream-style ``hvd.metrics()``
# snapshot call. Making the module callable avoids shadowing the submodule
# attribute with a function — which would silently break any later
# ``import horovod_tpu_torch.metrics as m`` (getattr on the package would win and
# return the function).
import sys as _sys


class _CallableModule(type(_sys.modules[__name__])):
    def __call__(self, *args, **kwargs):
        return snapshot(*args, **kwargs)


_sys.modules[__name__].__class__ = _CallableModule
