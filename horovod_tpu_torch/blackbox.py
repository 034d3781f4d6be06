"""Flight recorder and postmortem plane.

Port of ``horovod_tpu/blackbox.py``, whole. When a rank actually dies,
everything that explains *why* normally dies with it: the live span
buffer, the in-memory metrics window, the registry fingerprints, the
thread stacks. This module is the black box that survives the crash --
the diagnose leg of detect -> diagnose -> recover.

Three pieces:

* :class:`FlightRecorder` -- byte- AND age-bounded rings of the last
  ``HOROVOD_BLACKBOX_SECONDS`` of everything the existing layers already
  produce: timeline events (a tap inside ``Timeline._emit``), registry
  snapshots on an interval (``timeseries.LocalSampler`` with an
  ``on_sample`` callback), alert fire/clear records, fault injections and
  fleet slot transitions. The request-trace span buffer
  (``serving/reqtrace``, not ported yet: ROADMAP.md section A item 10) is
  read at dump time, so until then a bundle has no request shard.

* :meth:`FlightRecorder.dump` -- atomically publishes a
  ``postmortem-<label>-<ts>/`` bundle: ``manifest.json``, the metrics
  window re-shaped via ``TimeSeriesStore.window_snapshot()`` (the exact
  shape the offline doctor eats), raw sampled snapshots, a trace-tail
  shard that ``trace_merge`` accepts unchanged (rebuilt from the timeline
  ring), the alerts tail (rotation-aware), faulthandler-style all-thread
  stacks, and the resolved config (secrets redacted: the
  ``serve_auth_token`` value never reaches the disk). Dumps fire on fatal
  signals (SIGTERM / SIGABRT and ``sys.excepthook``), a StallWatchdog
  fire, an alert fire above a severity threshold, an engine death, a
  fault-plan kill, and explicitly via ``hvd.dump_postmortem()`` -- each
  gated by ``HOROVOD_BLACKBOX_DUMP_ON``, debounced, re-entrancy-guarded,
  and counted in ``blackbox_dumps_total{trigger}``. Retention is bounded:
  at most ``HOROVOD_BLACKBOX_MAX_BUNDLES`` bundles, oldest evicted first.

* :func:`postmortem_report` -- the offline consumer (CLI:
  ``tools/torch_postmortem.py``): load a bundle, run the offline doctor
  (``profiler.doctor``) over its windowed snapshot, merge its trace tail,
  and emit a ranked root-cause report ("rank 0 kill; last event FAULT
  kill@rank=0,step=3").

``note_config`` records the config bus's mutations and experiment
verdicts (``confbus.py``). ``note_fleet``, ``on_alert`` and
``on_engine_death`` are whole and have no caller in the port yet: the
health plane (ROADMAP.md section A item 9c-ii-b) and serving (item 10)
bring them.

Signal-safety contract: ``dump()`` must complete even while another
thread holds the metrics registry lock (a Python signal handler runs on
the main thread and may interrupt a scrape mid-snapshot). Everything the
bundle needs is pre-sampled into recorder-owned structures with their
own short-lived locks; the *optional* final registry sample and the
``blackbox_dumps_total`` bump probe ``registry._lock`` with a timeout
and are skipped / deferred to a daemon thread when the probe fails.
A Python signal handler runs between bytecodes of the main thread: one
that arrives during a long CUDA call waits for the call to return.

Importing this module starts no thread; nothing is armed unless
``HOROVOD_BLACKBOX`` is set.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import signal
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

logger = logging.getLogger("horovod_tpu_torch.blackbox")

__all__ = [
    "FlightRecorder", "Ring", "get", "ensure", "set_identity",
    "on_init", "on_shutdown", "note_fault", "note_fleet", "note_config",
    "on_alert",
    "on_stall", "on_engine_death", "dump_postmortem", "read_alerts_tail",
    "find_bundles", "postmortem_report", "format_postmortem",
]

#: automatic triggers an alert must reach to dump (alert *fires* below
#: this severity still land in the ring/tail, they just don't publish).
ALERT_DUMP_SEVERITY = 0.8

#: minimum spacing between automatic dumps (stall/alert/engine/fleet) —
#: a flapping alert must not churn the bundle dir. Death-path triggers
#: (signal/except/fault) and explicit dumps are never debounced.
AUTO_DUMP_MIN_INTERVAL_S = 10.0

#: triggers that bypass the debounce: the process is about to die (or a
#: human asked) — this is the last chance to publish.
_FORCE_TRIGGERS = frozenset({"signal", "except", "fault", "manual", "fleet"})

#: trigger -> HOROVOD_BLACKBOX_DUMP_ON token gating it (manual/fleet
#: dumps are always allowed: an explicit request is its own opt-in).
_TRIGGER_TOKEN = {"signal": "signal", "except": "signal", "stall": "stall",
                  "alert": "alert", "engine": "engine", "fault": "fault"}

#: how long dump() may wait for the registry lock before skipping the
#: final live sample / deferring the dumps-total bump off-thread.
_REGISTRY_PROBE_S = 0.25

_BUNDLE_RE = re.compile(r"^postmortem-.+-\d{8}-\d{6}-\d{3}$")


def _default_dir() -> str:
    import tempfile
    return os.path.join(tempfile.gettempdir(), "horovod_blackbox")


def _sanitize(label: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", label.strip()) or "proc"


# ---------------------------------------------------------------------------
# bounded ring
# ---------------------------------------------------------------------------

class Ring:
    """Byte- and age-bounded event ring.

    Eviction is strict oldest-first while EITHER bound is exceeded — an
    event storm can never grow the ring past ``max_bytes``, and a quiet
    ring drains to nothing past ``max_age_s`` (``items()`` prunes too,
    so stale events never leak into a bundle)."""

    def __init__(self, max_bytes: int, max_age_s: float):
        self.max_bytes = max(0, int(max_bytes))
        self.max_age_s = float(max_age_s)
        self._dq: deque = deque()      # (ts, nbytes, item)
        self._bytes = 0
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, item: Any, ts: Optional[float] = None,
               nbytes: Optional[int] = None) -> None:
        ts = time.time() if ts is None else float(ts)
        nb = len(str(item)) if nbytes is None else int(nbytes)
        with self._lock:
            self._dq.append((ts, nb, item))
            self._bytes += nb
            self._prune_locked(ts)

    def _prune_locked(self, now: float) -> None:
        dq = self._dq
        while dq and (self._bytes > self.max_bytes
                      or now - dq[0][0] > self.max_age_s):
            _, nb, _ = dq.popleft()
            self._bytes -= nb
            self.dropped += 1

    def items(self, now: Optional[float] = None) -> List[Any]:
        """Age-pruned snapshot of the ring, oldest first."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self._prune_locked(now)
            return [item for _, _, item in self._dq]

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._dq)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """The black box: bounded rings + the dump that publishes them.

    Per-ring byte budgets are fixed (the *age* bound is the knob): the
    recorder's whole memory footprint is a few MB regardless of event
    rate, which is what lets it stay always-on next to a serving engine.
    """

    TIMELINE_RING_BYTES = 2 << 20
    SNAPSHOT_RING_BYTES = 8 << 20
    EVENTS_RING_BYTES = 512 << 10

    def __init__(self, cfg=None):
        if cfg is None:
            from horovod_tpu_torch.config import get_config
            cfg = get_config()
        from horovod_tpu_torch.timeseries import LocalSampler, TimeSeriesStore
        self.seconds = float(cfg.blackbox_seconds)
        self.root = cfg.blackbox_dir or _default_dir()
        self.max_bundles = int(cfg.blackbox_max_bundles)
        self.dump_on = frozenset(
            t for t in cfg.blackbox_dump_on.split(",") if t)
        self.rank: Optional[int] = None
        self.world: Optional[int] = None
        # Registry snapshots ride twice: the TimeSeriesStore gives the
        # bundle its doctor-ready window_snapshot(); the raw ring gives
        # the offline analyzer the per-tick series to compute trends
        # ("queue depth rising Ns before death") without re-deriving
        # the store's reset-awareness.
        self.store = TimeSeriesStore(max_age_s=max(60.0, 2 * self.seconds))
        self.snapshots = Ring(self.SNAPSHOT_RING_BYTES, self.seconds)
        self.timeline_ring = Ring(self.TIMELINE_RING_BYTES, self.seconds)
        self.events = Ring(self.EVENTS_RING_BYTES, self.seconds)
        self.sampler = LocalSampler(
            self.store,
            interval_s=min(2.0, max(0.25, self.seconds / 60.0)),
            on_sample=self._on_sample)
        #: re-entrancy token — a dump fired while another dump is mid-
        #: publish (alert storm racing a signal handler) is REFUSED, not
        #: queued: the bundle being written already has the evidence.
        self._dump_gate = threading.Lock()
        self._last_auto = 0.0
        self._started = False
        self._hooks_installed = False
        self._prev_excepthook = None
        self._prev_handlers: Dict[int, Any] = {}
        self._faulthandler_file = None
        self.last_bundle: Optional[str] = None

    # -- feeds -------------------------------------------------------------

    def _on_sample(self, snap: Dict[str, Any], ts: float) -> None:
        line = json.dumps({"ts": ts, "snapshot": snap}, default=str)
        self.snapshots.append(line, ts=ts, nbytes=len(line))

    def _tap_timeline(self, ev: Dict[str, Any]) -> None:
        self.timeline_ring.append(ev)

    def note(self, type_: str, **fields: Any) -> None:
        """Append one structured record to the events ring (fault
        injections, fleet transitions, alert lifecycle, engine deaths)."""
        rec = {"ts": time.time(), "type": type_, **fields}
        self.events.append(rec, ts=rec["ts"])

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FlightRecorder":
        if self._started:
            return self
        self._started = True
        from horovod_tpu_torch import timeline
        timeline.add_tap(self._tap_timeline)
        try:
            # One sample up front: a worker that crash-loops within its
            # first sampler tick still gets a registry snapshot into its
            # bundle.
            self.sampler.sample_once()
        except Exception:
            pass
        self.sampler.start()
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        from horovod_tpu_torch import timeline
        timeline.remove_tap(self._tap_timeline)
        self.sampler.stop()

    def install_crash_hooks(self) -> None:
        """Fatal-signal (SIGTERM/SIGABRT) + ``sys.excepthook`` dump
        triggers, installed from ``hvd.init()`` (main thread only —
        ``signal.signal`` raises elsewhere, and then only the excepthook
        lands)."""
        if self._hooks_installed or "signal" not in self.dump_on:
            return
        self._hooks_installed = True
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        for sig in (signal.SIGTERM, signal.SIGABRT):
            try:
                self._prev_handlers[sig] = signal.signal(
                    sig, self._on_fatal_signal)
            except (ValueError, OSError):    # not the main thread
                pass

    def install_faulthandler(self) -> None:
        """Stdlib ``faulthandler`` pointed at the blackbox dir: SIGSEGV /
        native crashes leave all-thread stacks even when no Python-level
        dump path can run."""
        if self._faulthandler_file is not None:
            return
        import faulthandler
        try:
            os.makedirs(self.root, exist_ok=True)
            self._faulthandler_file = open(
                os.path.join(self.root, f"faulthandler-{os.getpid()}.log"),
                "w")
            faulthandler.enable(file=self._faulthandler_file)
        except OSError:
            self._faulthandler_file = None

    def _excepthook(self, exc_type, exc, tb) -> None:
        try:
            self.dump(trigger="except",
                      note=f"{exc_type.__name__}: {exc}")
        except Exception:
            pass
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_fatal_signal(self, signum, frame) -> None:
        try:
            self.dump(trigger="signal", note=f"signal {signum}")
        except Exception:
            pass
        # Preserve the kill semantics the sender expects (launchers
        # verify the SIGTERM exit status): a chained Python handler runs,
        # otherwise re-deliver under the default disposition.
        prev = self._prev_handlers.get(signum)
        if callable(prev):
            prev(signum, frame)
            return
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    # -- dump --------------------------------------------------------------

    def dump(self, trigger: str = "manual", label: Optional[str] = None,
             note: Optional[str] = None) -> Optional[str]:
        """Publish one postmortem bundle; returns its path.

        Returns ``None`` when refused: trigger not in
        ``HOROVOD_BLACKBOX_DUMP_ON``, another dump in flight (re-entrancy
        token), or an automatic trigger inside the debounce window."""
        token = _TRIGGER_TOKEN.get(trigger)
        if token is not None and token not in self.dump_on:
            return None
        if not self._dump_gate.acquire(blocking=False):
            return None
        try:
            now = time.time()
            if trigger not in _FORCE_TRIGGERS \
                    and now - self._last_auto < AUTO_DUMP_MIN_INTERVAL_S:
                return None
            self._last_auto = now
            path = self._publish(trigger, label, note, now)
        except Exception:
            logger.exception("blackbox: dump failed (trigger=%s)", trigger)
            return None
        finally:
            self._dump_gate.release()
        self._count_dump(trigger)
        self._retain()
        self.last_bundle = path
        logger.warning("blackbox: postmortem bundle published: %s "
                       "(trigger=%s)", path, trigger)
        return path

    def _publish(self, trigger: str, label: Optional[str],
                 note: Optional[str], now: float) -> str:
        if label is None:
            label = f"rank{self.rank}" if self.rank is not None \
                else f"pid{os.getpid()}"
        label = _sanitize(label)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
        name = f"postmortem-{label}-{stamp}-{int(now * 1000) % 1000:03d}"
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, f".tmp-{name}.{os.getpid()}")
        final = os.path.join(self.root, name)
        os.makedirs(tmp, exist_ok=True)

        # Final live registry sample — PROBE the registry lock: a signal
        # handler may have interrupted the very thread that holds it, and
        # blocking here would deadlock the death path. On timeout the
        # bundle simply ends at the sampler's last tick.
        sampled_final = self._probe_registry_sample(now)

        files: List[str] = []

        def _write(rel: str, payload: str) -> None:
            with open(os.path.join(tmp, rel), "w") as f:
                f.write(payload)
            files.append(rel)

        snap_lines = self.snapshots.items(now=now)
        _write("snapshots.jsonl", "".join(s + "\n" for s in snap_lines))
        _write("metrics.window.json", json.dumps(
            self.store.window_snapshot(self.seconds, now=now), default=str))
        self._write_trace_tail(tmp, files, now)
        _write("events.jsonl", "".join(
            json.dumps(e, default=str) + "\n"
            for e in self.events.items(now=now)))
        _write("alerts.tail.jsonl", "".join(
            json.dumps(a, default=str) + "\n"
            for a in self._alerts_tail(now)))
        _write("stacks.txt", _all_thread_stacks())
        _write("config.json", json.dumps(self._config_dict(), default=str))
        manifest = {
            "schema": 1, "trigger": trigger, "note": note or "",
            "label": label, "ts": now,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(now)),
            "pid": os.getpid(), "host": socket.gethostname(),
            "rank": self.rank, "world": self.world,
            "window_seconds": self.seconds,
            "snapshots": len(snap_lines), "events": len(self.events),
            "timeline_events": len(self.timeline_ring),
            "sampled_final": sampled_final,
            "files": sorted(files) + ["manifest.json"],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, default=str)
        try:
            os.replace(tmp, final)
        except OSError:
            # Same-millisecond collision with another process's bundle:
            # retry once under a pid-suffixed name rather than losing
            # the evidence.
            final = f"{final}-{os.getpid()}"
            os.replace(tmp, final)
        return final

    def _probe_registry_sample(self, now: float) -> bool:
        from horovod_tpu_torch import metrics
        if not metrics.registry._lock.acquire(timeout=_REGISTRY_PROBE_S):
            return False
        metrics.registry._lock.release()
        try:
            self.sampler.sample_once(ts=now)
        except Exception:
            return False
        return True

    def _write_trace_tail(self, tmp: str, files: List[str],
                          now: float) -> None:
        """Trace-tail shards ``trace_merge`` accepts unchanged: a rank
        shard rebuilt from the timeline ring (``shard_meta`` carries
        rank/world so ``_shard_rank`` labels the track) and the request
        span buffer via its own shard writer."""
        trace_dir = os.path.join(tmp, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        evs = self.timeline_ring.items(now=now)
        if evs:
            rank = self.rank if self.rank is not None else 0
            pid = os.getpid()
            head = [
                {"name": "process_name", "cat": "__metadata", "ph": "M",
                 "ts": 0.0, "pid": pid, "tid": 0,
                 "args": {"name": f"rank {rank}"}},
                {"name": "shard_meta", "cat": "trace", "ph": "i",
                 "ts": 0.0, "pid": pid, "tid": 0, "s": "g",
                 "args": {"rank": rank, "world": self.world or 1,
                          "dropped": self.timeline_ring.dropped}},
            ]
            rel = os.path.join("trace", f"trace.rank{rank}.json")
            with open(os.path.join(tmp, rel), "w") as f:
                json.dump({"traceEvents": head + evs,
                           "displayTimeUnit": "ms"}, f, default=str)
            files.append(rel)
        try:
            # The request span buffer: serving is ROADMAP.md section A
            # item 10, so until it is ported this import fails and the
            # bundle has no request shard.
            from horovod_tpu_torch.serving import reqtrace
            out = reqtrace.flush(
                os.path.join(trace_dir, reqtrace.shard_basename()))
            if out:
                files.append(os.path.join("trace", os.path.basename(out)))
        except Exception:
            pass

    def _alerts_tail(self, now: float) -> List[Dict[str, Any]]:
        """The bundle's alerts tail: the rotation-aware file reader when
        ``HOROVOD_HEALTH_ALERTS_FILE`` is configured (it has the full
        lifecycle including pre-recorder history), else the alert records
        captured in the events ring."""
        try:
            from horovod_tpu_torch.config import get_config
            path = get_config().health_alerts_file
        except Exception:
            path = None
        if path:
            tail = read_alerts_tail(path)
            if tail:
                return tail
        return [e for e in self.events.items(now=now)
                if e.get("type") == "alert"]

    def _config_dict(self) -> Dict[str, Any]:
        try:
            from horovod_tpu_torch.config import get_config
            out = _redacted(get_config())
        except Exception:
            out = {}
        try:
            from horovod_tpu_torch import core
            if core.is_initialized():
                out["build_info"] = core.build_info()
        except Exception:
            pass
        return out

    def _count_dump(self, trigger: str) -> None:
        """``blackbox_dumps_total{trigger}`` — deferred to a daemon
        thread when the registry lock probe fails (see module
        docstring)."""
        from horovod_tpu_torch import metrics

        def inc() -> None:
            metrics.counter("blackbox_dumps_total", trigger=trigger).inc()

        try:
            if metrics.registry._lock.acquire(timeout=_REGISTRY_PROBE_S):
                metrics.registry._lock.release()
                inc()
            else:
                threading.Thread(target=inc, name="hvd-blackbox-count",
                                 daemon=True).start()
        except Exception:
            pass

    def _retain(self) -> None:
        """Evict oldest-first past ``max_bundles`` (and sweep any
        orphaned ``.tmp-*`` dirs from a mid-publish crash)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if n.startswith(".tmp-") and not n.endswith(f".{os.getpid()}"):
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)
        bundles = [os.path.join(self.root, n) for n in names
                   if n.startswith("postmortem-")]
        bundles.sort(key=lambda p: _bundle_mtime(p))
        while len(bundles) > self.max_bundles:
            shutil.rmtree(bundles.pop(0), ignore_errors=True)


def _redacted(cfg) -> Dict[str, Any]:
    """The config as a dict, each secret (a field kept out of the
    config's ``repr``: ``serve_auth_token``) written as ``"<redacted>"``
    when set. The reference writes every value as it is; a bundle is
    copied off the host, so the port never writes a token to it."""
    out = dataclasses.asdict(cfg)
    for f in dataclasses.fields(cfg):
        if not f.repr and out.get(f.name):
            out[f.name] = "<redacted>"
    return out


def _bundle_mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def _all_thread_stacks() -> str:
    """Faulthandler-style all-thread stacks (pure Python: safe to run
    from a signal handler, needs no locks beyond the GIL)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for tid, frame in sys._current_frames().items():
        out.append(f"Thread {tid} ({names.get(tid, '?')}):\n")
        out.extend(traceback.format_stack(frame))
        out.append("\n")
    return "".join(out)


# ---------------------------------------------------------------------------
# module singleton + trigger hooks (all safe no-ops when disabled)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None


def get() -> Optional[FlightRecorder]:
    """The process recorder, or ``None`` when not armed."""
    return _RECORDER


def ensure(rank: Optional[int] = None,
           world: Optional[int] = None) -> Optional[FlightRecorder]:
    """Arm (or return) the recorder when ``HOROVOD_BLACKBOX`` is set;
    ``None`` when disabled. Lazily called from every trigger hook so
    fleet workers that never run ``hvd.init()`` (they build engines
    directly) still record and dump."""
    global _RECORDER
    try:
        from horovod_tpu_torch.config import get_config
        enabled = get_config().blackbox
    except Exception:
        return None
    if not enabled:
        return None
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder().start()
        rec = _RECORDER
    if rank is not None:
        rec.rank = rank
    if world is not None:
        rec.world = world
    return rec


def set_identity(rank: Optional[int] = None,
                 world: Optional[int] = None) -> None:
    """Label this process's bundles (replica servers know their rank even
    without ``hvd.init()``)."""
    rec = ensure(rank=rank, world=world)
    if rec is None and _RECORDER is not None:
        if rank is not None:
            _RECORDER.rank = rank
        if world is not None:
            _RECORDER.world = world


def on_init(cfg) -> None:
    """``hvd.init()`` hook: arm the recorder, install the fatal-signal /
    excepthook dump triggers and (opt-out) the stdlib faulthandler."""
    try:
        rank = world = None
        try:
            from horovod_tpu_torch import core
            if core.is_initialized():
                rank, world = core.rank(), core.size()
        except Exception:
            pass
        rec = ensure(rank=rank, world=world)
        if rec is not None:
            rec.install_crash_hooks()
            if cfg.faulthandler_enable:
                rec.install_faulthandler()
    except Exception:
        logger.exception("blackbox: init hook failed")


def on_shutdown() -> None:
    """``hvd.shutdown()`` hook: stop feeds; rings (like metric values)
    survive — they are history, not runtime state."""
    rec = _RECORDER
    if rec is not None:
        try:
            rec.stop()
        except Exception:
            pass


def reset() -> None:
    """Drop the process recorder (tests)."""
    global _RECORDER
    with _LOCK:
        rec, _RECORDER = _RECORDER, None
    if rec is not None:
        try:
            rec.stop()
        except Exception:
            pass


def note_fault(kind: str, rank: Any = None, step: Any = None,
               detail: str = "") -> None:
    """Record one fault injection (``faults._fire``)."""
    rec = ensure()
    if rec is not None:
        rec.note("fault", kind=kind, rank=rank, step=step, detail=detail)


def note_fleet(event: str, **fields: Any) -> None:
    """Record one fleet slot transition (``FleetSupervisor``)."""
    rec = ensure()
    if rec is not None:
        rec.note("fleet", event=event, **fields)


def note_config(event: str, **fields: Any) -> None:
    """Record one config-bus event (``confbus``: mutation, experiment
    verdict, auto-revert) — postmortems show the config trajectory."""
    rec = ensure()
    if rec is not None:
        rec.note("config", event=event, **fields)


def on_alert(rec_dict: Dict[str, Any]) -> None:
    """Alert lifecycle hook (``health.ContinuousDoctor``): ring every
    fire/clear; a fire at/above :data:`ALERT_DUMP_SEVERITY` dumps."""
    rec = ensure()
    if rec is None:
        return
    rec.note("alert", **rec_dict)
    if rec_dict.get("event") == "fire" \
            and float(rec_dict.get("severity", 0.0)) >= ALERT_DUMP_SEVERITY:
        rec.dump(trigger="alert",
                 note=f"alert {rec_dict.get('finding')} "
                      f"sev={rec_dict.get('severity')}")


def on_stall(report: Dict[str, Any]) -> None:
    """StallWatchdog escalation hook (``metrics.StallWatchdog._fire``)."""
    rec = ensure()
    if rec is None:
        return
    rec.note("stall", kind=report.get("kind"),
             tensor=report.get("tensor"),
             pending_s=report.get("pending_s"))
    rec.dump(trigger="stall",
             note=f"stall {report.get('kind')} {report.get('tensor')!r} "
                  f"{report.get('pending_s', 0):.1f}s")


def on_engine_death(reason: str, rank: Any = None) -> None:
    """Engine-death hook (``serving/replica.py:_retire``)."""
    rec = ensure(rank=rank if isinstance(rank, int) else None)
    if rec is None:
        return
    rec.note("engine", reason=reason, rank=rank)
    rec.dump(trigger="engine", note=f"engine death: {reason}")


def dump_postmortem(label: Optional[str] = None, *,
                    trigger: str = "manual",
                    note: Optional[str] = None) -> Optional[str]:
    """Publish a postmortem bundle now (``hvd.dump_postmortem()``; also
    the fleet ``dump`` RPC's server side). Returns the bundle path, or
    ``None`` when the recorder is disabled or a dump is already in
    flight."""
    rec = ensure()
    if rec is None:
        return None
    return rec.dump(trigger=trigger, label=label, note=note)


# ---------------------------------------------------------------------------
# offline consumers
# ---------------------------------------------------------------------------

def read_alerts_tail(path: str, limit: int = 400) -> List[Dict[str, Any]]:
    """Rotation-aware tail of ``alerts.jsonl``: records from
    ``<path>.1`` (if rotated) then ``<path>``, last ``limit`` kept —
    mirrors the size-based rotation in ``health._append_alert``."""
    out: List[Dict[str, Any]] = []
    for p in (path + ".1", path):
        try:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
        except OSError:
            continue
    return out[-limit:]


def find_bundles(root: Optional[str] = None) -> List[str]:
    """Published bundles under ``root`` (default: the configured
    blackbox dir), newest first."""
    if root is None:
        try:
            from horovod_tpu_torch.config import get_config
            root = get_config().blackbox_dir or _default_dir()
        except Exception:
            root = _default_dir()
    try:
        names = [n for n in os.listdir(root)
                 if n.startswith("postmortem-")
                 and os.path.isdir(os.path.join(root, n))]
    except OSError:
        return []
    paths = [os.path.join(root, n) for n in names]
    paths.sort(key=_bundle_mtime, reverse=True)
    return paths


def _load_json(path: str) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue
    except OSError:
        pass
    return out


def _iso(ts: Any) -> str:
    try:
        return time.strftime("%H:%M:%S", time.localtime(float(ts)))
    except (TypeError, ValueError):
        return "?"


def _queue_trend(bundle: str, death_ts: float) -> Optional[str]:
    """'queue depth rising Ns before death' — from the raw sampled
    snapshots (``serve_queue_depth`` gauge per tick)."""
    pts: List[tuple] = []
    for rec in _load_jsonl(os.path.join(bundle, "snapshots.jsonl")):
        snap = rec.get("snapshot") or {}
        for s in (snap.get("gauges") or {}).get("serve_queue_depth", []):
            pts.append((float(rec.get("ts", 0.0)), float(s["value"])))
    pts.sort()
    if len(pts) < 2:
        return None
    first_ts, first = pts[0]
    last_ts, last = pts[-1]
    if last >= max(4.0, 2.0 * max(first, 1.0)):
        dt = max(0.0, death_ts - first_ts)
        return (f"queue depth rising {dt:.0f}s before death "
                f"({first:g} -> {last:g})")
    return None


def postmortem_report(bundle: Optional[str] = None, *,
                      root: Optional[str] = None) -> Dict[str, Any]:
    """Analyze one bundle offline and rank root causes.

    ``bundle`` defaults to the newest under ``root`` / the configured
    blackbox dir. Returns ``{"bundle", "manifest", "findings", "cause",
    "stacks_present", ...}`` — ``cause`` is the top finding when one
    reaches severity 0.5 (the CLI exits 2 on that), ``findings`` are
    ranked like every doctor report (category/severity/title/detail/
    suggestion, ``rank`` 1-based)."""
    if bundle is None:
        found = find_bundles(root)
        if not found:
            raise FileNotFoundError(
                f"no postmortem bundles under {root or _default_dir()!r}")
        bundle = found[0]
    manifest = _load_json(os.path.join(bundle, "manifest.json")) or {}
    events = _load_jsonl(os.path.join(bundle, "events.jsonl"))
    alerts = _load_jsonl(os.path.join(bundle, "alerts.tail.jsonl"))
    window = _load_json(os.path.join(bundle, "metrics.window.json"))
    death_ts = float(manifest.get("ts", time.time()))
    findings: List[Dict[str, Any]] = []

    # The existing offline doctor over the bundle's windowed snapshot —
    # the same checks that run live, re-run on the black box's memory.
    if window:
        try:
            from horovod_tpu_torch import profiler
            rep = profiler.doctor(snapshot=window, trace=None, programs={})
            findings.extend(rep.get("findings", []))
        except Exception:
            pass

    trend = _queue_trend(bundle, death_ts)

    # Ground truth from the events ring outranks inference: an injected
    # fault that killed the process IS the root cause.
    fault_evs = [e for e in events if e.get("type") == "fault"]
    fatal = [e for e in fault_evs if e.get("kind") in ("crash_loop", "kill")]
    if fatal:
        last = fatal[-1]
        kind = last.get("kind")
        r = last.get("rank")
        detail = (f"last event FAULT {kind}@rank={r},step={last.get('step')}"
                  f" at {_iso(last.get('ts'))}"
                  f" ({len(fault_evs)} fault injections in window)")
        if trend:
            detail += f"; {trend}"
        findings.append({
            "category": "crash_loop" if kind == "crash_loop" else "fault_kill",
            "severity": 0.98,
            "title": f"rank {r} {kind}: injected fault killed the process",
            "detail": detail,
            "suggestion": "the fault plan (HOROVOD_FAULT_PLAN) killed this "
                          "rank; if unexpected, clear the plan — the fleet "
                          "supervisor's quarantine/backoff handled recovery",
        })
    quarantines = [e for e in events if e.get("type") == "fleet"
                   and e.get("event") == "quarantine"]
    if quarantines and not fatal:
        last = quarantines[-1]
        findings.append({
            "category": "crash_loop",
            "severity": 0.9,
            "title": f"replica {last.get('replica')} quarantined",
            "detail": f"{last.get('reason', '')} at {_iso(last.get('ts'))}"
                      + (f"; {trend}" if trend else ""),
            "suggestion": "inspect the quarantined replica's own bundle "
                          "for the per-process death evidence",
        })
    engine_evs = [e for e in events if e.get("type") == "engine"]
    if engine_evs:
        last = engine_evs[-1]
        findings.append({
            "category": "engine_death",
            "severity": 0.85,
            "title": f"serving engine died: {last.get('reason')}",
            "detail": f"rank {last.get('rank')} at {_iso(last.get('ts'))}"
                      + (f"; {trend}" if trend else ""),
            "suggestion": "the step function raised or the device wedged; "
                          "see stacks.txt and the trace tail",
        })
    stall_evs = [e for e in events if e.get("type") == "stall"]
    if stall_evs and not any(f["category"] == "stall" for f in findings):
        last = stall_evs[-1]
        findings.append({
            "category": "stall",
            "severity": 0.8,
            "title": f"collective stalled: {last.get('kind')} "
                     f"{last.get('tensor')!r}",
            "detail": f"pending {last.get('pending_s', 0):.1f}s "
                      f"at {_iso(last.get('ts'))}",
            "suggestion": "a peer stopped arriving; check the fleet events "
                          "and the straggler report of the merged trace",
        })
    fired = [a for a in alerts if a.get("event") == "fire"]
    if fired and not fatal and not engine_evs:
        last = fired[-1]
        findings.append({
            "category": str(last.get("finding", "alert")),
            "severity": min(0.79, float(last.get("severity", 0.5))),
            "title": f"alert fired before death: {last.get('finding')} — "
                     f"{last.get('title', '')}",
            "detail": f"severity {last.get('severity')} "
                      f"at {_iso(last.get('ts'))}",
            "suggestion": str(last.get("suggestion", "")),
        })
    if trend and not any(trend in f.get("detail", "") for f in findings):
        findings.append({
            "category": "queue_growth", "severity": 0.45,
            "title": "queue depth rising before death",
            "detail": trend,
            "suggestion": "admission outpaced decode; check slots/"
                          "queue-limit sizing in config.json",
        })

    # Trace tail: merge the bundle's shards (best-effort — an empty
    # trace dir is normal when the worker ran without HOROVOD_TIMELINE).
    trace_summary: Dict[str, Any] = {"events": 0, "last": []}
    trace_dir = os.path.join(bundle, "trace")
    if os.path.isdir(trace_dir) and os.listdir(trace_dir):
        try:
            from horovod_tpu_torch.trace_merge import merge_timelines
            merged = merge_timelines(trace_dir, feed_metrics=False)
            evs = [e for e in merged.get("traceEvents", [])
                   if e.get("cat") != "__metadata"
                   and e.get("name") != "shard_meta"]
            trace_summary["events"] = len(evs)
            trace_summary["last"] = [e.get("name") for e in evs[-5:]]
        except Exception:
            pass

    # Rank: same ordering contract as the health plane's reports.
    dedup: Dict[str, Dict[str, Any]] = {}
    for f in findings:
        prev = dedup.get(f["category"])
        if prev is None or f["severity"] > prev["severity"]:
            dedup[f["category"]] = f
    ranked = sorted(dedup.values(),
                    key=lambda f: (-f["severity"], f["category"],
                                   f.get("title", "")))
    for i, f in enumerate(ranked):
        f["rank"] = i + 1
    stacks = os.path.join(bundle, "stacks.txt")
    stacks_present = os.path.isfile(stacks) and os.path.getsize(stacks) > 0
    cause = ranked[0] if ranked and ranked[0]["severity"] >= 0.5 else None
    return {"bundle": bundle, "manifest": manifest, "findings": ranked,
            "cause": cause, "stacks_present": stacks_present,
            "n_events": len(events), "n_alerts": len(alerts),
            "trace": trace_summary}


def format_postmortem(report: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`postmortem_report`."""
    m = report.get("manifest", {})
    out = [f"postmortem: {report['bundle']}",
           f"  trigger={m.get('trigger', '?')} label={m.get('label', '?')} "
           f"rank={m.get('rank')} pid={m.get('pid')} "
           f"at {m.get('time', '?')}" +
           (f" — {m.get('note')}" if m.get("note") else ""),
           f"  window={m.get('window_seconds', '?')}s "
           f"snapshots={m.get('snapshots', '?')} "
           f"events={report.get('n_events', 0)} "
           f"alerts={report.get('n_alerts', 0)} "
           f"trace_events={report.get('trace', {}).get('events', 0)} "
           f"stacks={'yes' if report.get('stacks_present') else 'no'}"]
    cause = report.get("cause")
    if cause is not None:
        out.append(f"root cause: {cause['title']}")
        out.append(f"  {cause['detail']}")
    else:
        out.append("root cause: none found (no finding reached "
                   "severity 0.5)")
    findings = report.get("findings", [])
    if findings:
        out.append("findings:")
        for f in findings:
            out.append(f"  #{f['rank']} [{f['severity']:.2f}] "
                       f"{f['category']}: {f['title']}")
            if f.get("detail"):
                out.append(f"      {f['detail']}")
            if f.get("suggestion"):
                out.append(f"      -> {f['suggestion']}")
    last = report.get("trace", {}).get("last") or []
    if last:
        out.append(f"last trace events: {', '.join(map(str, last))}")
    return "\n".join(out)
