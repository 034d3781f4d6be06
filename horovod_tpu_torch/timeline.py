"""Timeline: Chrome-trace JSON of the controller's activity.

Port of ``horovod_tpu/timeline.py`` (upstream ``horovod/common/
timeline.cc``, activated by ``HOROVOD_TIMELINE=/path.json``): every eager
collective logs its NEGOTIATE / QUEUE / EXEC phases keyed by the op id of
its span (``tracing.py``), and the metrics registry drops instant markers
(stalls, fusion flushes, init). Events buffer in Python, as on the
reference's own Python path, and ``flush`` writes them out.

The timeline records what the host does. EXEC is the host's issue of the
``torch.distributed`` work, which NCCL runs asynchronously on the device;
device time is for ``torch.profiler``.

:func:`merge_timelines` merges the per-rank shards into one trace with a
straggler report (``trace_merge.py``). :func:`start_profiler` /
:func:`stop_profiler` open and close a ``torch.profiler`` capture through
the profiler's one session (``profiler.profile``). Not ported yet
(ROADMAP.md section A item 9d): the reference's native C appender.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional

__all__ = ["Timeline", "init_timeline", "get_timeline", "shutdown_timeline",
           "start_timeline", "stop_timeline", "shard_path",
           "emit_clock_anchor", "add_tap", "remove_tap",
           "merge_timelines", "start_profiler", "stop_profiler"]

_LOCK = threading.Lock()
_TIMELINE: Optional["Timeline"] = None

# Event taps: callables fed every emitted event dict. Module-level, not
# per-Timeline, so a tap survives timeline re-init. A tap must be cheap and
# must never emit timeline events itself.
_TAPS: list = []


def add_tap(fn) -> None:
    """Register ``fn(event_dict)`` to observe every emitted event."""
    with _LOCK:
        if fn not in _TAPS:
            _TAPS.append(fn)


def remove_tap(fn) -> None:
    with _LOCK:
        try:
            _TAPS.remove(fn)
        except ValueError:
            pass


def _dumps_event(ev: dict) -> str:
    """One event as JSON; an argument that cannot be written (its ``str``
    raises, or it refers to itself) degrades to its type's name, so one bad
    marker argument never costs the trace."""
    try:
        return json.dumps(ev, default=str)
    except Exception:      # an argument's str() raised, or a cycle
        pass
    args = {}
    for k, v in (ev.get("args") or {}).items():
        try:
            json.dumps(v, default=str)
            args[str(k)] = v
        except Exception:
            args[str(k)] = f"<unserializable {type(v).__name__}>"
    return json.dumps(dict(ev, args=args), default=str)


class Timeline:
    """Chrome-trace (``chrome://tracing`` / Perfetto) event writer.

    Events buffer in memory; :meth:`flush` writes the whole trace at once
    and closes the timeline. A flush always leaves valid JSON at ``path``:
    the document is serialized first and written to a temporary file that
    replaces ``path`` only when complete. A flush that raised (the
    directory is missing, the disk is full) leaves any earlier file whole
    and the timeline open, so it can be flushed again.
    """

    def __init__(self, path: str, rank: Optional[int] = None,
                 world: Optional[int] = None):
        self.path = path
        self.rank = rank
        self._events: list = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._lock = threading.Lock()
        self._closed = False
        if rank is not None:
            # Shard identity rides in the event stream; a shard merge reads
            # it back to label per-rank tracks.
            self._emit("process_name", "__metadata", "M", 0.0, 0.0, 0,
                       {"name": f"rank {rank}"})
            self.marker("shard_meta", category="trace", rank=rank,
                        world=world)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, name, cat, ph, ts, dur, tid, args) -> None:
        ev = {"name": name, "cat": cat, "ph": ph, "ts": ts,
              "pid": self._pid, "tid": tid, "args": args}
        if ph == "X":
            ev["dur"] = dur
        if ph == "i":
            ev["s"] = "g"
        with self._lock:
            if self._closed:
                return
            self._events.append(ev)
        # Taps run outside the event lock and can never disable the
        # timeline by raising.
        for tap in list(_TAPS):
            try:
                tap(ev)
            except Exception:
                pass

    def marker(self, name: str, category: str = "marker", **args) -> None:
        self._emit(name, category, "i", self._now_us(), 0.0, 0, args)

    @contextmanager
    def activity(self, name: str, category: str = "collective", **args):
        """Complete-event span, e.g. around an eager collective's issue."""
        t0 = self._now_us()
        try:
            yield
        finally:
            self._emit(name, category, "X", t0, self._now_us() - t0,
                       threading.get_ident() % 1_000_000, args)

    def flush(self) -> None:
        """Write the trace and close the timeline (see the class
        docstring for what a failed write leaves)."""
        with self._lock:
            if self._closed:
                return
            body = ",".join(_dumps_event(e) for e in self._events)
            doc = '{"traceEvents": [' + body + '], "displayTimeUnit": "ms"}'
            tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "w") as f:
                    f.write(doc)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self._closed = True


_ATEXIT_REGISTERED = False


def shard_path(path: str, rank: int) -> str:
    """Per-rank shard name for a multi-process run: ``/p/trace.json`` ->
    ``/p/trace.rank3.json``."""
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext or '.json'}"


def _world() -> tuple:
    """(rank, world) of this process when a world larger than one is up,
    else (None, None)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return None, None


def init_timeline(path: Optional[str] = None) -> Timeline:
    """Enable the timeline (``HOROVOD_TIMELINE`` or an explicit path).

    In a world larger than one process the path fans out to one shard per
    rank (``trace.json`` -> ``trace.rank{N}.json``): every rank writing the
    same file would corrupt it.

    Registers an ``atexit`` flush the first time: the Chrome trace is only
    valid once written, and scripts that never call ``stop_timeline`` /
    ``shutdown`` must still get their file. The flush only writes a file,
    so it does not depend on the process group still being up."""
    global _TIMELINE, _ATEXIT_REGISTERED
    with _LOCK:
        path = path or os.environ.get("HOROVOD_TIMELINE")
        if not path:
            raise ValueError(
                "pass a path or set HOROVOD_TIMELINE=/path/timeline.json")
        rank, world = _world()
        if rank is not None:
            path = shard_path(path, rank)
        if _TIMELINE is not None:
            # Re-init must not leak the previous instance unwritten.
            _TIMELINE.flush()
        _TIMELINE = Timeline(path, rank=rank, world=world)
        if not _ATEXIT_REGISTERED:
            import atexit
            atexit.register(shutdown_timeline)
            _ATEXIT_REGISTERED = True
        return _TIMELINE


def emit_clock_anchor(epoch: int = 0) -> None:
    """Record the init-barrier instant this process just left
    (``clock_anchor``): every rank emits it at the same real moment, so a
    shard merge can align per-process clocks by making the anchors
    coincide. ``wall_time`` is attached for skew reporting only."""
    t = get_timeline()
    if t is not None:
        t.marker("clock_anchor", category="trace", epoch=epoch,
                 wall_time=time.time())


def get_timeline() -> Optional[Timeline]:
    return _TIMELINE


def shutdown_timeline() -> None:
    """Write and drop the active timeline, if any."""
    global _TIMELINE
    with _LOCK:
        t, _TIMELINE = _TIMELINE, None
    if t is not None:
        t.flush()


def start_timeline(path: str, mark_cycles: bool = False) -> None:
    """``hvd.start_timeline`` (``mark_cycles`` is accepted for the
    signature: there is no controller cycle, every op is its own round)."""
    init_timeline(path)


def stop_timeline() -> None:
    """``hvd.stop_timeline``."""
    shutdown_timeline()


def merge_timelines(inputs, output: Optional[str] = None, **kwargs):
    """Merge per-rank timeline shards into one Chrome trace with per-rank
    tracks and a straggler report (``hvd.merge_timelines``); see
    :func:`horovod_tpu_torch.trace_merge.merge_timelines`."""
    from horovod_tpu_torch.trace_merge import merge_timelines as _merge
    return _merge(inputs, output, **kwargs)


def start_profiler(logdir: str) -> None:
    """Open a ``torch.profiler`` capture into ``logdir`` (the reference's
    ``jax.profiler.start_trace`` passthrough), through the profiler's one
    session: a second capture is refused. Call :func:`stop_profiler` from
    the same thread."""
    from horovod_tpu_torch import profiler as _profiler
    _profiler._begin_manual(logdir)


def stop_profiler() -> None:
    """Close the capture :func:`start_profiler` opened and write its Chrome
    trace."""
    from horovod_tpu_torch import profiler as _profiler
    _profiler._end_manual()
