"""Windowed time-series over metrics-registry snapshots.

Port of ``horovod_tpu/timeseries.py``, whole. ``hvd.metrics()`` answers
"what has happened since process start", never "what is happening *now*"
or "when did this start". This module is the time axis: a bounded
ring-buffer store keyed by ``(kind, metric, labels)`` that appends whole
registry snapshots (local samples or scraped peers) at an interval and
answers windowed queries --

* :meth:`TimeSeriesStore.delta` / :meth:`TimeSeriesStore.rate` --
  **reset-aware** counter increase over a window. A restarted replica's
  counters drop to zero; PromQL ``increase`` semantics clamp at the
  reset (the post-reset value *is* the contribution) instead of
  producing a negative spike.
* :meth:`TimeSeriesStore.quantile` -- histogram quantiles estimated from
  per-window cumulative **bucket deltas** with linear interpolation
  inside the bracketing bucket (``histogram_quantile`` semantics).
* :meth:`TimeSeriesStore.ewma` -- time-aware exponentially weighted
  average of a gauge (weight ``0.5 ** (age / half_life)``).
* :meth:`TimeSeriesStore.window_snapshot` -- a registry-snapshot-shaped
  dict whose counters/histograms are window *deltas* and whose gauges
  are the latest values, so a doctor's checks run unchanged on windowed
  data (``profiler.doctor_window``).

Peers land in the same store under extra labels (``{replica, attempt}``,
the reference's ``health.FleetCollector``, item 9c-ii-b), so a restarted
replica mints *new* series and fleet-wide rates stay monotone across
restarts; stale series age out via :meth:`TimeSeriesStore.expire`.

:class:`LocalSampler` samples the port's own registry
(``horovod_tpu_torch.metrics.snapshot``) on a daemon thread that reads
host tables only: it never touches CUDA or ``torch.distributed``.
Importing this module starts no thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore", "LocalSampler"]

#: ring depth per series — at the default 2 s health tick this is ~8 min
#: of history, comfortably past any alert window, in O(KB) per series.
DEFAULT_MAX_POINTS = 256
#: a series with no new point for this long is dropped at the next
#: :meth:`TimeSeriesStore.expire` — dead attempts must not pin memory.
DEFAULT_MAX_AGE_S = 120.0


def _label_key(labels: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _matches(key: Tuple[Tuple[str, str], ...],
             want: Optional[Dict[str, Any]]) -> bool:
    """Subset label match: every wanted pair must appear in the key."""
    if not want:
        return True
    have = dict(key)
    return all(have.get(str(k)) == str(v) for k, v in want.items())


class TimeSeriesStore:
    """Bounded per-series ring buffers over registry snapshots.

    Thread-safe; writers (:meth:`append_snapshot`) and readers (window
    queries) may interleave freely. Scalars are stored as ``(ts, value)``
    points; histograms as ``(ts, (count, sum, cumulative_bucket_counts))``
    with the bucket edges recorded once per family.
    """

    def __init__(self, max_points: int = DEFAULT_MAX_POINTS,
                 max_age_s: float = DEFAULT_MAX_AGE_S):
        self._lock = threading.Lock()
        self._max_points = max(2, int(max_points))
        self.max_age_s = float(max_age_s)
        # (kind, name, label_key) -> deque of points
        self._series: Dict[Tuple[str, str, tuple], deque] = {}
        # histogram family -> upper bounds (inc. +Inf), frozen at first sight
        self._hist_edges: Dict[str, Tuple[float, ...]] = {}

    # -- ingestion ---------------------------------------------------------

    def append_snapshot(self, snap: Dict[str, Any], *,
                        ts: Optional[float] = None,
                        labels: Optional[Dict[str, Any]] = None) -> None:
        """Append one registry snapshot (``hvd.metrics()`` shape). ``labels``
        are merged into every series — the scrape identity
        (``{replica, attempt}``) that re-keys a restarted peer."""
        ts = time.time() if ts is None else float(ts)
        extra = dict(labels or {})
        with self._lock:
            for name, series in (snap.get("counters") or {}).items():
                for s in series:
                    self._append("counter", name,
                                 {**s.get("labels", {}), **extra},
                                 ts, float(s["value"]))
            for name, series in (snap.get("gauges") or {}).items():
                for s in series:
                    self._append("gauge", name,
                                 {**s.get("labels", {}), **extra},
                                 ts, float(s["value"]))
            for name, series in (snap.get("histograms") or {}).items():
                for s in series:
                    buckets = s.get("buckets") or []
                    if name not in self._hist_edges:
                        self._hist_edges[name] = tuple(
                            float(le) for le, _ in buckets)
                    point = (int(s.get("count", 0)),
                             float(s.get("sum", 0.0)),
                             tuple(int(c) for _, c in buckets))
                    self._append("histogram", name,
                                 {**s.get("labels", {}), **extra}, ts, point)

    def _append(self, kind: str, name: str, labels: Dict[str, Any],
                ts: float, value) -> None:
        key = (kind, name, _label_key(labels))
        dq = self._series.get(key)
        if dq is None:
            dq = self._series[key] = deque(maxlen=self._max_points)
        dq.append((ts, value))

    def expire(self, max_age_s: Optional[float] = None,
               now: Optional[float] = None) -> int:
        """Drop series whose newest point is older than ``max_age_s``
        (a quarantined replica, a superseded attempt). Returns the number
        of series dropped."""
        horizon = (self.max_age_s if max_age_s is None else float(max_age_s))
        now = time.time() if now is None else float(now)
        with self._lock:
            dead = [k for k, dq in self._series.items()
                    if dq and now - dq[-1][0] > horizon]
            for k in dead:
                del self._series[k]
        return len(dead)

    # -- introspection -----------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def label_sets(self, name: Optional[str] = None,
                   keys: Tuple[str, ...] = ("replica", "attempt"),
                   ) -> List[Dict[str, str]]:
        """Distinct projections of series labels onto ``keys`` (series
        lacking every key are skipped) — how callers discover which
        ``{replica, attempt}`` identities the store has seen."""
        seen: Dict[tuple, Dict[str, str]] = {}
        with self._lock:
            series_keys = list(self._series.keys())
        for _, n, lk in series_keys:
            if name is not None and n != name:
                continue
            have = dict(lk)
            proj = {k: have[k] for k in keys if k in have}
            if proj:
                seen[tuple(sorted(proj.items()))] = proj
        return list(seen.values())

    def last_update(self, labels: Optional[Dict[str, Any]] = None
                    ) -> Optional[float]:
        """Newest point timestamp across series matching ``labels``."""
        newest: Optional[float] = None
        with self._lock:
            for (_, _, lk), dq in self._series.items():
                if dq and _matches(lk, labels):
                    if newest is None or dq[-1][0] > newest:
                        newest = dq[-1][0]
        return newest

    def _points(self, kind: str, name: str,
                labels: Optional[Dict[str, Any]]) -> List[List[tuple]]:
        with self._lock:
            return [list(dq) for (k, n, lk), dq in self._series.items()
                    if k == kind and n == name and dq and _matches(lk, labels)]

    # -- windowed queries --------------------------------------------------

    @staticmethod
    def _window(points: List[tuple], start: float, now: float) -> List[tuple]:
        """Points inside ``[start, now]`` plus the last pre-window point as
        the baseline — a window must not charge history that predates it."""
        inside = [p for p in points if start <= p[0] <= now]
        before = [p for p in points if p[0] < start]
        return ([before[-1]] if before else []) + inside

    def delta(self, name: str, window_s: float, *,
              labels: Optional[Dict[str, Any]] = None,
              now: Optional[float] = None) -> float:
        """Reset-aware counter increase over the window, summed across
        matching series. A value drop within a series is a counter reset:
        the post-reset value is the contribution (PromQL ``increase``),
        never a negative delta."""
        now = time.time() if now is None else float(now)
        start = now - float(window_s)
        total = 0.0
        for points in self._points("counter", name, labels):
            pts = self._window(points, start, now)
            if len(pts) < 2:
                # A series born inside the window contributes its first
                # observed value only when the birth IS the window start
                # (no baseline): one point tells us nothing about motion.
                continue
            prev = pts[0][1]
            for _, v in pts[1:]:
                total += v if v < prev else v - prev
                prev = v
        return total

    def rate(self, name: str, window_s: float, *,
             labels: Optional[Dict[str, Any]] = None,
             now: Optional[float] = None) -> float:
        """Per-second reset-aware rate: :meth:`delta` over the window
        length."""
        w = max(1e-9, float(window_s))
        return self.delta(name, w, labels=labels, now=now) / w

    def latest(self, name: str, *, kind: str = "gauge",
               labels: Optional[Dict[str, Any]] = None,
               agg: str = "sum",
               now: Optional[float] = None) -> Optional[float]:
        """Latest value per matching series, aggregated (``sum``/``max``/
        ``last``). ``None`` when no series matches — absence and zero are
        different answers."""
        del now  # symmetry with the windowed queries; latest is windowless
        vals = [points[-1][1]
                for points in self._points(kind, name, labels) if points]
        if not vals:
            return None
        if agg == "max":
            return max(vals)
        if agg == "last":
            return vals[-1]
        return float(sum(vals))

    def ewma(self, name: str, *, half_life_s: float = 30.0,
             window_s: Optional[float] = None,
             labels: Optional[Dict[str, Any]] = None,
             now: Optional[float] = None) -> Optional[float]:
        """Time-aware EWMA of a gauge over the window (default: all
        retained points): weight ``0.5 ** ((t_newest - t_i)/half_life)``.
        A single sample is its own average; no samples is ``None``."""
        now = time.time() if now is None else float(now)
        start = now - float(window_s) if window_s else float("-inf")
        pts: List[tuple] = []
        for points in self._points("gauge", name, labels):
            pts.extend(p for p in points if p[0] >= start)
        if not pts:
            return None
        pts.sort(key=lambda p: p[0])
        t_last = pts[-1][0]
        hl = max(1e-9, float(half_life_s))
        wsum = vsum = 0.0
        for t, v in pts:
            w = 0.5 ** ((t_last - t) / hl)
            wsum += w
            vsum += w * v
        return vsum / wsum if wsum else None

    def _hist_window_delta(self, name: str, window_s: float,
                           labels: Optional[Dict[str, Any]],
                           now: float):
        """Summed per-window histogram delta across matching series:
        ``(count_delta, sum_delta, cumulative_bucket_deltas)`` against the
        family's edges, reset-aware (a count drop means the replica
        restarted — its post-reset state is the window contribution)."""
        with self._lock:
            edges = self._hist_edges.get(name)
        if not edges:
            return None
        start = now - float(window_s)
        n_b = len(edges)
        d_count, d_sum = 0, 0.0
        d_buckets = [0] * n_b
        for points in self._points("histogram", name, labels):
            pts = self._window(points, start, now)
            if len(pts) < 2:
                continue
            prev = pts[0][1]
            for _, cur in pts[1:]:
                c0, s0, b0 = prev
                c1, s1, b1 = cur
                if c1 < c0:            # reset: the new life starts at zero
                    c0, s0, b0 = 0, 0.0, (0,) * n_b
                d_count += c1 - c0
                d_sum += s1 - s0
                for i in range(min(n_b, len(b1))):
                    base = b0[i] if i < len(b0) else 0
                    d_buckets[i] += b1[i] - base
                prev = cur
        if d_count <= 0:
            return None
        return d_count, d_sum, d_buckets, edges

    def quantile(self, name: str, q: float, window_s: float, *,
                 labels: Optional[Dict[str, Any]] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """Estimate the ``q``-quantile of observations made *inside* the
        window from cumulative bucket deltas, linearly interpolated inside
        the bracketing bucket (``histogram_quantile`` semantics; the +Inf
        bucket answers with its lower edge). ``None`` when the window holds
        no observations."""
        now = time.time() if now is None else float(now)
        d = self._hist_window_delta(name, window_s, labels, now)
        if d is None:
            return None
        d_count, _, d_buckets, edges = d
        target = max(0.0, min(1.0, float(q))) * d_count
        prev_cum = 0
        for i, le in enumerate(edges):
            cum = d_buckets[i]
            if cum >= target:
                lo = edges[i - 1] if i > 0 else 0.0
                if le == float("inf"):
                    return lo
                in_bucket = cum - prev_cum
                if in_bucket <= 0:
                    return le
                return lo + (le - lo) * (target - prev_cum) / in_bucket
            prev_cum = cum
        return edges[-2] if len(edges) > 1 else None

    def fraction_over(self, name: str, threshold: float, window_s: float, *,
                      labels: Optional[Dict[str, Any]] = None,
                      now: Optional[float] = None) -> Optional[float]:
        """Fraction of window observations strictly above ``threshold``
        (resolved to the nearest bucket edge >= threshold — bucketed data
        cannot answer finer). The SLO burn-rate numerator."""
        now = time.time() if now is None else float(now)
        d = self._hist_window_delta(name, window_s, labels, now)
        if d is None:
            return None
        d_count, _, d_buckets, edges = d
        under = 0
        for i, le in enumerate(edges):
            if le >= threshold:
                under = d_buckets[i]
                break
        else:
            under = d_count
        return max(0.0, (d_count - under) / d_count)

    # -- doctor bridge -----------------------------------------------------

    def window_snapshot(self, window_s: float, *,
                        now: Optional[float] = None,
                        labels: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
        """A registry-snapshot-shaped dict over the window: counters are
        reset-aware window deltas, gauges the latest values, histograms the
        window's ``{count, sum, buckets}`` deltas (buckets cumulative, like
        the live registry). Existing ``hvd.doctor()`` checks consume this
        unchanged — that is the whole point (``profiler.doctor_window``)."""
        now = time.time() if now is None else float(now)
        start = now - float(window_s)
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {},
                               "pending_collectives": [],
                               "window_seconds": float(window_s),
                               "timestamp": now}
        with self._lock:
            items = [(k, list(dq)) for k, dq in self._series.items()]
            hist_edges = dict(self._hist_edges)
        for (kind, name, lk), points in items:
            if not points or not _matches(lk, labels):
                continue
            if kind == "gauge":
                out["gauges"].setdefault(name, []).append(
                    {"labels": dict(lk), "value": points[-1][1]})
                continue
            pts = self._window(points, start, now)
            if len(pts) < 2:
                continue
            if kind == "counter":
                total, prev = 0.0, pts[0][1]
                for _, v in pts[1:]:
                    total += v if v < prev else v - prev
                    prev = v
                out["counters"].setdefault(name, []).append(
                    {"labels": dict(lk), "value": total})
            else:
                edges = hist_edges.get(name, ())
                n_b = len(edges)
                d_count, d_sum = 0, 0.0
                d_buckets = [0] * n_b
                prev = pts[0][1]
                for _, cur in pts[1:]:
                    c0, s0, b0 = prev
                    c1, s1, b1 = cur
                    if c1 < c0:
                        c0, s0, b0 = 0, 0.0, (0,) * n_b
                    d_count += c1 - c0
                    d_sum += s1 - s0
                    for i in range(min(n_b, len(b1))):
                        base = b0[i] if i < len(b0) else 0
                        d_buckets[i] += b1[i] - base
                    prev = cur
                if d_count <= 0:
                    continue
                out["histograms"].setdefault(name, []).append(
                    {"labels": dict(lk), "count": d_count, "sum": d_sum,
                     "buckets": [[edges[i], d_buckets[i]]
                                 for i in range(n_b)]})
        return out


class LocalSampler:
    """Background thread appending the process-local registry snapshot
    into a :class:`TimeSeriesStore` every ``interval_s`` (the local half
    of the reference's health plane; peers arrive there via
    ``health.FleetCollector``, ROADMAP.md section A item 9c-ii-b)."""

    def __init__(self, store: TimeSeriesStore, interval_s: float = 2.0,
                 labels: Optional[Dict[str, Any]] = None,
                 on_sample: Optional[Any] = None):
        self.store = store
        self.interval_s = max(0.05, float(interval_s))
        self.labels = dict(labels or {})
        # Optional per-tick observer fed (snapshot, ts) — the flight
        # recorder rings the RAW snapshot from the same tick the store
        # ingests, so bundle trends and window deltas line up exactly.
        self.on_sample = on_sample
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self, ts: Optional[float] = None) -> None:
        from horovod_tpu_torch import metrics
        snap = metrics.snapshot()
        ts = time.time() if ts is None else float(ts)
        self.store.append_snapshot(snap, ts=ts, labels=self.labels)
        self.store.expire()
        if self.on_sample is not None:
            try:
                self.on_sample(snap, ts)
            except Exception:
                pass

    def start(self) -> "LocalSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="hvd-ts-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:   # sampling must never kill the thread
                pass
