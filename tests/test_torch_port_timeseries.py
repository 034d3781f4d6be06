"""horovod_tpu_torch.timeseries == horovod_tpu.timeseries.

Both packages' ``TimeSeriesStore`` take the same snapshots at the same
canned timestamps (the cases of ``tests/test_health.py``'s store classes)
and must give the same answers to every windowed query: reset-aware
``delta`` and ``rate``, ``latest``, ``ewma``, histogram ``quantile`` and
``fraction_over``, ``window_snapshot``, ``expire`` and ``label_sets``.
``LocalSampler`` samples the port's own registry on a daemon thread that
stops without a trace.
"""

import json
import threading
import time

import pytest

from horovod_tpu import timeseries as JTS
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import timeseries as PTS

T0 = 1000.0   # canned epoch for every windowed case
EDGES = [1.0, 2.0, 4.0, float("inf")]


def _snap(counters=None, gauges=None, histograms=None):
    """Registry-snapshot-shaped dict from terse {name: [(labels, value)]}
    maps (histogram values are (count, sum, [[le, cum], ...]))."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for name, series in (counters or {}).items():
        out["counters"][name] = [{"labels": lb, "value": v}
                                 for lb, v in series]
    for name, series in (gauges or {}).items():
        out["gauges"][name] = [{"labels": lb, "value": v}
                               for lb, v in series]
    for name, series in (histograms or {}).items():
        out["histograms"][name] = [
            {"labels": lb, "count": c, "sum": s, "buckets": b}
            for lb, (c, s, b) in series]
    return out


def _ctr(seq, name="req_total", labels=None):
    """[(dt, value)] of one counter -> appends."""
    return [(_snap(counters={name: [({}, v)]}), T0 + dt, labels)
            for dt, v in seq]


def _hist(points, name="lat", labels=None):
    """[(dt, count, sum, [cum...])] against EDGES -> appends."""
    return [(_snap(histograms={name: [(dict(labels or {}),
                                       (c, s, [[e, cum] for e, cum in
                                               zip(EDGES, cums)]))]}),
             T0 + dt, None) for dt, c, s, cums in points]


def _gauges(seq, name="g"):
    return [(_snap(gauges={name: [({}, v)]}), T0 + dt, None)
            for dt, v in seq]


_REKEY = [(0, 0, 0), (10, 5, 0), (20, 9, 0), (30, 0, 1), (40, 3, 1),
          (50, 7, 1)]

# case -> (appends [(snapshot, ts, labels)], queries [(method, args, kw)])
CASES = {
    "delta_clamps_at_mid_stream_reset": (
        _ctr([(0, 0), (10, 10), (20, 20), (30, 5), (40, 15)]),
        [("delta", ("req_total", 100), {"now": T0 + 40}),
         ("rate", ("req_total", 100), {"now": T0 + 40}),
         ("delta", ("req_total", 15), {"now": T0 + 40}),
         ("rate", ("req_total", 25), {"now": T0 + 30})]),
    "window_spanning_only_the_reset": (
        _ctr([(0, 0), (20, 20), (30, 5)]),
        [("delta", ("req_total", 10), {"now": T0 + 35})]),
    "attempt_rekeying": (
        [(_snap(counters={"req_total": [({}, v)]}), T0 + dt,
          {"replica": "r1", "attempt": att}) for dt, v, att in _REKEY]
        + [(_snap(counters={"req_total": [({}, v)]}), T0 + dt,
            {"replica": "r1"}) for dt, v, _ in _REKEY],
        [("delta", ("req_total", 100), {"now": T0 + 50,
                                        "labels": {"replica": "r1"}}),
         ("delta", ("req_total", 100), {"now": T0 + 50,
                                        "labels": {"attempt": 1}}),
         ("rate", ("req_total", 100), {"now": T0 + 50}),
         ("label_sets", (), {}),
         ("label_sets", ("req_total",), {"keys": ("attempt",)}),
         ("last_update", (), {"labels": {"attempt": 0}})]),
    "old_attempt_expires": (
        [(_snap(counters={"req_total": [({}, 9)]}), T0,
          {"replica": "r1", "attempt": 0}),
         (_snap(counters={"req_total": [({}, 4)]}), T0 + 30,
          {"replica": "r1", "attempt": 1})],
        [("expire", (), {"max_age_s": 20, "now": T0 + 40}),
         ("label_sets", (), {}), ("series_count", (), {})]),
    "single_point_window": (
        _ctr([(0, 7)]),
        [("delta", ("req_total", 10), {"now": T0 + 1}),
         ("rate", ("req_total", 10), {"now": T0 + 1})]),
    "empty_store": (
        [],
        [("delta", ("req_total", 10), {"now": T0}),
         ("latest", ("req_total",), {"kind": "counter"}),
         ("quantile", ("lat", 0.5, 10), {"now": T0}),
         ("ewma", ("g",), {}), ("window_snapshot", (5,), {"now": T0})]),
    "quantile_within_bucket_width": (
        _hist([(0, 0, 0.0, [0, 0, 0, 0]),
               (10, 100, 150.0, [50, 80, 90, 100])]),
        [("quantile", ("lat", q, 20), {"now": T0 + 10})
         for q in (0.0, 0.25, 0.5, 0.8, 0.9, 0.99, 1.0)]),
    "quantile_uses_window_deltas": (
        _hist([(0, 100, 50.0, [100, 100, 100, 100]),
               (50, 200, 650.0, [100, 100, 200, 200])]),
        [("quantile", ("lat", 0.5, 60), {"now": T0 + 50}),
         ("quantile", ("lat", 0.5, 10), {"now": T0 + 50}),
         ("fraction_over", ("lat", 2.0, 60), {"now": T0 + 50})]),
    "histogram_reset": (
        _hist([(0, 100, 150.0, [50, 80, 90, 100]),
               (10, 10, 5.0, [10, 10, 10, 10])]),
        [("quantile", ("lat", 0.5, 20), {"now": T0 + 10}),
         ("window_snapshot", (20,), {"now": T0 + 10})]),
    "empty_window": (
        _hist([(0, 100, 150.0, [50, 80, 90, 100])]),
        [("quantile", ("lat", 0.5, 10), {"now": T0 + 1}),
         ("fraction_over", ("lat", 1.0, 10), {"now": T0 + 1})]),
    "fraction_over": (
        _hist([(0, 0, 0.0, [0, 0, 0, 0]),
               (10, 100, 150.0, [50, 80, 90, 100])]),
        [("fraction_over", ("lat", t, 20), {"now": T0 + 10})
         for t in (0.5, 1.0, 1.5, 4.0, 100.0)]),
    "ewma_time_aware": (
        _gauges([(0, 0.0), (10, 10.0)]),
        [("ewma", ("g",), {"half_life_s": 10, "now": T0 + 10}),
         ("ewma", ("g",), {"half_life_s": 3, "window_s": 5,
                           "now": T0 + 10})]),
    "ewma_single": (
        _gauges([(0, 4.0)]),
        [("ewma", ("g",), {"half_life_s": 10, "now": T0})]),
    "latest_absent_vs_zero": (
        _gauges([(0, 0.0)]),
        [("latest", ("g",), {}), ("latest", ("h",), {}),
         ("latest", ("g",), {"agg": "max"})]),
    "window_snapshot_doctor_shape": (
        [(_snap(counters={"c": [({}, v)]}, gauges={"g": [({}, 2.0)]}),
          T0 + dt, {"replica": "r0"}) for dt, v in [(0, 0), (10, 30)]],
        [("window_snapshot", (20,), {"now": T0 + 10}),
         ("window_snapshot", (20,), {"now": T0 + 10,
                                     "labels": {"replica": "r1"}})]),
}


def _run(mod, case):
    appends, queries = CASES[case]
    st = mod.TimeSeriesStore()
    for snap, ts, labels in appends:
        st.append_snapshot(snap, ts=ts, labels=labels)
    return [getattr(st, m)(*a, **kw) for m, a, kw in queries]


@pytest.mark.parametrize("case", sorted(CASES))
def test_store_answers_as_reference(case):
    got, want = _run(PTS, case), _run(JTS, case)
    assert json.dumps(got, sort_keys=True, default=str) == \
        json.dumps(want, sort_keys=True, default=str)


def test_reference_answers_hold_on_the_port():
    """The reference's own expected values (tests/test_health.py)."""
    assert _run(PTS, "delta_clamps_at_mid_stream_reset")[:2] == \
        [35.0, pytest.approx(0.35)]
    assert _run(PTS, "window_spanning_only_the_reset") == [5.0]
    d = _run(PTS, "attempt_rekeying")
    assert d[0] == 16.0 + 16.0        # the re-keyed and the naive series
    assert {ls["attempt"] for ls in d[3] if "attempt" in ls} == {"0", "1"}
    assert _run(PTS, "old_attempt_expires")[:2] == \
        [1, [{"replica": "r1", "attempt": "1"}]]
    assert _run(PTS, "single_point_window") == [0.0, 0.0]
    assert _run(PTS, "quantile_within_bucket_width")[5] == 4.0
    assert _run(PTS, "quantile_uses_window_deltas")[0] > 2.0
    assert _run(PTS, "histogram_reset")[0] <= 1.0
    assert _run(PTS, "empty_window") == [None, None]
    assert _run(PTS, "fraction_over")[1] == pytest.approx(0.5)
    assert _run(PTS, "fraction_over")[3] == pytest.approx(0.1)
    assert _run(PTS, "ewma_time_aware")[0] == pytest.approx(10.0 / 1.5)
    assert _run(PTS, "ewma_single") == [4.0]
    assert _run(PTS, "latest_absent_vs_zero")[:2] == [0.0, None]
    snap = _run(PTS, "window_snapshot_doctor_shape")[0]
    assert set(snap) == {"counters", "gauges", "histograms",
                         "pending_collectives", "window_seconds",
                         "timestamp"}
    assert snap["counters"]["c"][0] == {"labels": {"replica": "r0"},
                                        "value": 30.0}
    assert snap["gauges"]["g"][0]["value"] == 2.0


def test_ring_depth_and_max_age_as_reference():
    for mod in (PTS, JTS):
        assert mod.DEFAULT_MAX_POINTS == 256
        assert mod.DEFAULT_MAX_AGE_S == 120.0
    stores = [mod.TimeSeriesStore(max_points=3, max_age_s=7.5)
              for mod in (PTS, JTS)]
    for st in stores:
        for dt, v in [(0, 1), (1, 2), (2, 3), (3, 9), (4, 10)]:
            st.append_snapshot(_snap(counters={"c": [({}, v)]}),
                               ts=T0 + dt)
    got = [(st.delta("c", 100, now=T0 + 4), st.expire(now=T0 + 11.6),
            st.series_count(), st.max_age_s) for st in stores]
    assert got[0] == got[1] == (7.0, 1, 0, 7.5)


# ---------------------------------------------------------------------------
# LocalSampler over the port's registry
# ---------------------------------------------------------------------------

@pytest.fixture
def registry():
    PM.reset_metrics()
    yield PM
    PM.reset_metrics()


def test_sample_once_reads_the_ports_registry(registry):
    # sample_once expires series past max_age_s on the real clock
    t0 = time.time()
    st = PTS.TimeSeriesStore()
    seen = []
    s = PTS.LocalSampler(st, interval_s=60, labels={"replica": "r0"},
                         on_sample=lambda snap, ts: seen.append((snap, ts)))
    registry.counter("collective_calls_total", kind="allreduce").inc(3)
    s.sample_once(ts=t0)
    registry.counter("collective_calls_total", kind="allreduce").inc(5)
    registry.gauge("world_size").set(2)
    s.sample_once(ts=t0 + 1)
    assert st.delta("collective_calls_total", 10, now=t0 + 1,
                    labels={"kind": "allreduce", "replica": "r0"}) == 5.0
    assert st.rate("collective_calls_total", 2, now=t0 + 1) == 2.5
    assert st.latest("world_size") == 2.0
    assert [ts for _, ts in seen] == [t0, t0 + 1]
    assert seen[1][0]["counters"]["collective_calls_total"][0]["value"] == 8
    # an observer that raises never stops sampling
    s.on_sample = lambda snap, ts: 1 / 0
    s.sample_once(ts=t0 + 2)
    assert st.last_update() == t0 + 2


def test_sampler_samples_the_reference_store_the_same(registry):
    """The port's sampler feeding both packages' stores: the same window
    snapshot (its registry snapshot is the reference's shape)."""
    stores = [PTS.TimeSeriesStore(), JTS.TimeSeriesStore()]
    registry.histogram("negotiation_seconds").observe(0.003)
    for i in range(3):
        registry.counter("collective_calls_total", kind="broadcast").inc()
        registry.histogram("negotiation_seconds").observe(0.01 * (i + 1))
        snap = registry.snapshot()
        for st in stores:
            st.append_snapshot(snap, ts=T0 + i)
    got = [st.window_snapshot(5, now=T0 + 2) for st in stores]
    assert json.dumps(got[0], sort_keys=True) == \
        json.dumps(got[1], sort_keys=True)
    assert got[0]["counters"]["collective_calls_total"][0]["value"] == 2.0
    assert got[0]["histograms"]["negotiation_seconds"][0]["count"] == 2
    q = [st.quantile("negotiation_seconds", 0.5, 5, now=T0 + 2)
         for st in stores]
    assert q[0] == q[1]


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == "hvd-ts-sampler"]


def test_start_stop_leaves_no_thread(registry):
    before = len(_sampler_threads())
    st = PTS.TimeSeriesStore()
    s = PTS.LocalSampler(st, interval_s=0.01)
    assert s.interval_s == 0.05               # clamped, as the reference
    assert s.start() is s and s.start() is s  # idempotent: one thread
    assert len(_sampler_threads()) == before + 1
    registry.counter("steps_total").inc()
    deadline = time.monotonic() + 5
    while st.latest("steps_total", kind="counter") is None:
        assert time.monotonic() < deadline, "the sampler never sampled"
        time.sleep(0.02)
    s.stop()
    assert len(_sampler_threads()) == before
    n = st.series_count()
    time.sleep(0.15)
    assert st.series_count() == n
    s.stop()                                  # a second stop is harmless
    s.start().stop()                          # and it restarts
    assert len(_sampler_threads()) == before
