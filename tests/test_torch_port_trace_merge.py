"""horovod_tpu_torch.trace_merge == horovod_tpu.trace_merge.

The same shards go through both packages' ``merge_timelines`` and must give
the same document (``json.dumps(sort_keys=True)``), the same warnings
logged (the reference's logger ``horovod_tpu``, the port's
``horovod_tpu_torch``) or the same exception type: the reference's own
synthetic shards (``tests/test_trace_merge.py``), its overlap and algorithm
fixtures (``tests/test_overlap.py``, ``tests/test_topology.py``), its
request spans (``tests/test_reqtrace.py``), the histogram ``feed_metrics``
fills, and the real shards of a two-rank gloo world of the port with a
planted late rank, which both merges must name.

The port marks ``allreduce_algorithm`` for every bucket it issues (the
reference once per compiled bucket, at trace time), so the merge's
``algorithms`` summary counts steps x buckets on the port's shards: pinned
here as a divergence of the shards, not of the merge.
"""

import json
import logging
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from horovod_tpu import metrics as JM
from horovod_tpu import trace_merge as JTM
from horovod_tpu.trace_merge import REQUEST_COMPONENTS as J_COMPONENTS
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import trace_merge as PTM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGGERS = {JTM: "horovod_tpu", PTM: "horovod_tpu_torch"}
LATE_S = 0.05            # the two-rank world's planted delay


# ---------------------------------------------------------------------------
# the reference's synthetic shards (tests/test_trace_merge.py)
# ---------------------------------------------------------------------------

def _shard(path, rank, anchor_ts, wall, events, epoch=1):
    """A synthetic rank shard: shard_meta + clock_anchor + events."""
    evs = [
        {"name": "shard_meta", "cat": "trace", "ph": "i", "ts": 0.0,
         "pid": 12345 + rank, "tid": 0, "args": {"rank": rank, "world": 2}},
        {"name": "clock_anchor", "cat": "trace", "ph": "i",
         "ts": anchor_ts, "pid": 12345 + rank, "tid": 0,
         "args": {"epoch": epoch, "wall_time": wall}},
    ] + events
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return str(path)


def _phase(name, op_id, ts, dur=50.0, pid=0, **extra):
    args = {"op_id": op_id, "kind": "allreduce",
            "tensor": f"t{op_id}", "process_set": 0}
    args.update(extra)
    return {"name": name, "cat": "phase", "ph": "X", "ts": ts, "dur": dur,
            "pid": pid, "tid": 7, "args": args}


def _two_shards(d):
    # Anchors at ts 1000 and 5000; relative to them rank 0 enqueues op 1
    # at +1000us and op 2 at +3000us, rank 1 at +1300us and +3000us.
    _shard(d / "trace.rank0.json", 0, 1000.0, 100.0,
           [_phase("NEGOTIATE", 1, 2000.0), _phase("QUEUE", 1, 2050.0),
            _phase("EXEC", 1, 2100.0, dur=400.0),
            _phase("QUEUE", 2, 4000.0), _phase("EXEC", 2, 4050.0)])
    _shard(d / "trace.rank1.json", 1, 5000.0, 100.002,
           [_phase("NEGOTIATE", 1, 6300.0), _phase("QUEUE", 1, 6350.0),
            _phase("EXEC", 1, 6400.0, dur=200.0),
            _phase("QUEUE", 2, 8000.0), _phase("EXEC", 2, 8050.0)])
    return str(d / "trace.json")


def _req_shard(path, proc, wall0, events, pid=4000):
    """A request-trace shard in the reference's ``reqtrace.flush`` form."""
    evs = [
        {"name": "process_name", "cat": "__metadata", "ph": "M",
         "ts": 0.0, "pid": pid, "tid": 0,
         "args": {"name": f"request {proc}"}},
        {"name": "shard_meta", "cat": "trace", "ph": "i", "ts": 0.0,
         "pid": pid, "tid": 0, "s": "g",
         "args": {"role": "request", "proc": proc, "pid": pid,
                  "wall0": wall0, "dropped": 0}},
    ] + events
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return str(path)


def _rspan(name, tid, ts, dur=100.0, pid=4000, **extra):
    args = {"trace_id": tid, "span_id": 1, "parent_id": 0}
    args.update(extra)
    return {"name": name, "cat": "request", "ph": "X", "ts": ts,
            "dur": dur, "pid": pid, "tid": 0, "args": args}


def _canon(doc):
    return json.dumps(doc, sort_keys=True, default=str)


def _merge_both(inputs, out_dir, caplog, feed_metrics=False):
    """Both packages' merge of ``inputs``; asserts the same documents
    (returned and written), warnings and exception type. Returns the
    port's document, or the exception type both raised."""
    got = {}
    for mod, name in LOGGERS.items():
        out = os.path.join(out_dir, f"{name}.merged.json")
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            try:
                doc, err = mod.merge_timelines(
                    inputs, out, feed_metrics=feed_metrics), None
            except Exception as e:        # compared by type below
                doc, err = None, type(e)
        logged = [r.getMessage() for r in caplog.records if r.name == name]
        disk = None
        if doc is not None:
            with open(out) as f:
                disk = json.load(f)
        got[name] = (doc, err, logged, disk)
    (jd, je, jl, jdisk), (pd, pe, pl, pdisk) = got.values()
    assert pe is je
    assert pl == jl
    if je is not None:
        return je
    assert _canon(pd) == _canon(jd)
    assert _canon(pdisk) == _canon(jdisk)
    return pd


def _case_two_shards(d):
    def check(doc):
        rep = doc["stragglerReport"]
        assert rep["ranks"] == [0, 1]
        ops = {c["op_id"]: c for c in rep["collectives"]}
        assert ops[1]["spread_seconds"] == pytest.approx(300e-6)
        assert (ops[1]["first_rank"], ops[1]["last_rank"]) == (0, 1)
        assert ops[1]["late_ranks"] == [1]
        assert ops[2]["spread_seconds"] == pytest.approx(0.0)
        assert rep["blame_seconds_by_rank"]["1"] == pytest.approx(300e-6)
        assert rep["critical_path_seconds"] == pytest.approx(550e-6)
        assert rep["clock_skew_seconds_by_rank"]["1"] == \
            pytest.approx(0.002, rel=1e-3)
        pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") != "M"}
        assert pids == {0, 1}
    return _two_shards(d), check


def _case_truncated(d):
    base = _two_shards(d)
    p1 = d / "trace.rank1.json"
    text = p1.read_text()
    p1.write_text(text[: int(len(text) * 0.6)])

    def check(doc):
        assert any("truncated/corrupt" in w
                   for w in doc["stragglerReport"]["warnings"])
        assert 0 in {e.get("pid") for e in doc["traceEvents"]}
    return base, check


def _case_corrupt(d):
    base = _two_shards(d)
    (d / "trace.rank1.json").write_text("not json at all")

    def check(doc):
        assert doc["stragglerReport"]["ranks"] == [0]
        assert doc["stragglerReport"]["collectives"] == []
    return base, check


def _case_all_corrupt(d):
    (d / "trace.rank0.json").write_text("not json")
    (d / "trace.rank1.json").write_text("[[[")
    return str(d / "trace.json"), ValueError


def _case_no_shards(d):
    return str(d / "nothing.json"), FileNotFoundError


def _case_no_anchor(d):
    _shard(d / "trace.rank0.json", 0, 100.0, 1.0,
           [_phase("QUEUE", 1, 200.0)])
    with open(d / "trace.rank1.json", "w") as f:
        json.dump({"traceEvents": [_phase("QUEUE", 1, 9000.0, pid=77)],
                   "displayTimeUnit": "ms"}, f)

    def check(doc):
        assert any("no clock_anchor" in w
                   for w in doc["stragglerReport"]["warnings"])
    return str(d / "trace.json"), check


def _case_common_epoch(d):
    # Rank 0's shard spans epochs 1-2, rank 1 was relaunched with only
    # epoch 2: alignment must use the epoch-2 barrier.
    _shard(d / "trace.rank0.json", 0, 100.0, 0.0, [
        {"name": "clock_anchor", "cat": "trace", "ph": "i",
         "ts": 60000.0, "pid": 1, "tid": 0,
         "args": {"epoch": 2, "wall_time": 60.0}},
        _phase("QUEUE", 9, 61000.0), _phase("EXEC", 9, 61050.0)])
    _shard(d / "trace.rank1.json", 1, 500.0, 60.0,
           [_phase("QUEUE", 9, 1400.0), _phase("EXEC", 9, 1450.0)],
           epoch=2)

    def check(doc):
        ops = {c["op_id"]: c for c in doc["stragglerReport"]["collectives"]}
        assert ops[9]["spread_seconds"] == pytest.approx(100e-6)
        assert ops[9]["last_rank"] == 0
    return str(d / "trace.json"), check


def _case_no_common_epoch(d):
    _shard(d / "trace.rank0.json", 0, 100.0, 0.0,
           [_phase("QUEUE", 3, 400.0)], epoch=1)
    _shard(d / "trace.rank1.json", 1, 900.0, 0.0,
           [_phase("QUEUE", 3, 1300.0)], epoch=2)

    def check(doc):
        assert any("no clock_anchor epoch is common" in w
                   for w in doc["stragglerReport"]["warnings"])
    return str(d / "trace.json"), check


def _case_merged_output_in_dir(d):
    base = _two_shards(d)
    PTM.merge_timelines(base, str(d / "trace.merged.json"),
                        feed_metrics=False)

    def check(doc):
        rep = doc["stragglerReport"]
        assert rep["ranks"] == [0, 1]
        assert {c["op_id"] for c in rep["collectives"]} == {1, 2}
    return str(d), check


def _case_duplicate_rank(d):
    _two_shards(d)
    # A copy of rank 0's shard under another name: its shard_meta says 0.
    (d / "copy.json").write_text((d / "trace.rank0.json").read_text())

    def check(doc):
        assert any("duplicate rank 0" in w
                   for w in doc["stragglerReport"]["warnings"])
        assert doc["stragglerReport"]["ranks"] == [0, 1]
    return str(d), check


def _case_explicit_list(d):
    _two_shards(d)
    return [str(d / "trace.rank1.json"), str(d / "trace.rank0.json")], None


def _case_glob(d):
    _two_shards(d)
    return str(d / "trace.rank*.json"), None


def _case_sub_floor(d):
    _shard(d / "trace.rank0.json", 0, 0.0, 1.0, [_phase("QUEUE", 1, 1000.0)])
    _shard(d / "trace.rank1.json", 1, 0.0, 1.0, [_phase("QUEUE", 1, 1030.0)])

    def check(doc):
        rep = doc["stragglerReport"]
        (c,) = rep["collectives"]
        assert c["spread_seconds"] == pytest.approx(30e-6)
        assert c["late_ranks"] == []
        assert rep["blame_seconds_by_rank"] == {"0": 0.0, "1": 0.0}
    return str(d / "trace.json"), check


def _case_negative_ids(d):
    _shard(d / "trace.rank0.json", 0, 0.0, 1.0, [_phase("EXEC", -1, 100.0)])
    _shard(d / "trace.rank1.json", 1, 0.0, 1.0, [_phase("EXEC", -1, 900.0)])

    def check(doc):
        assert doc["stragglerReport"]["collectives"] == []
        assert doc["stragglerReport"]["overlap"]["by_rank"]["0"][
            "exec_spans"] == 0
    return str(d / "trace.json"), check


def _case_request_mixed(d):
    # tests/test_trace_merge.py::TestRequestShards: rank shards, three
    # request shards (one truncated), one QUEUE span with an op_id.
    _two_shards(d)
    _req_shard(d / "reqtrace.dispatcher.101.json", "dispatcher", 100.001,
               [_rspan("SUBMIT", "t1", 500.0, dur=200.0, request="r-0"),
                _rspan("ATTEMPT", "t1", 800.0, dur=100.0, target="rank0"),
                _rspan("CLIENT_FIRST_TOKEN", "t1", 9000.0, dur=0.0,
                       ttft_s=0.009)])
    _req_shard(d / "reqtrace.rank0.102.json", "rank0", 100.003,
               [_rspan("QUEUE", "t1", 100.0, dur=1000.0, request="r-0",
                       engine="rank0", op_id=9),
                _rspan("PREFILL", "t1", 1200.0, dur=2000.0, engine="rank0"),
                _rspan("DECODE", "t1", 3500.0, dur=300.0, engine="rank0"),
                _rspan("FIRST_TOKEN", "t1", 4000.0, dur=0.0, engine="rank0",
                       ttft_s=0.009, request="r-0"),
                _rspan("PUSH_DELIVERY", "t1", 4200.0, dur=500.0)])
    p = d / "reqtrace.pump.103.json"
    _req_shard(p, "pump", 100.005,
               [_rspan("PUSH_DELIVERY", "t2", float(ts), dur=50.0)
                for ts in range(0, 1200, 200)])
    text = p.read_text()
    p.write_text(text[: int(len(text) * 0.55)])

    def check(doc):
        evs = doc["traceEvents"]
        assert {e["pid"] for e in evs if e.get("ph") != "M"} == \
            {0, 1, 1000, 1001, 1002}
        submit = next(e for e in evs if e.get("name") == "SUBMIT")
        assert submit["ts"] == pytest.approx(6500.0)
        assert {c["op_id"] for c in doc["stragglerReport"][
            "collectives"]} == {1, 2}
        rec = next(r for r in doc["requestReport"]["requests"]
                   if r["trace_id"] == "t1")
        assert rec["breakdown_s"]["hedge_wait"] == pytest.approx(3e-4)
        assert rec["breakdown_s"]["prefill"] == pytest.approx(2e-3)
    return str(d), check


def _case_request_only(d):
    _req_shard(d / "reqtrace.dispatcher.201.json", "dispatcher", 200.0,
               [_rspan("SUBMIT", "t9", 100.0, dur=50.0, request="r-9")])
    _req_shard(d / "reqtrace.rank0.202.json", "rank0", 200.005,
               [_rspan("QUEUE", "t9", 200.0, dur=50.0)])

    def check(doc):
        queue = next(e for e in doc["traceEvents"]
                     if e.get("name") == "QUEUE")
        assert (queue["pid"], queue["ts"]) == (1001, pytest.approx(5200.0))
        assert doc["requestReport"]["count"] == 1
    return str(d), check


CASES = {
    "two_shards": _case_two_shards, "truncated": _case_truncated,
    "corrupt": _case_corrupt, "all_corrupt": _case_all_corrupt,
    "no_shards": _case_no_shards, "no_anchor": _case_no_anchor,
    "common_epoch": _case_common_epoch,
    "no_common_epoch": _case_no_common_epoch,
    "merged_output_in_dir": _case_merged_output_in_dir,
    "duplicate_rank": _case_duplicate_rank,
    "explicit_list": _case_explicit_list, "glob": _case_glob,
    "sub_floor": _case_sub_floor, "negative_ids": _case_negative_ids,
    "request_mixed": _case_request_mixed,
    "request_only": _case_request_only,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_matches_reference(case, tmp_path, caplog):
    shards = tmp_path / "shards"
    shards.mkdir()
    out = tmp_path / "out"
    out.mkdir()
    inputs, check = CASES[case](shards)
    got = _merge_both(inputs, str(out), caplog)
    if isinstance(check, type):
        assert got is check
    else:
        assert isinstance(got, dict)
        if check is not None:
            check(got)


def test_discovery_matches_reference(tmp_path):
    s0 = _shard(tmp_path / "trace.rank0.json", 0, 0.0, 1.0, [])
    s1 = _shard(tmp_path / "trace.rank1.json", 1, 0.0, 1.0, [])
    s10 = _shard(tmp_path / "trace.rank10.json", 10, 0.0, 1.0, [])
    solo = _shard(tmp_path / "solo.json", 0, 0.0, 1.0, [])
    (tmp_path / "old.merged.json").write_text("{}")
    for inputs in (str(tmp_path / "trace.json"), str(tmp_path),
                   str(tmp_path / "*.json"), [s1, s0, s1], solo,
                   str(tmp_path / "absent.json")):
        assert PTM.discover_shards(inputs) == JTM.discover_shards(inputs)
    assert PTM.discover_shards(str(tmp_path / "trace.json")) == \
        [s0, s1, s10]
    assert PTM.discover_shards(solo) == [solo]


def test_load_shard_salvage_matches_reference(tmp_path):
    p = tmp_path / "t.rank0.json"
    _shard(p, 0, 10.0, 1.0, [_phase("EXEC", k, 100.0 * k)
                             for k in range(1, 6)])
    text = p.read_text()
    for cut in (0.3, 0.55, 0.8, 1.0):
        p.write_text(text[: int(len(text) * cut)])
        assert PTM.load_shard(str(p)) == JTM.load_shard(str(p))
    assert PTM.load_shard(str(tmp_path / "gone.json"))[0] == []


# ---------------------------------------------------------------------------
# overlap_report (tests/test_overlap.py, tests/test_topology.py)
# ---------------------------------------------------------------------------

def _exec_shard(rank, intervals):
    return {"rank": rank, "events": [
        {"name": "EXEC", "ph": "X", "ts": a, "dur": b - a,
         "args": {"op_id": i + 1}} for i, (a, b) in enumerate(intervals)]}


_MARKER = {"name": "allreduce_algorithm", "ph": "i", "ts": 1.0,
           "args": {"algorithm": "rs_ag_2d", "wire": "fp32",
                    "wire_bytes": 120, "topology": "2x4",
                    "phases": {"rs_d0": 40, "rs_d1": 20,
                               "ag_d1": 20, "ag_d0": 40}}}

OVERLAP_CASES = {
    "serial_and_piped": [_exec_shard(0, [(0, 10), (10, 20), (20, 30)]),
                         _exec_shard(1, [(0, 10), (5, 15), (10, 20)])],
    "traced_and_empty": [{"rank": 0, "events": [
        {"name": "EXEC", "ts": 0, "dur": 5, "args": {"op_id": -3}},
        {"name": "QUEUE", "ts": 0, "dur": 5, "args": {"op_id": 1}}]}],
    "algorithm_markers": [{"rank": 0, "events": [_MARKER, dict(_MARKER)]},
                          {"rank": 1, "events": [_MARKER]}],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(OVERLAP_CASES))
def test_overlap_report_matches_reference(case):
    shards = OVERLAP_CASES[case]
    got = PTM.overlap_report(shards)
    assert _canon(got) == _canon(JTM.overlap_report(shards))
    if case == "serial_and_piped":
        assert got["by_rank"]["0"]["overlap_efficiency"] == 0.0
        assert got["by_rank"]["1"]["overlap_efficiency"] > 0.3
    if case == "algorithm_markers":
        assert got["algorithms"]["rs_ag_2d"]["buckets"] == 2
        assert got["algorithms"]["rs_ag_2d"]["wire_bytes"] == 240


# ---------------------------------------------------------------------------
# request_report (tests/test_reqtrace.py's spans)
# ---------------------------------------------------------------------------

def _ev(name, tid, ts, dur=0.0, **args):
    a = {"trace_id": tid, "span_id": 1, "parent_id": 0}
    a.update(args)
    return {"name": name, "cat": "request", "ph": "X", "ts": ts,
            "dur": dur, "pid": 1, "tid": 0, "args": a}


REQUEST_CASES = {
    "hedged": [
        _ev("SUBMIT", "t1", 0.0, request="r1"),
        _ev("ATTEMPT", "t1", 1_000.0, target="e0"),
        _ev("HEDGE", "t1", 50_000.0),
        _ev("ATTEMPT", "t1", 100_000.0, target="e1"),
        _ev("QUEUE", "t1", 2_000.0, dur=50_000.0, engine="e0"),
        _ev("QUEUE", "t1", 110_000.0, dur=5_000.0, engine="e1"),
        _ev("PREFILL", "t1", 120_000.0, dur=20_000.0, engine="e1"),
        _ev("DECODE", "t1", 140_000.0, dur=8_000.0, engine="e1"),
        _ev("HEDGE_WIN", "t1", 150_000.0, winner="e1"),
        _ev("FIRST_TOKEN", "t1", 150_000.0, engine="e1", ttft_s=0.16,
            request="r1"),
        _ev("DECODE", "t1", 200_000.0, dur=8_000.0, engine="e1"),
        _ev("PUSH_DELIVERY", "t1", 155_000.0, dur=2_000.0),
        _ev("CLIENT_FIRST_TOKEN", "t1", 160_000.0, ttft_s=0.16)],
    "unhedged": [
        _ev("SUBMIT", "t2", 0.0, request="r2"),
        _ev("QUEUE", "t2", 100.0, dur=1_000.0, engine="e0"),
        _ev("FIRST_TOKEN", "t2", 5_000.0, engine="e0", ttft_s=0.005)],
    "empty": [],
}
REQUEST_CASES["both_as_doc"] = {
    "traceEvents": REQUEST_CASES["hedged"] + REQUEST_CASES["unhedged"]}


@pytest.mark.parametrize("case", sorted(REQUEST_CASES))
def test_request_report_matches_reference(case):
    evs = REQUEST_CASES[case]
    got = PTM.request_report(evs)
    assert _canon(got) == _canon(JTM.request_report(evs))
    assert PTM.REQUEST_COMPONENTS == J_COMPONENTS
    if case == "hedged":
        (rec,) = got["requests"]
        assert rec["breakdown_s"]["hedge_wait"] == pytest.approx(0.1)
        assert got["replica_blame_s"]["e0"] == pytest.approx(0.1)
        assert got["dominant_component"] == "hedge_wait"
    if case == "empty":
        assert got["count"] == 0 and got["dominant_replica"] is None


# ---------------------------------------------------------------------------
# feed_metrics: the histogram and gauge the merge fills
# ---------------------------------------------------------------------------

def _merge_series(snap):
    hist = [s for s in snap["histograms"].get(
        "collective_arrival_spread_seconds", [])
        if s["labels"].get("source") == "merge"]
    gauge = [s for s in snap["gauges"].get("overlap_efficiency_estimate", [])
             if s["labels"].get("source") == "merge"]
    return hist, gauge


def test_feed_metrics_fills_the_references_series(tmp_path, caplog):
    base = _two_shards(tmp_path)
    JM.reset_metrics()
    PM.reset_metrics()
    try:
        _merge_both(base, str(tmp_path), caplog, feed_metrics=True)
        want, got = _merge_series(JM.snapshot()), _merge_series(PM.snapshot())
    finally:
        JM.reset_metrics()
        PM.reset_metrics()
    assert _canon(got) == _canon(want)
    (hist,), (gauge,) = got
    assert hist["count"] == 2
    assert hist["sum"] == pytest.approx(300e-6)
    assert 'horovod_tpu_collective_arrival_spread_seconds_count{' \
        'source="merge"} 2' in PM.to_prometheus({
            "counters": {}, "gauges": {},
            "histograms": {"collective_arrival_spread_seconds": [hist]}})
    assert gauge["value"] == 0.0


# ---------------------------------------------------------------------------
# the port's own shards: a two-rank gloo world, a reset, a late rank
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="before/reset")
    # An elastic-style reset: the shard is rewritten by the new epoch's
    # timeline, whose clock_anchor carries epoch 2 on every rank.
    hvd.shutdown()
    hvd.init(device="cpu")
    r = hvd.rank()
    for i in range(3):
        hvd.allreduce(torch.full((4,), float(r)), name=f"warm{i}")
    hvd.allreduce(torch.ones(1), name="sync")
    if r == 1:
        time.sleep(float(sys.argv[2]))
    hvd.allreduce(torch.ones(8), name="late/planted")
    for i in range(2):
        hvd.allgather(torch.full((2,), float(r)), name=f"after{i}")
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def two_rank_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace_world")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_TIMELINE=str(tmp / "trace.json"))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "120", str(script), REPO, str(LATE_S)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp


def test_two_rank_world_merges_as_reference_and_names_the_late_rank(
        two_rank_shards, tmp_path, caplog):
    base = str(two_rank_shards / "trace.json")
    doc = _merge_both(base, str(tmp_path), caplog)
    rep = doc["stragglerReport"]
    assert rep["ranks"] == [0, 1]
    assert "warnings" not in rep
    by_name = {c["tensor"]: c for c in rep["collectives"]}
    # every positive op id is on both tracks, in one order
    tracks = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "phase":
            tracks.setdefault(e["pid"], []).append(
                (e["args"]["op_id"], e["name"]))
    assert sorted(tracks) == [0, 1] and tracks[0] == tracks[1]
    planted = by_name["late/planted"]
    assert planted["last_rank"] == 1 and planted["late_ranks"] == [1]
    assert planted["spread_seconds"] >= 0.9 * LATE_S
    assert rep["blame_seconds_by_rank"]["1"] >= 0.9 * LATE_S
    others = [c["spread_seconds"] for t, c in by_name.items()
              if t != "late/planted"]
    assert max(others) < 0.5 * LATE_S
    # op ids restarted with the new epoch: "before/reset" is in no shard
    assert "before/reset" not in by_name
    assert sorted(c["op_id"] for c in rep["collectives"]) == \
        list(range(1, len(rep["collectives"]) + 1))


@pytest.mark.parametrize("rank", [0, 1])
def test_reset_epochs_reach_anchor_selection_as_reference(two_rank_shards,
                                                          rank):
    path = str(two_rank_shards / f"trace.rank{rank}.json")
    evs, warnings = PTM.load_shard(path)
    assert not warnings and (evs, warnings) == JTM.load_shard(path)
    anchors = PTM._find_anchors(evs)
    assert _canon(anchors) == _canon(JTM._find_anchors(evs))
    assert sorted(anchors) == [2]
    assert any(e["name"] == "elastic_epoch" and e["args"]["epoch"] == 2
               for e in evs)
    shards = [{"rank": r, "anchors": PTM._find_anchors(
        PTM.load_shard(str(two_rank_shards / f"trace.rank{r}.json"))[0])}
        for r in (0, 1)]
    got = PTM._select_anchor_epoch(shards)
    assert _canon(got) == _canon(JTM._select_anchor_epoch(shards))
    assert got[0][rank]["args"]["epoch"] == 2 and got[1] == []


# ---------------------------------------------------------------------------
# the CLI (tests/test_trace_merge.py::TestCli against the port's tool)
# ---------------------------------------------------------------------------

CLI = os.path.join(REPO, "tools", "torch_trace_merge.py")


@pytest.fixture(scope="module")
def cli_runs(two_rank_shards, tmp_path_factory):
    """Every CLI case, its processes started together (each pays the
    package's import once): {case: (returncode, stdout, stderr, dir)}."""
    synth = tmp_path_factory.mktemp("cli_synth")
    _two_shards(synth)
    bare = tmp_path_factory.mktemp("cli_bare")
    _two_shards(bare)
    empty = tmp_path_factory.mktemp("cli_empty")
    cases = {
        "reports": ([str(synth / "trace.json"), "-o",
                     str(synth / "m.json"), "--report", "--no-metrics"],
                    synth),
        "world": ([str(two_rank_shards / "trace.json"), "-o",
                   str(synth / "world.json"), "--report", "--no-metrics"],
                  synth),
        "no_shards": ([str(empty / "none.json")], empty),
        "default_output": ([str(bare)], bare),
    }
    procs = {k: subprocess.Popen([sys.executable, CLI] + argv,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (argv, _) in cases.items()}
    out = {}
    for k, proc in procs.items():
        so, se = proc.communicate(timeout=120)
        out[k] = (proc.returncode, so, se, cases[k][1])
    return out


def test_cli_merges_and_reports(cli_runs):
    rc, so, se, d = cli_runs["reports"]
    assert rc == 0, se
    rep = json.loads(so)
    assert {c["op_id"] for c in rep["collectives"]} == {1, 2}
    with open(d / "m.json") as f:
        assert json.load(f)["traceEvents"]
    assert "merged 2 rank shard(s)" in se


def test_cli_merges_the_worlds_shards(cli_runs):
    rc, so, se, d = cli_runs["world"]
    assert rc == 0, se
    rep = json.loads(so)
    assert {c["tensor"]: c["last_rank"] for c in rep["collectives"]}[
        "late/planted"] == 1
    with open(d / "world.json") as f:
        assert json.load(f)["stragglerReport"] == rep


def test_cli_no_shards_nonzero_exit(cli_runs):
    rc, _, se, _ = cli_runs["no_shards"]
    assert rc == 1
    assert "no timeline shards found" in se


def test_cli_default_output_next_to_the_shards(cli_runs):
    rc, _, se, d = cli_runs["default_output"]
    assert rc == 0, se
    with open(d / "trace.merged.json") as f:
        assert json.load(f)["stragglerReport"]["ranks"] == [0, 1]


# ---------------------------------------------------------------------------
# the shards' divergence: a marker for every bucket the port issues
# ---------------------------------------------------------------------------

def test_algorithm_markers_count_every_issued_bucket(tmp_path, monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import fusion
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    steps = 3
    path = str(tmp_path / "trace.json")
    hvd.start_timeline(path)
    hvd.init(device="cpu")
    try:
        g = torch.Generator().manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(16, 24),
                                    torch.nn.Tanh(), torch.nn.Linear(24, 8))
        for p in model.parameters():
            p.data.copy_(torch.randn(p.shape, generator=g))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1))
        grads = [p for p in model.parameters()]
        plan = len(fusion.make_plan([p.numel() for p in grads],
                                    [p.dtype for p in grads], 1024).buckets)
        n0 = sum(s["value"] for s in PM.snapshot()["counters"].get(
            "allreduce_algorithm_total", []))
        x = torch.randn(4, 16, generator=g)
        for _ in range(steps):
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step()
        n1 = sum(s["value"] for s in PM.snapshot()["counters"].get(
            "allreduce_algorithm_total", []))
    finally:
        hvd.stop_timeline()
        hvd.shutdown()
    assert plan > 1
    doc = PTM.merge_timelines(path, feed_metrics=False)
    algs = doc["stragglerReport"]["overlap"]["algorithms"]
    assert sum(a["buckets"] for a in algs.values()) == steps * plan
    assert n1 - n0 == steps * plan
    assert doc == JTM.merge_timelines(path, feed_metrics=False)
