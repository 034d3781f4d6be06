"""horovod_tpu_torch.profiler.doctor == horovod_tpu.profiler.doctor.

Both packages' ``doctor()`` run on the same snapshot, trace-report and
program fixtures -- the reference test's canned, healthy, low-MFU, wire,
topology, sharding, serving and request-tail fixtures, and one for each
other check -- and give equal findings on every field: category,
severity, title, detail, suggestion, evidence, rank, ``healthy`` and
``inputs``. The two suggestions that name a TPU-only remedy (a recompile's
"full XLA compile", low MFU's "MXU outputs" and ``tools/tune_tiles.py``)
are the port's own (ROADMAP.md section C), the only fields that differ.
``doctor_window`` over each package's ``TimeSeriesStore`` fed the same
points gives the same report; ``trace=`` takes a merged document, its
path and the shards. A two-rank gloo world with rank 1 planted 250 ms
late and a forced shape change is diagnosed by the port's doctor and by
``tools/torch_perf_doctor.py``: rank 1 and the blamed argument are named
(the assertions are on names and ranks, never on margins finer than the
planted delay).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from horovod_tpu import metrics as RM
from horovod_tpu import profiler as R
from horovod_tpu import timeseries as RTS
from horovod_tpu_torch import config
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import profiler as P
from horovod_tpu_torch import timeseries as PTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "torch_perf_doctor.py")
LATE_S = 0.25

# (category, field) the port rewrites: the reference's text names a remedy
# that exists only on the TPU.
REWRITTEN = {("recompile", "suggestion"), ("low_mfu", "suggestion")}


@pytest.fixture(autouse=True)
def _clean():
    config.refresh()
    for reg, met in ((P.registry, PM), (R.registry, RM)):
        reg.reset()
        met.reset_metrics()
    yield
    for reg, met in ((P.registry, PM), (R.registry, RM)):
        reg.reset()
        met.reset_metrics()


def _c(value, **labels):
    return {"labels": labels, "value": value}


def _snap(counters=None, gauges=None, histograms=None, pending=None):
    return {"counters": counters or {}, "gauges": gauges or {},
            "histograms": histograms or {},
            "pending_collectives": pending or []}


def _canned():
    return _snap(
        counters={
            "recompiles_total": [_c(3, program="train_step")],
            "recompile_blame_total": [
                _c(3, program="train_step", argument="seq_len")],
            "collective_calls_total": [_c(40, kind="allreduce")]},
        histograms={"fusion_fill_ratio": [
            {"labels": {}, "count": 10, "sum": 8.0, "buckets": []}]})


def _report():
    return {"collectives": [{"op_id": i} for i in range(3)],
            "blame_seconds_by_rank": {"0": 0.004, "1": 0.25},
            "critical_path_seconds": 0.31}


def _programs(expected=False):
    return {"train_step": {
        "name": "train_step", "kind": "step", "recompiles": 3,
        "expected_recompiles": expected, "last_blame": ["seq_len"],
        "blame_detail": {"seq_len": ["128", "256"]}}}


def _rreport(dominant, mean, *, blame=None, hedged=0, worst=None):
    return {"count": 4, "hedged": hedged,
            "ttft_p50_s": sum(mean.values()),
            "ttft_p99_s": sum(mean.values()),
            "breakdown_mean_s": mean, "dominant_component": dominant,
            "replica_blame_s": blame or {}, "dominant_replica": worst,
            "requests": []}


_QUEUE = {"queue": 0.08, "prefill": 0.01, "decode": 0.005, "push": 0.0,
          "hedge_wait": 0.0, "other": 0.005}
_MB = 1024 * 1024


def _overlap_trace(spans):
    t = dict(_report())
    t["overlap"] = {"by_rank": {str(r): {"exec_spans": spans,
                                         "overlap_efficiency": 0.0}
                                for r in (0, 1)},
                    "overlap_efficiency": 0.0}
    return t


FIXTURES = {
    "canned": lambda: dict(snapshot=_canned(), trace=_report(),
                           programs=_programs()),
    "canned_no_registry": lambda: dict(snapshot=_canned(), trace=None,
                                       programs={}),
    "expected_recompiles": lambda: dict(snapshot=_canned(), trace=None,
                                        programs=_programs(expected=True)),
    "expected_offline": lambda: dict(snapshot=_snap(counters={
        "recompiles_total": [_c(3, program="train_step"),
                             _c(4, program="autotuned_step")],
        "recompile_blame_total": [
            _c(3, program="train_step", argument="seq_len")],
        "expected_recompiles_total": [_c(4, program="autotuned_step")]}),
        trace=None, programs={}),
    "recompiles_on_two_ranks": lambda: dict(snapshot=_snap(counters={
        "recompiles_total": [_c(1, program="s"), _c(1, program="s")],
        "recompile_blame_total": [_c(1, program="s", argument="x"),
                                  _c(1, program="s", argument="x")]}),
        trace=None, programs={}),
    "healthy": lambda: dict(snapshot=_snap(), trace=None, programs={}),
    "low_mfu_registry": lambda: dict(snapshot=_snap(), trace=None, programs={
        "bench:gpt2": {"name": "bench:gpt2", "expected_mfu": 0.5,
                       "last_step_seconds": 0.1,
                       "utilization": {"mfu": 0.1, "hfu": 0.3}}}),
    "low_mfu_offline": lambda: dict(snapshot=_snap(gauges={
        "program_mfu": [_c(0.1, program="bench:gpt2")],
        "program_hfu": [_c(0.3, program="bench:gpt2")],
        "program_expected_mfu": [_c(0.5, program="bench:gpt2")]}),
        trace=None, programs={}),
    "total_rejection": lambda: dict(snapshot=_snap(counters={
        "serve_requests_total": [_c(50, status="rejected")]}),
        trace=None, programs={}),
    "slo_and_memory": lambda: dict(snapshot=_snap(counters={
        "serve_requests_total": [_c(100, status="submitted"),
                                 _c(30, status="expired")],
        "memory_pressure_total": [_c(2)]}), trace=None, programs={}),
    "overlap_offline": lambda: dict(snapshot=_snap(), trace=_overlap_trace(8),
                                    programs={}),
    "overlap_too_few_spans": lambda: dict(snapshot=_snap(),
                                          trace=_overlap_trace(3),
                                          programs={}),
    "overlap_live_gauge": lambda: dict(snapshot=_snap(
        gauges={"overlap_efficiency_estimate": [_c(0.05, source="merge")]},
        counters={"allreduce_algorithm_total": [
            _c(4, algorithm="chunked_rs_ag")]}), trace=None, programs={}),
    "fusion_low_fill": lambda: dict(snapshot=_snap(histograms={
        "fusion_fill_ratio": [{"labels": {}, "count": 5, "sum": 1.0,
                               "buckets": []}]}), trace=None, programs={}),
    "wire_uncompressed": lambda: dict(snapshot=_snap(counters={
        "allreduce_wire_bytes_total": [
            _c(48 * _MB, algorithm="chunked_rs_ag", wire="fp32")]}),
        trace=None, programs={}),
    "wire_quantized": lambda: dict(snapshot=_snap(
        counters={"allreduce_wire_bytes_total": [
            _c(13 * _MB, algorithm="chunked_rs_ag_int8", wire="int8"),
            _c(1 * _MB, algorithm="psum", wire="fp32")]},
        gauges={"allreduce_compression_ratio": [_c(3.94, wire="int8")]}),
        trace=None, programs={}),
    "wire_small": lambda: dict(snapshot=_snap(counters={
        "allreduce_wire_bytes_total": [_c(1024, algorithm="psum",
                                          wire="fp32")]}),
        trace=None, programs={}),
    "topology_ring": lambda: dict(snapshot=_snap(
        gauges={"config_topology": [_c(2, dim="0"), _c(2, dim="1")]},
        counters={"allreduce_wire_bytes_total": [
            _c(48 * _MB, algorithm="chunked_rs_ag", wire="fp32",
               phase="rs")]}), trace=None, programs={}),
    "topology_2d_quiet": lambda: dict(snapshot=_snap(
        gauges={"config_topology": [_c(2, dim="0"), _c(2, dim="1")]},
        counters={"allreduce_wire_bytes_total": [
            _c(48 * _MB, algorithm="chunked_rs_ag_2d", wire="fp32",
               phase="rs0")]}), trace=None, programs={}),
    "sharding_peak_near_limit": lambda: dict(snapshot=_snap(gauges={
        "config_mesh_dp": [_c(8.0)], "config_mesh_mp": [_c(1.0)],
        "device_hbm_bytes_limit": [_c(100.0, device="0")],
        "program_peak_hbm_bytes": [_c(90.0, program="train_step")]}),
        trace=None, programs={}),
    "sharding_already_split": lambda: dict(snapshot=_snap(gauges={
        "config_mesh_dp": [_c(4.0)], "config_mesh_mp": [_c(2.0)],
        "device_hbm_bytes_limit": [_c(100.0, device="0")],
        "program_peak_hbm_bytes": [_c(99.0, program="train_step")]}),
        trace=None, programs={}),
    "sharding_kv_quant": lambda: dict(snapshot=_snap(
        gauges={"config_mesh_dp": [_c(2.0)], "config_mesh_mp": [_c(1.0)],
                "serve_kv_quant_enabled": [_c(1.0, engine="e0")],
                "serve_kv_pool_bytes_capacity": [_c(4096.0, engine="e0")]},
        counters={"serve_requests_total": [
            _c(3, engine="e0", status="rejected")]}),
        trace=None, programs={}),
    "tail_queue": lambda: dict(snapshot=_snap(), programs={}, trace={
        "requestReport": _rreport("queue", _QUEUE)}),
    "tail_hedge": lambda: dict(snapshot=_snap(), programs={}, trace={
        "requestReport": _rreport(
            "hedge_wait", {"queue": 0.005, "prefill": 0.01,
                           "decode": 0.005, "push": 0.0,
                           "hedge_wait": 0.09, "other": 0.0},
            blame={"r0": 0.36, "r1": 0.02}, hedged=3, worst="r0")}),
    "tail_push": lambda: dict(snapshot=_snap(), programs={}, trace={
        "requestReport": _rreport("push", {"queue": 0.001, "push": 0.05,
                                           "prefill": 0.002})}),
    "tail_prefill_quiet": lambda: dict(snapshot=_snap(), programs={}, trace={
        "requestReport": _rreport("prefill", {
            "queue": 0.001, "prefill": 0.2, "decode": 0.05, "push": 0.001,
            "hedge_wait": 0.0, "other": 0.002})}),
    "slo_burn_with_tail": lambda: dict(snapshot=_snap(counters={
        "serve_requests_total": [_c(100, status="submitted"),
                                 _c(30, status="expired")]}),
        programs={}, trace={"requestReport": _rreport("queue", _QUEUE)}),
    "stalls": lambda: dict(snapshot=_snap(
        counters={"stall_events_total": [_c(2)]},
        pending=[{"tensor": "grad/w"}, {"tensor": "grad/b"}]),
        trace=None, programs={}),
    "recovery_and_cadence": lambda: dict(snapshot=_snap(
        gauges={"elastic_recovery_seconds": [_c(45.0)],
                "checkpoint_restored_step": [_c(100.0)],
                "checkpoint_interval_seconds": [_c(120.0, kind="sharded"),
                                                _c(600.0, kind="full")]},
        counters={"elastic_spare_promoted_total": [_c(1)]}),
        trace=None, programs={}),
    "recovery_fast": lambda: dict(snapshot=_snap(gauges={
        "elastic_recovery_seconds": [_c(12.0)],
        "config_preemption_notice_seconds": [_c(10.0)]}),
        trace=None, programs={}),
    "prefix_and_spec": lambda: dict(snapshot=_snap(
        gauges={"serve_prompt_overlap_rate": [_c(0.6, engine="e0"),
                                              _c(0.7, engine="e1"),
                                              _c(0.1, engine="e2")],
                "prefix_cache_hit_rate": [_c(0.1, engine="e1"),
                                          _c(0.0, engine="e0",
                                             scope="fleet")],
                "prefix_cache_evictions": [_c(3, engine="e1")]},
        counters={"spec_tokens_proposed_total": [_c(100)],
                  "spec_tokens_accepted_total": [_c(10)]}),
        trace=None, programs={}),
    "transport": lambda: dict(snapshot=_snap(
        gauges={"circuit_state": [_c(1.0, replica="r1"),
                                  _c(0.0, replica="r0")]},
        counters={"circuit_open_total": [_c(2)],
                  "transport_retries_total": [_c(10)],
                  "transport_hedges_total": [_c(10)],
                  "transport_hedge_wins_total": [_c(8)],
                  "transport_frames_total": [_c(0, opcode="token")]},
        histograms={"transport_rpc_seconds": [
            {"labels": {"method": "poll"}, "count": 30, "sum": 0.3,
             "buckets": []}]}), trace=None, programs={}),
    "transport_recovered": lambda: dict(snapshot=_snap(counters={
        "circuit_open_total": [_c(1)]}), trace=None, programs={}),
    "fleet": lambda: dict(snapshot=_snap(
        gauges={"fleet_replicas": [_c(1, state="quarantined"),
                                   _c(2, state="live")],
                "fleet_target_replicas": [_c(4)]},
        counters={"fleet_restarts_total": [_c(9, reason="exit")]}),
        trace=None, programs={}),
    "roles_prefill_hot": lambda: dict(snapshot=_snap(gauges={
        "serve_role": [_c(1.0, engine="p0", role="prefill"),
                       _c(1.0, engine="d0", role="decode")],
        "serve_slots_active": [_c(8, engine="p0"), _c(0, engine="d0")],
        "serve_slots_total": [_c(8, engine="p0"), _c(8, engine="d0")],
        "serve_queue_depth": [_c(3, engine="p0")],
        "fleet_role_replicas": [_c(0, state="live", role="prefill"),
                                _c(2, state="live", role="decode")]}),
        trace=None, programs={}),
    "roles_decode_hot": lambda: dict(snapshot=_snap(gauges={
        "serve_role": [_c(1.0, engine="p0", role="prefill"),
                       _c(1.0, engine="d0", role="both")],
        "serve_slots_active": [_c(0, engine="p0"), _c(8, engine="d0")],
        "serve_slots_total": [_c(8, engine="p0"), _c(8, engine="d0")],
        "fleet_role_replicas": [_c(1, state="live", role="prefill"),
                                _c(0, state="live", role="decode")]}),
        trace=None, programs={}),
    "straggler_only": lambda: dict(snapshot=_snap(), trace={
        "stragglerReport": _report(), "traceEvents": []}, programs={}),
    "everything": lambda: dict(
        snapshot={k: {**FIXTURES["canned"]()["snapshot"][k],
                      **FIXTURES["transport"]()["snapshot"][k],
                      **FIXTURES["fleet"]()["snapshot"][k]}
                  for k in ("counters", "gauges", "histograms")},
        trace=_overlap_trace(8), programs=_programs()),
}


def _both(kw):
    return P.doctor(**kw), R.doctor(**kw)


def _assert_same_report(port, ref):
    assert port["healthy"] == ref["healthy"]
    assert port["inputs"] == ref["inputs"]
    assert len(port["findings"]) == len(ref["findings"])
    for a, b in zip(port["findings"], ref["findings"]):
        assert set(a) == set(b)
        for key in a:
            if (a["category"], key) in REWRITTEN:
                continue
            assert a[key] == b[key], (a["category"], key)
        for cat, key in REWRITTEN:
            if a["category"] == cat:
                assert a[key] == PORT_TEXT[cat] != b[key]


PORT_TEXT = {
    "recompile": (
        "hold shapes/dtypes/static arguments constant across steps: pad "
        "ragged batches (horovod_tpu_torch.data's ShardedBatchIterator "
        "keeps them whole), pin serving geometry. Each new signature "
        "allocates its buffers afresh in the caching allocator and runs "
        "once under the cost capture (HOROVOD_PROFILER_COST)."),
    "low_mfu": (
        "try remat_policy='dots' (saves the matmul outputs), a larger "
        "per-card batch, and read the step's kernels in a capture "
        "(hvd.profile()) to decide compute- vs bandwidth-bound before "
        "tuning further."),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_doctor_equals_the_reference(name):
    port, ref = _both(FIXTURES[name]())
    _assert_same_report(port, ref)
    json.loads(json.dumps(port))
    text = P.format_report(port)
    for f in port["findings"]:
        assert f["title"] in text and f["suggestion"] in text
    assert [f["rank"] for f in port["findings"]] == list(
        range(1, len(port["findings"]) + 1))


def test_fixtures_reach_every_check():
    cats = set()
    for name in FIXTURES:
        cats |= {f["category"] for f in P.doctor(**FIXTURES[name]())
                 ["findings"]}
    assert cats == {
        "stall", "straggler", "request_tail", "recompile",
        "memory_pressure", "sharding", "recovery", "checkpoint_cadence",
        "serving_slo", "serving_backpressure", "prefix_cache",
        "spec_decode", "transport_breaker", "transport_retries",
        "transport_poll_mode", "transport_hedging", "fleet_quarantine",
        "fleet_capacity", "fleet_restart_burn", "role_imbalance", "low_mfu",
        "low_overlap", "fusion_fill", "wire_compression",
        "wire_uncompressed", "topology_ring"}


def test_report_text_and_healthy_run():
    rep = P.doctor(**FIXTURES["healthy"]())
    assert rep["healthy"] is True and rep["findings"] == []
    assert P.format_report(rep) == R.format_report(rep)
    assert "nothing looks sick" in P.format_report(rep)
    rep = P.doctor(**FIXTURES["canned"]())
    ref = R.doctor(**FIXTURES["canned"]())
    ref["findings"][[f["category"] for f in ref["findings"]].index(
        "recompile")]["suggestion"] = PORT_TEXT["recompile"]
    assert P.format_report(rep) == R.format_report(ref)


def test_live_registries_feed_the_doctor():
    """With no arguments both doctors read their live registries: the
    same note_trace sequence gives the same report."""
    for mod in (P, R):
        mod.note_trace("train_step", {"seq_len": "128"})
        mod.note_trace("train_step", {"seq_len": "256"})
    port, ref = P.doctor(), R.doctor()
    _assert_same_report(port, ref)
    assert port["findings"][0]["evidence"]["blamed_arguments"] == \
        ["seq_len"]
    assert port["inputs"] == {"snapshot": "live", "trace": "none",
                              "programs": ["train_step"]}


T0 = 1_700_000_000.0


def _window_points():
    pts = []
    for i, (rec, mem, stall) in enumerate([(0, 0, 0), (1, 0, 0), (3, 1, 0),
                                           (3, 1, 2), (5, 1, 2)]):
        pts.append((_snap(
            counters={"recompiles_total": [_c(rec, program="s")],
                      "recompile_blame_total": [
                          _c(rec, program="s", argument="x")],
                      "memory_pressure_total": [_c(mem)],
                      "stall_events_total": [_c(stall)]},
            gauges={"program_mfu": [_c(0.1 + 0.01 * i, program="s")],
                    "program_expected_mfu": [_c(0.5, program="s")]},
            histograms={"fusion_fill_ratio": [
                {"labels": {}, "count": 4 * i, "sum": 0.4 * i,
                 "buckets": [[1.0, 4 * i]]}]}), T0 + 10 * i))
    return pts


@pytest.mark.parametrize("window,now", [(100, T0 + 40), (15, T0 + 40),
                                        (5, T0 + 20), (100, T0 + 400)])
def test_doctor_window_equals_the_reference(window, now):
    stores = (PTS.TimeSeriesStore(max_age_s=3600),
              RTS.TimeSeriesStore(max_age_s=3600))
    for snap, ts in _window_points():
        for st in stores:
            st.append_snapshot(snap, ts=ts)
    port = P.doctor_window(stores[0], window, now=now)
    ref = R.doctor_window(stores[1], window, now=now)
    _assert_same_report(port, ref)
    assert port["inputs"]["snapshot"] == f"window:{float(window):g}s"


def test_trace_accepts_a_merged_doc_and_its_path(tmp_path):
    merged = {"traceEvents": [], "stragglerReport": _report()}
    path = tmp_path / "merged.json"
    path.write_text(json.dumps(merged))
    empty = _snap()
    reports = [P.doctor(snapshot=empty, trace=t, programs={})
               for t in (merged, str(path), _report())]
    cats = [[f["category"] for f in r["findings"]] for r in reports]
    assert cats[0] == cats[1] == cats[2] == ["straggler"]
    _assert_same_report(reports[1], R.doctor(snapshot=empty,
                                             trace=str(path), programs={}))


# ---------------------------------------------------------------------------
# tools/torch_perf_doctor.py
# ---------------------------------------------------------------------------

def _tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import torch_perf_doctor
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return torch_perf_doctor


def test_merge_snapshots_concatenates_series(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({
        "counters": {"x_total": [_c(1, rank="0")]},
        "pending_collectives": [{"tensor": "t"}]}))
    b.write_text(json.dumps({"counters": {"x_total": [_c(2, rank="1")]}}))
    merged = _tool()._merge_snapshots([str(a), str(b)])
    assert len(merged["counters"]["x_total"]) == 2
    assert merged["pending_collectives"] == [{"tensor": "t"}]
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import perf_doctor
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    assert perf_doctor._merge_snapshots([str(a), str(b)]) == merged


def _run_tool(*argv):
    return subprocess.Popen([sys.executable, TOOL, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_cli_exit_codes(tmp_path):
    sick = tmp_path / "sick.json"
    sick.write_text(json.dumps(_canned()))
    healthy = tmp_path / "ok.json"
    healthy.write_text(json.dumps(_snap()))
    procs = [_run_tool("--metrics", str(sick), "--json"),
             _run_tool("--metrics", str(healthy))]
    outs = [p.communicate(timeout=120) for p in procs]
    assert procs[0].returncode == 2, outs[0]
    doc = json.loads(outs[0][0])
    assert [f for f in doc["findings"] if f["category"] == "recompile"]
    _assert_same_report(doc, R.doctor(snapshot=_canned(), trace=None))
    assert procs[1].returncode == 0, outs[1]
    assert "nothing looks sick" in outs[1][0]


# ---------------------------------------------------------------------------
# a two-rank gloo world: a straggler and a forced shape change
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import profiler
    hvd.init(device="cpu")
    r = hvd.rank()
    for step in range(3):
        if r == 1 and step == 1:
            time.sleep(float(sys.argv[3]))   # planted: rank 1 arrives late
        hvd.allreduce(torch.full((4,), float(r + 1)),
                      name=f"grads_step{step}")
    for _ in range(2):                       # one lowering, issued twice
        hvd.allreduce(torch.ones(1024), algorithm="chunked_rs_ag",
                      overlap_chunks=2, name="chunked")
    # Forced recompile: the static seq_len changes between calls.
    tstep = profiler.instrument(lambda x, seq_len: x[:seq_len] * 2.0,
                                name="train_step", static_argnums=(1,))
    x = torch.arange(8.0)
    tstep(x, 8)
    tstep(x, 4)
    rec = tstep.record()
    assert rec.recompiles == 1 and rec.last_blame == ["seq_len"]
    lowering = profiler.registry.get("overlap:chunked_rs_ag")
    with open(sys.argv[2] + f".r{r}.json", "w") as f:
        f.write(hvd.metrics.to_json())
    with open(sys.argv[2] + f".r{r}.programs.json", "w") as f:
        json.dump({"traces": lowering.traces, "meta": lowering.meta,
                   "allreduce": profiler.registry.get(
                       "collective:allreduce").traces}, f)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("doctor_world")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_TIMELINE=str(tmp / "trace.json"))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "120", str(script), REPO, str(tmp / "metrics"),
         str(LATE_S)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp


def test_two_rank_doctor_names_the_late_rank_and_the_argument(two_rank_run):
    base = str(two_rank_run / "trace.json")
    snap = _tool()._merge_snapshots(
        [str(two_rank_run / f"metrics.r{r}.json") for r in (0, 1)])
    rep = P.doctor(snapshot=snap, trace=base, programs={})
    by_cat = {f["category"]: f for f in rep["findings"]}
    assert by_cat["straggler"]["evidence"]["blamed_rank"] == 1
    assert "rank 1" in by_cat["straggler"]["title"]
    rc = by_cat["recompile"]["evidence"]
    assert rc["program"] == "train_step" and rc["ranks"] == 2
    assert rc["blamed_arguments"] == ["seq_len"] and rc["recompiles"] == 1
    sev = [f["severity"] for f in rep["findings"]]
    assert sev == sorted(sev, reverse=True) and rep["healthy"] is False
    _assert_same_report(rep, R.doctor(snapshot=snap, trace=base,
                                      programs={}))


def test_two_rank_registries_count_first_dispatches(two_rank_run):
    for r in (0, 1):
        with open(two_rank_run / f"metrics.r{r}.programs.json") as f:
            progs = json.load(f)
        assert progs["traces"] == 1
        assert progs["meta"]["chunks"] == 2
        assert progs["meta"]["buffer_bytes"] == 4096
        assert progs["allreduce"] == 2      # (4,) and (1024,): once each


def test_cli_diagnoses_the_two_rank_world(two_rank_run):
    argv = ["--trace", str(two_rank_run / "trace.json"), "--json"]
    for r in (0, 1):
        argv += ["--metrics", str(two_rank_run / f"metrics.r{r}.json")]
    p = _run_tool(*argv)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 2, err[-2000:]
    cats = {f["category"]: f for f in json.loads(out)["findings"]}
    assert cats["straggler"]["evidence"]["blamed_rank"] == 1
    assert cats["recompile"]["evidence"]["blamed_arguments"] == ["seq_len"]
