"""horovod_tpu_torch.metrics == horovod_tpu.metrics.

The same registry operations run on a fresh ``Registry`` of each package;
the Prometheus text must be identical and the JSON documents equal (their
``timestamp`` aside). The stall watchdog, given the same planted pending
collective, must fire the same report (its measured ``pending_s`` aside)
and leave the same ``collective_stall`` marker in each package's timeline.
The port's own lifecycle: the flusher, the atexit drain, the callable
module, and the watchdog that ``init`` starts and ``shutdown`` stops.
"""

import json
import threading
import time

import numpy as np
import pytest

import horovod_tpu_torch as hvd
from horovod_tpu import metrics as JM
from horovod_tpu import timeline as JT
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import timeline as PT


def _counters(reg):
    reg.counter("collective_calls_total", kind="allreduce").inc()
    reg.counter("collective_calls_total", kind="allreduce").inc(4)
    reg.counter("collective_calls_total", kind="broadcast").inc(2)
    reg.counter("collective_bytes_total", kind="allreduce").inc(np.int64(96))
    reg.counter("fusion_flush_total", cause="capacity").inc()
    reg.counter("negotiation_rounds_total", path="fast").inc(0.5)


def _gauges(reg):
    reg.gauge("world_size").set(8)
    reg.gauge("optimizer_grad_norm").set(1.25)
    g = reg.gauge("some_level", device="cuda:0")
    g.inc(3)
    g.dec(4.5)
    reg.gauge("an_inf").set(float("inf"))
    reg.gauge("a_neg_inf").set(float("-inf"))


def _histograms(reg):
    h = reg.histogram("collective_dispatch_seconds", kind="allreduce")
    for v in (5e-5, 3e-4, 0.01, 0.7, 100.0):
        h.observe(v)
    reg.histogram("fusion_fill_ratio",
                  buckets=PM.RATIO_BUCKETS).observe(0.37)
    reg.histogram("fusion_bucket_bytes",
                  buckets=PM.SIZE_BUCKETS).observe(4096)
    reg.histogram("serve_ttft_seconds",
                  buckets=PM.SERVE_LATENCY_BUCKETS).observe(0.003)
    # Layout fixed by the first registration of the name.
    reg.histogram("h2", buckets=(1.0, 2.0), kind="a").observe(1.5)
    reg.histogram("h2", buckets=(5.0, 6.0), kind="b").observe(5.5)


def _escaping(reg):
    reg.counter("weird_total", path='a"b\\c\nd').inc()
    reg.counter("weird-name.x").inc()
    reg.gauge("no_help_gauge", a="1", b="2").set(7)


def _collisions(reg):
    # One name as a counter and a gauge: exported once, as the counter.
    reg.counter("dup").inc(3)
    reg.gauge("dup").set(9)


def _events(reg):
    reg.event("elastic_reset", world=4)
    reg.event("elastic_reset")


CASES = {"counters": _counters, "gauges": _gauges,
         "histograms": _histograms, "escaping": _escaping,
         "collisions": _collisions, "events": _events,
         "empty": lambda reg: None}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exporters_match_reference(case):
    regs = {"port": PM.Registry(), "reference": JM.Registry()}
    for reg in regs.values():
        CASES[case](reg)
    snaps = {k: r.snapshot() for k, r in regs.items()}
    for snap in snaps.values():
        snap["pending_collectives"] = []
    assert PM.to_prometheus(snaps["port"]) == \
        JM.to_prometheus(snaps["reference"])
    docs = {k: json.loads((PM if k == "port" else JM).to_json(s))
            for k, s in snaps.items()}
    for d in docs.values():
        assert isinstance(d.pop("timestamp"), float)
    assert docs["port"] == docs["reference"]


def test_help_table_is_the_reference_s():
    # The reference's other modules add entries at import (set_help).
    assert {k: JM._HELP[k] for k in PM._HELP} == PM._HELP
    assert PM._PREFIX == JM._PREFIX == "horovod_tpu_"
    for name in ("LATENCY_BUCKETS", "SIZE_BUCKETS", "RATIO_BUCKETS",
                 "SERVE_LATENCY_BUCKETS"):
        assert getattr(PM, name) == getattr(JM, name)


def test_collective_summary_matches_reference(monkeypatch):
    for mod in (PM, JM):
        monkeypatch.setattr(mod, "registry", mod.Registry())
        mod.registry.counter("collective_calls_total", kind="allgather").inc(3)
        mod.registry.counter("collective_bytes_total",
                             kind="allgather").inc(40)
        mod.registry.counter("collective_calls_total", kind="x").inc()
    assert PM.collective_summary() == JM.collective_summary()


@pytest.mark.parametrize("ranks", [(0, 2), (1,)])
def test_stall_report_and_marker_match_reference(tmp_path, ranks,
                                                monkeypatch):
    from collections import deque
    from horovod_tpu import collective as JC
    from horovod_tpu_torch import collective as PC
    for C in (PC, JC):          # no arrival record: no late processes
        monkeypatch.setattr(C, "_ARRIVALS", deque(maxlen=64))
    reports, markers = {}, {}
    for side, M, T in (("port", PM, PT), ("reference", JM, JT)):
        T.start_timeline(str(tmp_path / f"{side}.json"))
        tok = M.collective_begin("allreduce", name="grad/w", nbytes=1024,
                                 ranks=ranks, op_id=7)
        try:
            time.sleep(0.01)
            dog = M.StallWatchdog(timeout_s=0.001, poll_s=0.05)
            before = M.registry.counter("stall_events_total").value
            fired = dog.check_once()
            assert dog.check_once() == []           # once per stuck op
            assert M.registry.counter("stall_events_total").value == \
                before + 1
        finally:
            M.collective_end(tok)
            T.stop_timeline()
        assert len(fired) == 1
        rep = dict(fired[0])
        assert rep.pop("pending_s") > 0.001
        reports[side] = rep
        evs = json.load(open(tmp_path / f"{side}.json"))["traceEvents"]
        stall = [e for e in evs if e["name"] == "collective_stall"]
        assert len(stall) == 1
        args = dict(stall[0]["args"])
        args.pop("pending_s")
        markers[side] = (stall[0]["cat"], stall[0]["ph"], args)
    assert reports["port"] == reports["reference"]
    assert reports["port"]["tensor"] == "grad/w"
    assert reports["port"]["waiting_ranks"] == list(ranks)
    assert markers["port"] == markers["reference"]


def test_watchdog_thread_fires_and_names_the_tensor():
    seen = []
    tok = PM.collective_begin("broadcast", name="emb", nbytes=8)
    dog = PM.StallWatchdog(timeout_s=0.05, poll_s=0.01,
                           on_stall=seen.append).start()
    try:
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        dog.stop()
        PM.collective_end(tok)
    assert dog._thread is None
    assert [r["tensor"] for r in seen] == ["emb"]


def test_init_starts_the_watchdog_and_shutdown_stops_it(monkeypatch):
    monkeypatch.delenv("HOROVOD_STALL_CHECK_DISABLE", raising=False)
    monkeypatch.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "12.5")
    hvd.init(device="cpu")
    try:
        dog = hvd.get_stall_watchdog()
        assert dog is not None and dog.timeout_s == 12.5
        thread = dog._thread
        assert thread.is_alive() and thread in threading.enumerate()
    finally:
        hvd.shutdown()
    assert hvd.get_stall_watchdog() is None
    thread.join(timeout=5)
    assert not thread.is_alive()


def test_stall_check_disable_starts_no_watchdog(monkeypatch):
    monkeypatch.setenv("HOROVOD_STALL_CHECK_DISABLE", "1")
    hvd.init(device="cpu")
    try:
        assert hvd.get_stall_watchdog() is None
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("ext", [".prom", ".json"])
def test_flusher_from_the_environment(monkeypatch, tmp_path, ext):
    path = tmp_path / f"m{ext}"
    monkeypatch.setenv("HOROVOD_METRICS_FILE", str(path))
    monkeypatch.setenv("HOROVOD_METRICS_INTERVAL", "0.05")
    hvd.init(device="cpu")
    try:
        import torch
        hvd.allreduce(torch.ones(3), name="x")
        deadline = time.monotonic() + 5
        while not path.exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert path.exists()
    finally:
        hvd.shutdown()             # stops the flusher: one last write
    text = path.read_text()
    if ext == ".prom":
        assert 'horovod_tpu_collective_calls_total{kind="allreduce"}' in text
    else:
        doc = json.loads(text)
        assert doc["counters"]["shutdown_total"][0]["value"] >= 1


def test_hvd_metrics_is_the_snapshot_and_reset_clears_it():
    PM.counter("port_test_total").inc()
    snap = hvd.metrics()
    assert snap["counters"]["port_test_total"][0]["value"] == 1
    hvd.reset_metrics()
    assert "port_test_total" not in hvd.metrics()["counters"]
    assert PM._drain_flusher_at_exit in PM._ATEXIT_DRAINS or \
        PM._FLUSHER is None


PLANS = {
    "mixed": ([(300,), (7,), (2, 5), (40,)],
              ["float32", "float32", "bfloat16", "float32"], 512),
    "oversize": ([(1000,), (3,), (260,)], ["float32"] * 3, 1024),
    "one": ([(4, 4)], ["float32"], 64 * 1024 * 1024),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fusion_metrics_match_reference(monkeypatch, name):
    """The same tensors through each package's ``fusion.fuse``: the same
    fusion counters (flush causes included) and histograms."""
    import jax.numpy as jnp
    import torch
    from horovod_tpu import fusion as JF
    from horovod_tpu_torch import fusion as PF
    shapes, dtypes, threshold = PLANS[name]
    g = np.random.default_rng(2)
    xs = [g.standard_normal(s).astype(np.float32) for s in shapes]
    snaps = {}
    for side, M in (("port", PM), ("reference", JM)):
        monkeypatch.setattr(M, "registry", M.Registry())
        if side == "port":
            PF.fuse([torch.tensor(x).to(getattr(torch, d))
                     for x, d in zip(xs, dtypes)], threshold)
        else:
            JF.fuse([jnp.asarray(x).astype(d) for x, d in zip(xs, dtypes)],
                    threshold)
        snap = M.registry.snapshot()
        snaps[side] = {k: {n: v for n, v in snap[k].items()
                           if n.startswith("fusion_")}
                       for k in ("counters", "histograms")}
    assert snaps["port"] == snaps["reference"]
    assert snaps["port"]["counters"]["fusion_buckets_total"][0]["value"] >= 1
