"""horovod_tpu_torch.blackbox == horovod_tpu.blackbox, on the CPU.

Each case of ``tests/test_blackbox.py`` runs on both packages (the ring's
byte and age bounds under a storm, strict oldest-first eviction, a dump
during a dump refused, the debounce, token gating, unknown tokens, a dump
with the registry lock held, retention, the timeline tap, a disabled
recorder as a total no-op, the ranked crash loop, the newest bundle, no
bundles); the rotated alerts tail is read by both readers from files
written by hand (the reference's rotation case needs ``health``, not
ported yet). Across the packages: the same canned feeds give bundles with
the same files, events, snapshots and trace tails apart from pid, host and
time; each package's ``postmortem_report`` ranks the other's bundle the
same, ``format_postmortem`` renders the same text and both CLIs exit
alike. The wiring: a watchdog fire publishes one ``stall`` bundle, a
fault-plan kill of the elastic worker publishes a ``fault`` bundle before
the SIGKILL, SIGTERM writes a ``signal`` bundle and keeps the exit status,
``init`` installs the crash hooks and ``shutdown`` stops the feeds, and a
bundle's ``config.json`` never carries the ``serve_auth_token`` value.
Every comparison is exact (no tolerance): the bundles hold host records.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import pytest

from horovod_tpu import blackbox as RB
from horovod_tpu import confbus as RBUS
from horovod_tpu import config as RC
from horovod_tpu import metrics as RM
from horovod_tpu import profiler as RP
from horovod_tpu import timeline as RT
from horovod_tpu_torch import blackbox as PB
from horovod_tpu_torch import confbus as PBUS
from horovod_tpu_torch import config as PC
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import profiler as PP
from horovod_tpu_torch import timeline as PT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "port": types.SimpleNamespace(blackbox=PB, config=PC, metrics=PM,
                                  profiler=PP, timeline=PT, confbus=PBUS),
    "reference": types.SimpleNamespace(blackbox=RB, config=RC, metrics=RM,
                                       profiler=RP, timeline=RT,
                                       confbus=RBUS),
}


def _scrub_env():
    for k in list(os.environ):
        if k.startswith("HOROVOD_BLACKBOX") or k in (
                "HOROVOD_FAULTHANDLER", "HOROVOD_HEALTH_ALERTS_FILE",
                "HOROVOD_SERVE_AUTH_TOKEN"):
            del os.environ[k]


def _reset_all():
    for p in PKGS.values():
        p.blackbox.reset()
        p.config.refresh()
        p.confbus.reset()   # both buses count their epochs from 0
        p.metrics.reset_metrics()


@pytest.fixture(autouse=True)
def _fresh():
    _scrub_env()
    _reset_all()
    yield
    _scrub_env()
    _reset_all()


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _arm(p, tmp_path, **env):
    """Arm ``p``'s process recorder onto a test-owned dir."""
    os.environ["HOROVOD_BLACKBOX"] = "1"
    os.environ["HOROVOD_BLACKBOX_DIR"] = str(tmp_path)
    os.environ.update(env)
    p.config.refresh()
    rec = p.blackbox.ensure(rank=0, world=2)
    assert rec is not None
    return rec


def test_public_names_are_the_references():
    assert PB.__all__ == RB.__all__
    for name in PB.__all__:
        assert hasattr(PB, name)
    for name in ("ALERT_DUMP_SEVERITY", "AUTO_DUMP_MIN_INTERVAL_S",
                 "_FORCE_TRIGGERS", "_TRIGGER_TOKEN", "_REGISTRY_PROBE_S"):
        assert getattr(PB, name) == getattr(RB, name)
    for name in ("TIMELINE_RING_BYTES", "SNAPSHOT_RING_BYTES",
                 "EVENTS_RING_BYTES"):
        assert getattr(PB.FlightRecorder, name) == \
            getattr(RB.FlightRecorder, name)


@pytest.mark.parametrize("field,default", [
    ("blackbox", False), ("blackbox_seconds", 120.0),
    ("blackbox_dir", None), ("blackbox_max_bundles", 8),
    ("blackbox_dump_on", "signal,stall,alert,engine,fault"),
    ("faulthandler_enable", True), ("health_alerts_file", None)])
def test_config_fields_default_as_the_reference(field, default):
    assert getattr(PC.get_config(), field) == default
    assert getattr(RC.get_config(), field) == default


@pytest.mark.parametrize("env", [
    {"HOROVOD_BLACKBOX": "1", "HOROVOD_BLACKBOX_SECONDS": "7.5",
     "HOROVOD_BLACKBOX_DIR": "/x/bb", "HOROVOD_BLACKBOX_MAX_BUNDLES": "3",
     "HOROVOD_BLACKBOX_DUMP_ON": " Stall , signal,stall",
     "HOROVOD_FAULTHANDLER": "0", "HOROVOD_HEALTH_ALERTS_FILE": "/x/a.jsonl"},
    {"HOROVOD_BLACKBOX_DUMP_ON": "none"},
    {"HOROVOD_BLACKBOX_DUMP_ON": "OFF"},
    {"HOROVOD_BLACKBOX_DUMP_ON": ""}])
def test_config_reads_the_environment_as_the_reference(env):
    os.environ.update(env)
    got, want = PC.refresh(), RC.refresh()
    for f in ("blackbox", "blackbox_seconds", "blackbox_dir",
              "blackbox_max_bundles", "blackbox_dump_on",
              "faulthandler_enable", "health_alerts_file"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name,value", [
    ("HOROVOD_BLACKBOX_DUMP_ON", "signal,bogus"),
    ("HOROVOD_BLACKBOX_SECONDS", "0"),
    ("HOROVOD_BLACKBOX_SECONDS", "-1"),
    ("HOROVOD_BLACKBOX_MAX_BUNDLES", "0")])
def test_config_refuses_as_the_reference(name, value):
    os.environ[name] = value
    with pytest.raises(ValueError) as want:
        RC.refresh()
    with pytest.raises(ValueError) as got:
        PC.refresh()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# tests/test_blackbox.py, on both packages
# ---------------------------------------------------------------------------

def test_byte_bound_holds_under_storm(pkg):
    ring = pkg.blackbox.Ring(max_bytes=1024, max_age_s=3600.0)
    for i in range(5000):
        ring.append("x" * 64, ts=1000.0 + i * 0.001)
    assert ring.nbytes <= 1024
    assert len(ring) == 1024 // 64
    assert ring.dropped == 5000 - 1024 // 64


def test_eviction_is_strict_oldest_first(pkg):
    ring = pkg.blackbox.Ring(max_bytes=10 * 8, max_age_s=3600.0)
    for i in range(100):
        ring.append(f"{i:08d}", ts=1000.0 + i)
    assert ring.items(now=1100.0) == [f"{i:08d}" for i in range(90, 100)]


def test_age_bound_prunes_on_append_and_read(pkg):
    ring = pkg.blackbox.Ring(max_bytes=1 << 20, max_age_s=10.0)
    ring.append({"i": 0}, ts=1000.0)
    ring.append({"i": 1}, ts=1009.0)
    ring.append({"i": 2}, ts=1012.0)
    assert [e["i"] for e in ring.items(now=1012.0)] == [1, 2]
    assert ring.items(now=1050.0) == []
    assert ring.nbytes == 0


def test_dump_during_dump_refused_not_queued(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    assert rec._dump_gate.acquire(blocking=False)
    try:
        assert rec.dump(trigger="manual") is None
    finally:
        rec._dump_gate.release()
    assert rec.dump(trigger="manual") is not None


def test_auto_triggers_debounced_manual_not(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    assert rec.dump(trigger="alert") is not None
    assert rec.dump(trigger="alert") is None
    assert rec.dump(trigger="stall") is None
    assert rec.dump(trigger="manual") is not None


def test_dump_on_token_gating(pkg, tmp_path):
    rec = _arm(pkg, tmp_path, HOROVOD_BLACKBOX_DUMP_ON="signal")
    assert rec.dump(trigger="alert") is None
    assert rec.dump(trigger="stall") is None
    assert rec.dump(trigger="manual") is not None


def test_dump_completes_with_registry_lock_held(pkg, tmp_path):
    """A dump fired while another thread holds the registry lock still
    publishes: no final live sample, the dumps-total bump deferred to a
    daemon thread and landing once the lock is free, every thread's stack
    captured."""
    rec = _arm(pkg, tmp_path)
    pkg.metrics.counter("probe_total").inc(3)
    rec.sampler.sample_once()
    acquired, release = threading.Event(), threading.Event()

    def hog():
        with pkg.metrics.registry._lock:
            acquired.set()
            release.wait(10.0)

    t = threading.Thread(target=hog, daemon=True)
    t.start()
    assert acquired.wait(5.0)
    try:
        bundle = rec.dump(trigger="signal")
    finally:
        release.set()
        t.join(5.0)
    assert bundle is not None and os.path.isdir(bundle)
    with open(os.path.join(bundle, "manifest.json")) as f:
        assert json.load(f)["sampled_final"] is False
    with open(os.path.join(bundle, "stacks.txt")) as f:
        assert "hog" in f.read()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        series = pkg.metrics.snapshot()["counters"].get(
            "blackbox_dumps_total", [])
        if sum(s["value"] for s in series
               if s["labels"].get("trigger") == "signal") >= 1:
            break
        time.sleep(0.02)
    else:
        pytest.fail("deferred blackbox_dumps_total bump never landed")


def test_retention_evicts_oldest_first(pkg, tmp_path):
    rec = _arm(pkg, tmp_path, HOROVOD_BLACKBOX_MAX_BUNDLES="2")
    bundles = [rec.dump(trigger="manual", label=f"b{i}") for i in range(3)]
    assert all(bundles)
    assert not os.path.isdir(bundles[0])
    assert os.path.isdir(bundles[1]) and os.path.isdir(bundles[2])


def test_orphaned_tmp_dirs_are_swept(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    orphan = tmp_path / ".tmp-postmortem-x.1"
    orphan.mkdir()
    assert rec.dump(trigger="manual") is not None
    assert not orphan.exists()


def test_timeline_tap_installed_and_removed(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    assert rec._tap_timeline in pkg.timeline._TAPS
    pkg.blackbox.reset()
    assert rec._tap_timeline not in pkg.timeline._TAPS


def test_disabled_is_a_total_noop(pkg):
    threads = threading.active_count()
    assert pkg.blackbox.ensure() is None
    assert pkg.blackbox.dump_postmortem() is None
    pkg.blackbox.note_fault("kill", rank=0, step=1)
    pkg.blackbox.note_fleet("quarantine", replica="r0")
    pkg.blackbox.note_config("set", knob="x")
    pkg.blackbox.on_alert({"event": "fire", "severity": 1.0})
    pkg.blackbox.on_stall({"kind": "allreduce", "tensor": "t",
                           "pending_s": 1.0})
    pkg.blackbox.on_engine_death("boom", rank=0)
    pkg.blackbox.on_init(pkg.config.get_config())
    pkg.blackbox.on_shutdown()
    assert pkg.blackbox.get() is None
    assert threading.active_count() == threads


def test_crash_loop_ranked_first_with_blamed_rank(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    pkg.metrics.counter("serve_requests_total").inc(5)
    rec.sampler.sample_once()
    pkg.blackbox.note_fault("crash_loop", rank=3, step=7,
                            detail="FAULT crash_loop@rank=3,step=7")
    pkg.blackbox.note_fleet("quarantine", replica="r3",
                            reason="crash_loop: 3 deaths in 120s")
    pkg.blackbox.on_alert({"event": "fire", "finding": "fleet_availability",
                           "severity": 0.6, "title": "fleet below target",
                           "ts": time.time()})
    bundle = pkg.blackbox.dump_postmortem(trigger="fault",
                                          note="FAULT crash_loop@rank=3")
    report = pkg.blackbox.postmortem_report(bundle)
    cause = report["cause"]
    assert cause["category"] == "crash_loop"
    assert "rank 3" in cause["title"]
    assert report["findings"][0]["rank"] == 1
    assert all(f["category"] != "fleet_availability"
               for f in report["findings"])
    with open(os.path.join(bundle, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert any(e["type"] == "alert" and
               e.get("finding") == "fleet_availability" for e in events)
    assert report["stacks_present"]
    text = pkg.blackbox.format_postmortem(report)
    assert "root cause" in text and "crash_loop" in text


def test_alert_fire_above_severity_dumps_below_rings(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    pkg.blackbox.on_alert({"event": "fire", "finding": "f", "severity": 0.5})
    assert rec.last_bundle is None
    pkg.blackbox.on_alert({"event": "fire", "finding": "g", "severity": 0.8})
    assert rec.last_bundle is not None
    assert [e["finding"] for e in rec.events.items()
            if e["type"] == "alert"] == ["f", "g"]


def test_default_report_picks_newest_bundle(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    rec.dump(trigger="manual", label="old")
    time.sleep(0.05)
    newest = rec.dump(trigger="manual", label="new")
    report = pkg.blackbox.postmortem_report(root=str(tmp_path))
    assert report["bundle"] == newest


def test_no_bundles_raises(pkg, tmp_path):
    with pytest.raises(FileNotFoundError):
        pkg.blackbox.postmortem_report(root=str(tmp_path))
    assert pkg.blackbox.find_bundles(str(tmp_path / "missing")) == []


def test_trace_tail_merges_and_window_feeds_doctor(pkg, tmp_path):
    rec = _arm(pkg, tmp_path)
    pkg.metrics.counter("demo_total").inc()
    rec.sampler.sample_once()
    rec._tap_timeline({"name": "allreduce", "ph": "X",
                       "ts": time.time() * 1e6, "dur": 10,
                       "pid": 0, "tid": 1, "args": {}})
    bundle = rec.dump(trigger="manual")
    merged = pkg.timeline.merge_timelines(
        [os.path.join(bundle, "trace")],
        output=os.path.join(str(tmp_path), "merged.json"))
    assert "allreduce" in {e.get("name") for e in merged["traceEvents"]}
    with open(os.path.join(bundle, "metrics.window.json")) as f:
        window = json.load(f)
    report = pkg.profiler.doctor(snapshot=window, trace=None, programs={})
    assert "findings" in report


def _write_lines(path, records):
    with open(path, "w") as f:
        for r in records:
            f.write((r if isinstance(r, str) else json.dumps(r)) + "\n")


@pytest.mark.parametrize("limit", [400, 7])
def test_rotated_alerts_tail_reads_as_the_reference(tmp_path, limit):
    """Two generations written by hand (``.1`` the older), a torn line and
    a blank one in them: both readers return the same records, contiguous
    across the rotation boundary and ending with the newest."""
    path = str(tmp_path / "alerts.jsonl")
    _write_lines(path + ".1", [{"event": "fire", "finding": f"f{i}",
                                "severity": 0.5, "ts": 1000.0 + i}
                               for i in range(6)] + ['{"torn": ', ""])
    _write_lines(path, [{"event": "clear", "finding": f"f{i}",
                         "ts": 1000.0 + i} for i in range(6, 12)])
    got = PB.read_alerts_tail(path, limit=limit)
    assert got == RB.read_alerts_tail(path, limit=limit)
    ids = [int(r["finding"][1:]) for r in got]
    assert ids == list(range(12 - len(ids), 12))
    assert len(ids) == min(limit, 12)
    assert PB.read_alerts_tail(str(tmp_path / "none.jsonl")) == []


def test_bundle_tail_reads_the_configured_alerts_file(pkg, tmp_path):
    path = str(tmp_path / "alerts.jsonl")
    _write_lines(path + ".1", [{"event": "fire", "finding": "old"}])
    _write_lines(path, [{"event": "fire", "finding": "new"}])
    rec = _arm(pkg, tmp_path / "bb", HOROVOD_HEALTH_ALERTS_FILE=path)
    bundle = rec.dump(trigger="manual")
    with open(os.path.join(bundle, "alerts.tail.jsonl")) as f:
        assert [json.loads(x)["finding"] for x in f] == ["old", "new"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

CANNED_SNAPS = [
    (1000.0, {"counters": {"serve_queue_depth_total": []}, "gauges": {
        "serve_queue_depth": [{"labels": {}, "value": 1.0}]},
        "histograms": {}, "pending_collectives": []}),
    (1001.0, {"counters": {}, "gauges": {
        "serve_queue_depth": [{"labels": {}, "value": 16.0}]},
        "histograms": {}, "pending_collectives": []}),
]
CANNED_TRACE = [
    {"name": "NEGOTIATE", "cat": "allreduce", "ph": "B", "ts": 10.0,
     "pid": 0, "tid": 1, "args": {"op_id": 1}},
    {"name": "NEGOTIATE", "cat": "allreduce", "ph": "E", "ts": 20.0,
     "pid": 0, "tid": 1, "args": {"op_id": 1}},
    {"name": "allreduce", "ph": "X", "ts": 25.0, "dur": 10.0, "pid": 0,
     "tid": 1, "args": {"op_id": 1}},
    {"name": "FAULT", "cat": "fault", "ph": "i", "ts": 40.0, "pid": 0,
     "tid": 0, "s": "g", "args": {"kind": "kill", "rank": 1, "step": 4}},
]


def _feed_and_dump(p, root, trigger, note):
    """One recorder of ``p``, fed the canned records, dumped once."""
    rec = _arm(p, root)
    p.metrics.counter("demo_total", kind="x").inc(2)
    p.metrics.gauge("serve_queue_depth").set(16.0)
    for ts, snap in CANNED_SNAPS:
        rec._on_sample(snap, ts)
    for ev in CANNED_TRACE:
        rec._tap_timeline(dict(ev))
    p.blackbox.note_fault("kill", rank=1, step=4,
                          detail="kill@rank=1,step=4,restart=0")
    rec.note("stall", kind="allreduce", tensor="grads", pending_s=3.25)
    p.blackbox.note_fleet("quarantine", replica="r1", reason="crash_loop")
    p.blackbox.on_alert({"event": "fire", "finding": "fleet_availability",
                         "severity": 0.6, "title": "below", "ts": 1000.5})
    return rec.dump(trigger=trigger, note=note)


def _read(bundle, rel):
    with open(os.path.join(bundle, rel)) as f:
        return f.read()


def _without(records, keys=("ts",)):
    return [{k: v for k, v in r.items() if k not in keys} for r in records]


@pytest.fixture
def twin_bundles(tmp_path):
    """The same canned feeds into both recorders (a stall bundle each)."""
    out = {}
    for name in ("reference", "port"):
        out[name] = _feed_and_dump(PKGS[name], tmp_path / name, "stall",
                                   "stall allreduce 'grads' 3.2s")
        PKGS[name].blackbox.reset()
    return out


def test_same_feeds_give_the_same_bundles(twin_bundles):
    ref, port = twin_bundles["reference"], twin_bundles["port"]
    mr = json.loads(_read(ref, "manifest.json"))
    mp_ = json.loads(_read(port, "manifest.json"))
    assert mp_["files"] == mr["files"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    assert sorted(os.listdir(os.path.join(port, "trace"))) == \
        sorted(os.listdir(os.path.join(ref, "trace")))
    varying = ("ts", "time", "pid", "host", "label", "events")
    assert {k: v for k, v in mp_.items() if k not in varying} == \
        {k: v for k, v in mr.items() if k not in varying}

    def events(b):
        # Each config bus notes each knob an env refresh mutates ("config"
        # records: arming the recorder sets two).
        recs = [json.loads(x) for x in _read(b, "events.jsonl").splitlines()]
        return _without(recs), sum(r["type"] == "config" for r in recs)

    (ep, np_), (er, nr) = events(port), events(ref)
    assert ep == er and np_ == nr == 2
    assert mp_["events"] == mr["events"] == len(ep)
    assert _read(port, "alerts.tail.jsonl").splitlines() != []
    assert _without([json.loads(x) for x in _read(
        port, "alerts.tail.jsonl").splitlines()]) == _without(
        [json.loads(x) for x in _read(ref, "alerts.tail.jsonl").splitlines()])

    def snaps(b):
        # the first line is the recorder's own first sample and the last
        # its final one, taken at different times: the canned ones between
        # are equal with their times
        return [json.loads(x) for x in _read(b, "snapshots.jsonl")
                .splitlines()]

    sp, sr = snaps(port), snaps(ref)
    assert len(sp) == len(sr) == 2 + len(CANNED_SNAPS)
    assert sp[1:-1] == sr[1:-1] == [{"ts": ts, "snapshot": s}
                                    for ts, s in CANNED_SNAPS]
    assert sp[-1]["snapshot"]["counters"]["demo_total"] == \
        sr[-1]["snapshot"]["counters"]["demo_total"]

    def trace(b):
        (name,) = os.listdir(os.path.join(b, "trace"))
        return json.loads(_read(b, os.path.join("trace", name)))

    assert trace(port) == trace(ref)


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_each_report_ranks_the_others_bundle_the_same(twin_bundles, reader):
    """Both packages' ``postmortem_report`` on one bundle: the same ranked
    findings, cause and trace summary, and the same rendered text."""
    bundle = twin_bundles["reference" if reader == "port" else "port"]
    got = PKGS[reader].blackbox.postmortem_report(bundle)
    want = PKGS["port" if reader == "reference"
                else "reference"].blackbox.postmortem_report(bundle)
    assert got["findings"] == want["findings"]
    assert got["cause"] == want["cause"]
    assert got["trace"] == want["trace"]
    assert got["cause"]["category"] == "fault_kill"
    cats = [f["category"] for f in got["findings"]]
    assert cats[0] == "fault_kill" and "stall" in cats
    assert PB.format_postmortem(got) == RB.format_postmortem(want)


def test_both_clis_exit_alike(tmp_path):
    """0 with no confident cause, 2 with one, 1 with no bundle, for each
    package's CLI on each package's bundles."""
    cases = {}
    for name in ("reference", "port"):
        rec = _arm(PKGS[name], tmp_path / name / "quiet")
        cases[f"{name}_quiet"] = rec.dump(trigger="manual")
        PKGS[name].blackbox.reset()
        cases[f"{name}_fault"] = _feed_and_dump(
            PKGS[name], tmp_path / name / "fault", "fault", "kill")
        PKGS[name].blackbox.reset()
    empty = tmp_path / "empty"
    empty.mkdir()
    code = textwrap.dedent("""
        import contextlib, io, json, runpy, sys
        tool, cases = sys.argv[1], json.loads(sys.argv[2])
        main = runpy.run_path(tool)["main"]
        out = {}
        for key, argv in cases.items():
            with contextlib.redirect_stdout(io.StringIO()) as so, \\
                    contextlib.redirect_stderr(io.StringIO()):
                out[key] = [main(argv), so.getvalue()]
        print("RESULT " + json.dumps(out))
    """)
    argvs = {"none": ["--dir", str(empty)]}
    for key, bundle in cases.items():
        argvs[key] = [bundle]
        argvs[key + "_json"] = [bundle, "--json"]
    argvs["newest"] = ["--dir", os.path.dirname(cases["port_fault"])]
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(REPO, "tools", tool),
         json.dumps(argvs)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        for name, tool in (("reference", "postmortem.py"),
                           ("port", "torch_postmortem.py"))}
    out = {}
    for name, p in procs.items():
        so, se = p.communicate(timeout=120)
        assert p.returncode == 0, se[-3000:]
        out[name] = json.loads(so.split("RESULT ", 1)[1])
    codes = {n: {k: v[0] for k, v in o.items()} for n, o in out.items()}
    assert codes["port"] == codes["reference"]
    assert codes["port"]["none"] == 1
    assert codes["port"]["port_quiet"] == codes["port"]["reference_quiet"] \
        == 0
    assert codes["port"]["port_fault"] == codes["port"]["reference_fault"] \
        == codes["port"]["newest"] == 2
    for key in argvs:
        if key != "none":
            assert out["port"][key][1] == out["reference"][key][1], key
    assert json.loads(out["port"]["port_fault_json"][1])["cause"][
        "category"] == "fault_kill"


def test_config_json_never_carries_the_auth_token(tmp_path):
    """A deliberate divergence: the reference writes every config value
    into ``config.json``, the port writes the token as ``<redacted>``."""
    token = "s3cret-token-value"
    got = {}
    for name in ("reference", "port"):
        rec = _arm(PKGS[name], tmp_path / name,
                   HOROVOD_SERVE_AUTH_TOKEN=token)
        bundle = rec.dump(trigger="manual")
        got[name] = json.loads(_read(bundle, "config.json"))
        if name == "port":
            for root, _, files in os.walk(bundle):
                for f in files:
                    with open(os.path.join(root, f)) as fh:
                        assert token not in fh.read(), f
        PKGS[name].blackbox.reset()
    assert got["reference"]["serve_auth_token"] == token
    assert got["port"]["serve_auth_token"] == "<redacted>"
    os.environ.pop("HOROVOD_SERVE_AUTH_TOKEN")
    PC.refresh()
    rec = _arm(PKGS["port"], tmp_path / "unset")
    assert json.loads(_read(rec.dump(trigger="manual"), "config.json"))[
        "serve_auth_token"] == ""


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

def test_a_watchdog_fire_publishes_one_stall_bundle(tmp_path):
    _arm(PKGS["port"], tmp_path)
    dog = PM.StallWatchdog(timeout_s=0.01)
    tokens = [PM.collective_begin("allreduce", name=f"stuck{i}", nbytes=4)
              for i in range(2)]
    try:
        time.sleep(0.05)
        assert len(dog.check_once()) == 2       # two reports, one bundle
        assert dog.check_once() == []
    finally:
        for t in tokens:
            PM.collective_end(t)
    bundles = PB.find_bundles(str(tmp_path))
    assert len(bundles) == 1
    manifest = json.loads(_read(bundles[0], "manifest.json"))
    assert manifest["trigger"] == "stall" and "stuck0" in manifest["note"]
    events = [json.loads(x) for x in _read(bundles[0], "events.jsonl")
              .splitlines()]
    # arming the recorder by env and refresh() is audited by the config
    # bus: one "config" record for each of the two knobs it set
    assert [(e["type"], e.get("knob")) for e in events
            if e["type"] != "stall"] == [
        ("config", "HOROVOD_BLACKBOX"), ("config", "HOROVOD_BLACKBOX_DIR")]
    stalls = [e for e in events if e["type"] == "stall"]
    assert [e["tensor"] for e in stalls] == ["stuck0"]
    report = PB.postmortem_report(bundles[0])
    assert report["findings"][0]["category"] == "stall"
    snap = PM.snapshot()
    assert [s["value"] for s in snap["counters"]["blackbox_dumps_total"]
            if s["labels"] == {"trigger": "stall"}] == [1]


WORKER = os.path.join(REPO, "tools", "torch_elastic_worker.py")

INIT_SCRIPT = textwrap.dedent("""
    import faulthandler, json, signal, sys, threading
    sys.path.insert(0, sys.argv[1])
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import blackbox, timeline
    out = {"before": blackbox.get() is None}
    hvd.init(device="cpu")
    rec = blackbox.get()
    out["rank_world"] = [rec.rank, rec.world]
    out["sigterm"] = signal.getsignal(signal.SIGTERM) == rec._on_fatal_signal
    out["sigabrt"] = signal.getsignal(signal.SIGABRT) == rec._on_fatal_signal
    out["excepthook"] = sys.excepthook == rec._excepthook
    out["faulthandler"] = faulthandler.is_enabled()
    out["tap"] = rec._tap_timeline in timeline._TAPS
    out["sampler"] = "hvd-ts-sampler" in [t.name for t in threading.enumerate()]
    hvd.shutdown()
    out["tap_after"] = rec._tap_timeline in timeline._TAPS
    out["sampler_after"] = "hvd-ts-sampler" in [
        t.name for t in threading.enumerate()]
    out["dump_after_shutdown"] = blackbox.dump_postmortem() is not None
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """The wiring's processes, started together: the elastic worker killed
    by its fault plan at step 3, the worker sent SIGTERM mid-training, and
    an ``init`` / ``shutdown`` under ``HOROVOD_BLACKBOX=1``."""
    root = tmp_path_factory.mktemp("blackbox_wiring")
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}
    base.update(OMP_NUM_THREADS="1", HOROVOD_BLACKBOX="1",
                HOROVOD_STALL_CHECK_DISABLE="1")
    jobs = {}
    for name in ("kill", "sigterm"):
        d = root / name
        (d / "state").mkdir(parents=True)
        env = dict(base, HOROVOD_BLACKBOX_DIR=str(d / "bb"),
                   HVD_TPU_ELASTIC_STATE_DIR=str(d / "state"),
                   HOROVOD_TIMELINE=str(d / "timeline.json"))
        if name == "kill":
            env["HOROVOD_FAULT_PLAN"] = "kill@rank=0,step=3"
        steps = "5" if name == "kill" else "100000"
        jobs[name] = (d, subprocess.Popen(
            [sys.executable, WORKER, "--model", "tiny", "--device", "cpu",
             "--steps", steps], env=env, cwd=str(d), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    d = root / "init"
    d.mkdir()
    jobs["init"] = (d, subprocess.Popen(
        [sys.executable, "-c", INIT_SCRIPT, REPO], cwd=str(d),
        env=dict(base, HOROVOD_BLACKBOX_DIR=str(d / "bb")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    # SIGTERM once the worker has logged a step: mid-training
    d, p = jobs["sigterm"]
    log = d / "state" / "steps.jsonl"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and p.poll() is None and not (
            log.exists() and log.read_text().count("\n") >= 2):
        time.sleep(0.05)
    sent = time.time()
    p.send_signal(signal.SIGTERM)
    out = {}
    for name, (d, p) in jobs.items():
        so, se = p.communicate(timeout=180)
        out[name] = {"dir": d, "rc": p.returncode, "stdout": so,
                     "stderr": se}
    out["sigterm"]["sent"] = sent
    return out


def _bundles(job):
    return PB.find_bundles(str(job["dir"] / "bb"))


def test_a_kill_fault_publishes_a_fault_bundle_before_the_process_dies(
        processes):
    job = processes["kill"]
    assert job["rc"] == -signal.SIGKILL, job["stderr"][-3000:]
    with open(job["dir"] / "state" / "steps.jsonl") as f:
        steps = [json.loads(x)["step"] for x in f if '"step"' in x]
    assert steps == [0, 1, 2]
    (bundle,) = _bundles(job)
    manifest = json.loads(_read(bundle, "manifest.json"))
    assert manifest["trigger"] == "fault"
    assert manifest["note"].startswith("kill@rank=0,step=3")
    assert (manifest["rank"], manifest["world"]) == (0, 1)
    assert manifest["files"][-1] == "manifest.json"
    held = {os.path.relpath(os.path.join(d, f), bundle)
            for d, _, files in os.walk(bundle) for f in files}
    assert held == set(manifest["files"])
    assert manifest["timeline_events"] > 0
    tool = _load_tool()
    assert tool.main(["--json", "--dir", str(job["dir"] / "bb")]) == 2
    report = PB.postmortem_report(root=str(job["dir"] / "bb"))
    cause = report["cause"]
    assert cause["category"] == "fault_kill"
    assert cause["title"].startswith("rank 0 kill")
    assert "kill@rank=0,step=3" in cause["detail"]
    assert report["trace"]["events"] > 0


def test_sigterm_writes_a_signal_bundle_and_keeps_the_exit_status(processes):
    job = processes["sigterm"]
    assert job["rc"] == -signal.SIGTERM, job["stderr"][-3000:]
    (bundle,) = _bundles(job)
    manifest = json.loads(_read(bundle, "manifest.json"))
    assert manifest["trigger"] == "signal"
    assert manifest["note"] == f"signal {int(signal.SIGTERM)}"
    stacks = _read(bundle, "stacks.txt")
    main = stacks.split("(MainThread):\n", 1)[1].split("\n\n", 1)[0]
    assert "torch_elastic_worker.py" in main and "in train" in main
    assert "_on_fatal_signal" in main
    assert manifest["ts"] >= job["sent"]


def test_init_installs_the_crash_hooks_and_shutdown_stops_the_feeds(
        processes):
    job = processes["init"]
    assert job["rc"] == 0, job["stderr"][-3000:]
    out = json.loads(job["stdout"].split("RESULT ", 1)[1])
    assert out == {"before": True, "rank_world": [0, 1], "sigterm": True,
                   "sigabrt": True, "excepthook": True,
                   "faulthandler": True, "tap": True, "sampler": True,
                   "tap_after": False, "sampler_after": False,
                   "dump_after_shutdown": True}
    logs = [f for f in os.listdir(job["dir"] / "bb")
            if f.startswith("faulthandler-")]
    assert len(logs) == 1


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_postmortem", os.path.join(REPO, "tools", "torch_postmortem.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
