"""horovod_tpu_torch.confbus: the config bus, held against the reference's
(``horovod_tpu/confbus.py``) on the same inputs.

Each case of ``tests/test_confbus.py``'s ``TestMutationPath``,
``TestSecretMasking``, ``TestExperiments`` and ``TestViewsAndHttp`` runs
once on each package, one after the other, from the same environment:
its own ledger file, epoch 0, a clean metrics registry, its own timeline.
What each run leaves is then compared exactly -- the results, the ledger
lines, the ``config_*`` series, the ``CONFIG`` timeline markers, the views
and the experiment verdicts over the same canned store -- but the
fields that name a time or a process (``ts``, ``t0``, ``who``) and the
package's own name in a log line. The reference's
``health.check_config_regression`` step is not run: the health plane is
not ported (ROADMAP.md section A item 9c-ii-b), nor is
``TestConfigSmoke``, whose fleet waits for item 10d.

Two cases are the port's own: an elastic re-form into another world
changes only the port's rendezvous fields, which the bus does not audit
(no epoch, no ledger line, no WARN); and a refresh after init writes the
same "config" records into a flight-recorder bundle as the reference's.

Every case restores ``os.environ`` whole, resets both buses and both
metric registries, and gives both loggers their levels back: ``set_config``
writes the environment, and later files on the same worker read it.
"""

import json
import logging
import os
import socket
import types
import urllib.error
import urllib.request

import pytest

import horovod_tpu as jhvd
from horovod_tpu import blackbox as RB
from horovod_tpu import confbus as RBUS
from horovod_tpu import config as RC
from horovod_tpu import metrics as RM
from horovod_tpu import timeline as RT
from horovod_tpu import timeseries as RTS

import horovod_tpu_torch as hvd
from horovod_tpu_torch import blackbox as PB
from horovod_tpu_torch import confbus as PBUS
from horovod_tpu_torch import config as PC
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import timeline as PT
from horovod_tpu_torch import timeseries as PTS

TOKEN = "hunter2hunter2"
VARYING = ("ts", "t0", "who")

PKGS = {
    "reference": types.SimpleNamespace(
        name="horovod_tpu", hvd=jhvd, bus=RBUS, config=RC, metrics=RM,
        timeline=RT, timeseries=RTS, blackbox=RB),
    "port": types.SimpleNamespace(
        name="horovod_tpu_torch", hvd=hvd, bus=PBUS, config=PC, metrics=PM,
        timeline=PT, timeseries=PTS, blackbox=PB),
}


def _reset_both():
    for p in PKGS.values():
        p.bus.reset()
        p.metrics.reset_metrics()


@pytest.fixture(autouse=True)
def clean_process():
    """The whole process as it was: environment, both configs, both
    buses, both registries, both loggers' levels."""
    env = dict(os.environ)
    levels = {n: logging.getLogger(n).level
              for n in ("horovod_tpu", "horovod_tpu_torch")}
    yield
    for p in PKGS.values():
        p.bus.reset()
        if p.timeline.get_timeline() is not None:
            p.timeline.stop_timeline()
        p.blackbox.reset()
    os.environ.clear()
    os.environ.update(env)
    for p in PKGS.values():
        p.config.refresh()
    _reset_both()
    for n, lv in levels.items():
        logging.getLogger(n).setLevel(lv)


def _lines(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _scrub(x):
    """``x`` without the fields that name a time or a process."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items() if k not in VARYING}
    if isinstance(x, (list, tuple)):
        return [_scrub(v) for v in x]
    return x


def _config_series(snap):
    return {kind: {n: v for n, v in snap[kind].items()
                   if n.startswith("config_")}
            for kind in ("counters", "gauges")}


def _markers(path):
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    return [e["args"] for e in evs if e.get("name") == "CONFIG"]


def _run(name, tmp_path, scenario, env=None, caplog=None):
    """``scenario(p, ledger)`` on package ``name``, from the environment
    the test started with plus ``env``: a fresh ledger, epoch 0, a clean
    registry and a timeline of its own. Returns what it left."""
    p = PKGS[name]
    base = dict(os.environ)
    d = tmp_path / name
    d.mkdir()
    ledger = d / "ledger.jsonl"
    os.environ["HOROVOD_CONFIG_LEDGER"] = str(ledger)
    os.environ.update(env or {})
    p.config.refresh()
    _reset_both()
    if ledger.exists():
        ledger.unlink()
    trace = d / "trace.json"
    p.timeline.start_timeline(str(trace))
    if caplog is not None:
        caplog.clear()
    try:
        out = scenario(p, ledger)
    finally:
        p.timeline.stop_timeline()
    left = {"out": out, "ledger": _lines(ledger),
            "series": _config_series(p.metrics.snapshot()),
            "markers": _markers(trace), "epoch": p.bus.epoch(),
            "view": p.bus.config_view(),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith("HOROVOD_")}}
    if caplog is not None:
        left["log"] = [r.getMessage() for r in caplog.records
                       if r.name == p.name]
    p.bus.reset()
    os.environ.clear()
    os.environ.update(base)
    p.config.refresh()
    p.bus.reset()
    p.metrics.reset_metrics()
    return left


def _both(tmp_path, scenario, **kw):
    """The scenario on each package; returns (port's, reference's), each
    without its times and pids, after checking they are equal."""
    ref = _run("reference", tmp_path, scenario, **kw)
    port = _run("port", tmp_path, scenario, **kw)
    for k in ("env",):
        ref[k].pop("HOROVOD_CONFIG_LEDGER")
        port[k].pop("HOROVOD_CONFIG_LEDGER")
    ref, port = _scrub(ref), _scrub(port)
    # the ledger path is the one value each run holds differently
    for side in (ref, port):
        side["view"]["values"].pop("HOROVOD_CONFIG_LEDGER")
        side["view"]["overrides"].pop("HOROVOD_CONFIG_LEDGER")
    for k in ref:
        assert port[k] == ref[k], k
    return port, ref


# ---------------------------------------------------------------------------
# TestMutationPath
# ---------------------------------------------------------------------------

def test_applied_mutation_is_fully_audited(tmp_path):
    def scenario(p, ledger):
        res = p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 25,
                               reason="tail experiment")
        cfg = p.config.get_config()
        first = (res, cfg.serve_hedge_ms,
                 os.environ["HOROVOD_SERVE_HEDGE_MS"], p.bus.epoch(),
                 _lines(ledger))
        res2 = p.hvd.set_config("serve_hedge_ms", 30)
        p.config.refresh()
        return {"first": first, "second": res2, "epoch": p.bus.epoch(),
                "hedge": p.config.get_config().serve_hedge_ms}

    port, _ = _both(tmp_path, scenario)
    res, hedge, env, ep, recs = port["out"]["first"]
    assert res["ok"] and res["outcome"] == "applied"
    assert res["epoch"] == 1 and res["scope"] == "fleet"
    assert (hedge, env, ep) == (25.0, "25", 1)
    [rec] = recs
    assert (rec["old"], rec["new"], rec["reason"], rec["origin"]) == \
        (0.0, 25.0, "tail experiment", "api")
    assert port["out"]["second"]["epoch"] == 2
    assert (port["out"]["epoch"], port["out"]["hedge"]) == (2, 30.0)
    [g] = port["series"]["gauges"]["config_epoch"]
    assert g["value"] == 2.0
    assert [m["epoch"] for m in port["markers"]] == [1, 2]


def test_who_names_the_origin_and_this_process(tmp_path):
    for name in PKGS:
        d = tmp_path / name
        d.mkdir()
        os.environ["HOROVOD_CONFIG_LEDGER"] = str(d / "l.jsonl")
        PKGS[name].config.refresh()
        PKGS[name].bus.reset()
        PKGS[name].hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 5)
        rec = [r for r in _lines(d / "l.jsonl")
               if r["knob"] == "HOROVOD_SERVE_HEDGE_MS"][-1]
        assert rec["who"] == f"api:pid{os.getpid()}"


def test_refusals_are_typed_and_bump_nothing(tmp_path):
    cases = [("HOROVOD_SERVE_SLOTS", "refused", "shape_affecting"),
             ("HOROVOD_SERVE_AUTH_TOKEN", "refused", "secret"),
             ("HOROVOD_TIMELINE", "refused", "immutable"),
             ("HOROVOD_NO_SUCH_KNOB", "unknown", "unknown"),
             ("HOROVOD_FUSION_THRESHOLD", "refused", "shape_affecting"),
             ("HOROVOD_XLA_LATENCY_HIDING", "refused", "immutable"),
             ("rank", "unknown", "unknown")]

    def scenario(p, ledger):
        return [p.hvd.set_config(knob, 1) for knob, _, _ in cases] + \
            [p.hvd.set_config("HOROVOD_SERVE_SLOTS", 4)]

    port, _ = _both(tmp_path, scenario)
    for (knob, outcome, code), res in zip(cases, port["out"]):
        assert not res["ok"]
        assert (res["outcome"], res["code"]) == (outcome, code), knob
        assert res["error"]
    assert "decode_compiles" in port["out"][-1]["error"]
    assert port["epoch"] == 0
    assert [r["outcome"] for r in port["ledger"]] == \
        [c[1] for c in cases] + ["refused"]
    assert "config_epoch" not in port["series"]["gauges"]


def test_the_call_site_knob_is_refused_with_the_ports_reason():
    """``HOROVOD_HIERARCHICAL_ALLREDUCE``: refused as in the reference, with
    the reason true of the port, which reads it into a Config field of its
    own (the reference reads it at each call)."""
    got, want = (p.hvd.set_config("HOROVOD_HIERARCHICAL_ALLREDUCE", 1)
                 for p in (PKGS["port"], PKGS["reference"]))
    assert {k: v for k, v in got.items() if k != "error"} == \
        {k: v for k, v in want.items() if k != "error"}
    assert (got["outcome"], got["code"]) == ("refused", "immutable")
    assert "hierarchical_allreduce" in got["error"]
    assert os.environ.get("HOROVOD_HIERARCHICAL_ALLREDUCE") is None


def test_rejected_value_restores_environment(tmp_path):
    def scenario(p, ledger):
        ok = p.hvd.set_config("HOROVOD_SERVE_RPC_TIMEOUT", 2.5)
        res = p.hvd.set_config("HOROVOD_SERVE_RPC_TIMEOUT", -1)
        unset = p.hvd.set_config("HOROVOD_SERVE_MAX_RETRIES", "many")
        return {"ok": ok, "res": res, "unset": unset,
                "timeout": p.config.get_config().serve_rpc_timeout_seconds,
                "retries_env": os.environ.get("HOROVOD_SERVE_MAX_RETRIES")}

    port, _ = _both(tmp_path, scenario)
    out = port["out"]
    assert out["ok"]["ok"]
    assert (out["res"]["outcome"], out["res"]["code"]) == ("rejected",
                                                           "invalid")
    assert port["env"]["HOROVOD_SERVE_RPC_TIMEOUT"] == "2.5"
    assert out["timeout"] == 2.5 and port["epoch"] == 1
    # a knob unset before the rejected value is unset again
    assert out["unset"]["outcome"] == "rejected"
    assert out["retries_env"] is None


def test_ledger_rotation(tmp_path):
    def scenario(p, ledger):
        ledger.write_text("x" * p.bus.LEDGER_ROTATE_BYTES)
        p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 10)
        rotated = str(ledger) + ".1"
        return os.path.getsize(rotated) >= p.bus.LEDGER_ROTATE_BYTES

    port, _ = _both(tmp_path, scenario)
    assert port["out"] is True
    [rec] = port["ledger"]
    assert rec["knob"] == "HOROVOD_SERVE_HEDGE_MS"
    assert PBUS.LEDGER_ROTATE_BYTES == RBUS.LEDGER_ROTATE_BYTES


def test_subscribers_notified_and_isolated(tmp_path):
    def scenario(p, ledger):
        seen = []
        p.bus.subscribe(lambda env, old, new, ep:
                        seen.append((env, old, new, ep)))

        def boom(env, old, new, ep):
            raise RuntimeError("subscriber bug")
        assert p.bus.subscribe(boom) is boom
        p.hvd.set_config("HOROVOD_SERVE_MAX_RETRIES", 7)
        first = list(seen)
        p.bus.unsubscribe(boom)
        p.bus.unsubscribe(boom)
        p.hvd.set_config("HOROVOD_SERVE_MAX_RETRIES", 2)
        return {"first": first, "n": len(seen)}

    port, _ = _both(tmp_path, scenario)
    assert port["out"]["first"] == [["HOROVOD_SERVE_MAX_RETRIES", 3, 7, 1]]
    assert port["out"]["n"] == 2


def test_refresh_diff_is_warned_and_ledgered(tmp_path, caplog):
    def scenario(p, ledger):
        os.environ["HOROVOD_SERVE_MAX_RETRIES"] = "7"
        os.environ["HOROVOD_METRICS_PORT"] = "auto"
        with caplog.at_level("WARNING", logger=p.name):
            p.config.refresh()
        return p.bus.epoch()

    port, _ = _both(tmp_path, scenario, caplog=caplog)
    assert port["out"] == 2
    assert any("refresh() changed HOROVOD_SERVE_MAX_RETRIES "
               "(serve_max_retries): 3 -> 7" in m for m in port["log"])
    assert len(port["log"]) == 2
    recs = [r for r in port["ledger"]
            if r["knob"] == "HOROVOD_SERVE_MAX_RETRIES"]
    assert recs and recs[0]["origin"] == "env-refresh"
    assert (recs[0]["old"], recs[0]["new"], recs[0]["epoch"]) == (3, 7, 1)
    assert [m["origin"] for m in port["markers"]] == ["env-refresh"] * 2


def test_refresh_sets_only_its_own_packages_logger(tmp_path):
    ref_level = logging.getLogger("horovod_tpu").level
    os.environ["HOROVOD_LOG_LEVEL"] = "error"
    PC.refresh()
    assert logging.getLogger("horovod_tpu_torch").level == logging.ERROR
    assert logging.getLogger("horovod_tpu").level == ref_level
    res = hvd.set_config("HOROVOD_LOG_LEVEL", "debug")
    assert res["ok"] and res["new"] == "debug"
    assert logging.getLogger("horovod_tpu_torch").level == logging.DEBUG
    assert logging.getLogger("horovod_tpu").level == ref_level
    for word, level in [("trace", logging.DEBUG), ("info", logging.INFO),
                        ("fatal", logging.CRITICAL),
                        ("nonsense", logging.WARNING)]:
        assert PC.log_level_of(word) == level


def test_set_config_retargets_the_running_watchdog():
    dog = PM.start_stall_watchdog(timeout_s=60.0, poll_s=60.0)
    try:
        assert hvd.set_config("HOROVOD_STALL_CHECK_TIME_SECONDS",
                              0.25)["ok"]
        assert PM.get_stall_watchdog() is dog
        assert dog.timeout_s == 0.25
        tok = PM.collective_begin("allreduce", name="held", nbytes=4)
        try:
            import time
            time.sleep(0.3)
            assert [r["tensor"] for r in dog.check_once()] == ["held"]
        finally:
            PM.collective_end(tok)
    finally:
        PM.stop_stall_watchdog()


# ---------------------------------------------------------------------------
# TestSecretMasking
# ---------------------------------------------------------------------------

def test_token_value_never_exported(tmp_path, caplog):
    def scenario(p, ledger):
        os.environ["HOROVOD_SERVE_AUTH_TOKEN"] = TOKEN
        with caplog.at_level("WARNING", logger=p.name):
            p.config.refresh()
        return {"resolved": p.bus.resolved_values()[
                    "HOROVOD_SERVE_AUTH_TOKEN"],
                "override": p.bus.overrides()["HOROVOD_SERVE_AUTH_TOKEN"],
                "info": p.hvd.build_info()["config"][
                    "HOROVOD_SERVE_AUTH_TOKEN"],
                "leaked": TOKEN in json.dumps(p.bus.config_view())
                + json.dumps(_lines(ledger))
                + json.dumps(p.hvd.build_info(), default=str)}

    port, ref = _both(tmp_path, scenario, caplog=caplog)
    out = port["out"]
    assert out["resolved"] is True and out["info"] is True
    assert out["override"] == {"value": True, "default": False}
    assert out["leaked"] is False
    assert TOKEN not in "".join(port["log"]) + json.dumps(
        {k: v for k, v in port.items() if k != "env"})
    assert "<set>" in "".join(port["log"])
    [rec] = port["ledger"]
    assert rec["old"] is None and rec["new"] is None


# ---------------------------------------------------------------------------
# TestExperiments
# ---------------------------------------------------------------------------

def _seed(store, t0, values):
    for dt, v in values:
        store.append_snapshot(
            {"counters": {"transport_retries_total":
                          [{"labels": {}, "value": v}]}},
            ts=t0 + dt)


def _frozen(p, monkeypatch, t):
    monkeypatch.setattr(p.bus.time, "time", lambda: t)


def test_regression_verdict_and_revert_guard(tmp_path, monkeypatch):
    def scenario(p, ledger):
        assert p.hvd.set_config("HOROVOD_CONFIG_REVERT_ON_REGRESSION",
                                1)["ok"]
        assert p.hvd.set_config("HOROVOD_CONFIG_EXPERIMENT_WINDOW", 5)["ok"]
        store = p.timeseries.TimeSeriesStore()
        p.bus.bind_store(store)
        t0 = 1_000_000.0
        _seed(store, t0, [(-4.5, 0.0), (-0.1, 2.0)])    # ~0.4/s
        _frozen(p, monkeypatch, t0)
        res = p.hvd.set_config("HOROVOD_SERVE_RPC_TIMEOUT", 0.05,
                               reason="bad idea")
        pending = p.bus.pending_experiments()
        _seed(store, t0, [(0.1, 3.0), (4.9, 104.0)])    # ~20/s
        done = p.bus.poll_experiments(now=t0 + 5.0)
        monkeypatch.undo()
        return {"res": res, "pending": pending, "done": done,
                "left": p.bus.pending_experiments(),
                "timeout": p.config.get_config().serve_rpc_timeout_seconds,
                "regs": p.bus.recent_regressions(60.0, now=t0 + 5.0)}

    port, _ = _both(tmp_path, scenario)
    out = port["out"]
    assert out["res"]["ok"] and out["res"]["experiment"]
    assert [e["knob"] for e in out["pending"]] == \
        ["HOROVOD_SERVE_RPC_TIMEOUT"]
    assert [d["verdict"] for d in out["done"]] == ["regressed"]
    assert out["done"][0]["effect"] < -PBUS.EFFECT_THRESHOLD
    assert not out["left"]
    assert out["timeout"] == 5.0
    assert port["env"]["HOROVOD_SERVE_RPC_TIMEOUT"] == "5.0"
    assert out["regs"] and out["regs"][0]["reverted"]
    rev = [r for r in port["ledger"] if r.get("origin") == "revert"]
    assert rev and rev[0]["new"] == 5.0
    [g] = [g for g in port["series"]["gauges"]["config_experiment_effect"]
           if g["labels"]["knob"] == "HOROVOD_SERVE_RPC_TIMEOUT"]
    assert g["value"] < 0


def test_improvement_and_no_revert_without_guard(tmp_path, monkeypatch):
    def scenario(p, ledger):
        assert p.hvd.set_config("HOROVOD_CONFIG_EXPERIMENT_WINDOW", 5)["ok"]
        store = p.timeseries.TimeSeriesStore()
        p.bus.bind_store(store)
        t0 = 2_000_000.0
        _seed(store, t0, [(-4.5, 0.0), (-0.1, 10.0)])   # ~2/s before
        _frozen(p, monkeypatch, t0)
        assert p.hvd.set_config("HOROVOD_SERVE_RPC_TIMEOUT", 8.0)["ok"]
        _seed(store, t0, [(0.1, 10.0), (4.9, 10.5)])    # ~0.1/s after
        done1 = p.bus.poll_experiments(now=t0 + 5.0)
        kept = p.config.get_config().serve_rpc_timeout_seconds
        _seed(store, t0, [(5.1, 11.0)])
        _frozen(p, monkeypatch, t0 + 5.2)
        assert p.hvd.set_config("HOROVOD_SERVE_RPC_TIMEOUT", 0.05)["ok"]
        _seed(store, t0, [(5.5, 12.0), (9.9, 150.0)])
        done2 = p.bus.poll_experiments(now=t0 + 10.2)
        monkeypatch.undo()
        return {"done1": done1, "kept": kept, "done2": done2,
                "regs": p.bus.recent_regressions(60.0, now=t0 + 10.2),
                "timeout": p.config.get_config().serve_rpc_timeout_seconds}

    port, _ = _both(tmp_path, scenario)
    out = port["out"]
    assert [d["verdict"] for d in out["done1"]] == ["improved"]
    assert out["done1"][0]["effect"] > PBUS.EFFECT_THRESHOLD
    assert out["kept"] == 8.0
    assert [d["verdict"] for d in out["done2"]] == ["regressed"]
    assert out["regs"] and not out["regs"][-1]["reverted"]
    assert out["timeout"] == 0.05


def test_remutation_supersedes_open_window(tmp_path):
    def scenario(p, ledger):
        p.bus.bind_store(p.timeseries.TimeSeriesStore())
        assert p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 25)["ok"]
        assert p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 50)["ok"]
        return p.bus.pending_experiments()

    port, _ = _both(tmp_path, scenario)
    assert len(port["out"]) == 1 and port["out"][0]["epoch"] == 2
    sup = [r for r in port["ledger"] if r.get("verdict") == "superseded"]
    assert sup and sup[0]["epoch"] == 1


def test_no_store_is_inconclusive(tmp_path):
    def scenario(p, ledger):
        assert p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 25)["ok"]
        done = p.bus.poll_experiments(now=p.bus.time.time() + 1e6)
        return {"done": [(d["verdict"], d["effect"], d["after"])
                         for d in done],
                "regs": p.bus.recent_regressions(1e9)}

    port, _ = _both(tmp_path, scenario)
    assert port["out"] == {"done": [["inconclusive", None, None]],
                           "regs": []}


@pytest.mark.parametrize("before,after,better", [
    (None, 1.0, "lower"), (1.0, None, "higher"), (2.0, 2.0, "lower"),
    (2.0, 2.1, "lower"), (2.0, 1.0, "lower"), (2.0, 4.0, "lower"),
    (2.0, 4.0, "higher"), (0.0, 1e-12, "higher"), (0.0, 3.0, "higher")])
def test_verdicts_are_the_references(before, after, better):
    assert PBUS._judge(before, after, better) == \
        RBUS._judge(before, after, better)


# ---------------------------------------------------------------------------
# TestViewsAndHttp
# ---------------------------------------------------------------------------

def test_config_view_shape(tmp_path):
    def scenario(p, ledger):
        p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 25)
        return p.hvd.build_info()["config_epoch"]

    port, _ = _both(tmp_path, scenario)
    view = port["view"]
    assert view["epoch"] == 1 and port["out"] == 1
    assert view["values"]["HOROVOD_SERVE_HEDGE_MS"] == 25.0
    assert "HOROVOD_SERVE_HEDGE_MS" in view["overrides"]
    assert "HOROVOD_SERVE_RPC_TIMEOUT" in view["mutable"]
    assert "HOROVOD_SERVE_SLOTS" in view["shape_affecting"]
    assert view["ledger_tail"][-1]["epoch"] == 1


def _without_ledger_path(doc):
    for k in ("values", "overrides"):
        doc.get(k, {}).pop("HOROVOD_CONFIG_LEDGER", None)
    return doc


def _http(url, data=None, token=None):
    headers = {"X-Auth-Token": token} if token else {}
    req = urllib.request.Request(url, data=data, headers=headers,
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, _without_ledger_path(json.loads(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_http_get_and_gated_post(tmp_path):
    def body(name, value, reason=""):
        return json.dumps({"name": name, "value": value,
                           "reason": reason}).encode()

    def scenario(p, ledger):
        srv = p.metrics.metrics_http(0)
        try:
            base = f"{srv.url}/config"
            got = [_http(base)]
            hedge = body("HOROVOD_SERVE_HEDGE_MS", 25, "via http")
            got += [_http(base, hedge), _http(base, hedge, "wrong-token-00"),
                    _http(base, hedge, TOKEN),
                    _http(base, body("HOROVOD_SERVE_SLOTS", 4), TOKEN),
                    _http(base, body("HOROVOD_SERVE_RPC_TIMEOUT", -1),
                          TOKEN),
                    _http(base)]
        finally:
            srv.stop()
        return {"replies": got,
                "hedge": p.config.get_config().serve_hedge_ms}

    port, _ = _both(tmp_path, scenario,
                    env={"HOROVOD_SERVE_AUTH_TOKEN": TOKEN})
    (c0, doc0), (c1, _), (c2, _), (c3, ok), (c4, ref), (c5, rej), \
        (c6, doc1) = port["out"]["replies"]
    assert (c0, doc0["epoch"]) == (200, 0)
    assert doc0["values"]["HOROVOD_SERVE_AUTH_TOKEN"] is True
    assert (c1, c2) == (401, 401)
    assert c3 == 200 and ok["ok"] and ok["epoch"] == 1
    assert port["out"]["hedge"] == 25.0
    assert c4 == 200 and (ref["outcome"], ref["code"]) == \
        ("refused", "shape_affecting")
    assert c5 == 200 and rej["outcome"] == "rejected"
    assert c6 == 200 and doc1["epoch"] == 1
    assert doc1["values"]["HOROVOD_SERVE_HEDGE_MS"] == 25.0
    assert [r["origin"] for r in port["ledger"]] == ["http"] * 3
    assert "hunter2" not in json.dumps(
        {k: v for k, v in port.items() if k != "env"})


def test_http_post_without_token_configured_is_403(tmp_path):
    def scenario(p, ledger):
        srv = p.metrics.metrics_http(0)
        try:
            return _http(f"{srv.url}/config",
                         json.dumps({"name": "HOROVOD_SERVE_HEDGE_MS",
                                     "value": 1}).encode(), "anything")
        finally:
            srv.stop()

    os.environ.pop("HOROVOD_SERVE_AUTH_TOKEN", None)
    port, _ = _both(tmp_path, scenario)
    assert port["out"][0] == 403
    assert port["epoch"] == 0 and port["ledger"] == []


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_an_elastic_reform_into_another_world_bumps_no_epoch(tmp_path,
                                                             caplog):
    """``shutdown()`` + ``init()`` into a world with a rendezvous store,
    then a refresh into a world of two: only the port's own fields change,
    and the bus audits none of them."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_TIMELINE",
              "HOROVOD_METRICS_FILE"):
        os.environ.pop(k, None)
    ledger = tmp_path / "ledger.jsonl"
    os.environ["HOROVOD_CONFIG_LEDGER"] = str(ledger)
    PC.refresh()
    _reset_both()
    if ledger.exists():     # the refresh audits the ledger's own path
        ledger.unlink()
    caplog.clear()
    with caplog.at_level("WARNING", logger="horovod_tpu_torch"):
        hvd.init(device="cpu")
        hvd.shutdown()
        os.environ.update(MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(_free_port()),
                          HOROVOD_HIERARCHICAL_ALLREDUCE="1")
        hvd.init(device="cpu")
        try:
            cfg = PC.get_config()
            assert cfg.master_port == int(os.environ["MASTER_PORT"])
            assert cfg.hierarchical_allreduce
        finally:
            hvd.shutdown()
        os.environ.update(RANK="1", WORLD_SIZE="2", LOCAL_RANK="1",
                          LOCAL_SIZE="2")
        cfg = PC.refresh()
    assert (cfg.rank, cfg.world_size, cfg.local_rank) == (1, 2, 1)
    assert PBUS.epoch() == 0
    assert _lines(ledger) == []
    assert [r.getMessage() for r in caplog.records
            if "refresh() changed" in r.getMessage()] == []
    assert "config_mutations_total" not in PM.snapshot()["counters"]
    # ...while a knob of the reference's Config in the same refresh is
    # audited once
    os.environ["HOROVOD_SERVE_MAX_RETRIES"] = "5"
    PC.refresh()
    assert PBUS.epoch() == 1
    assert [r["knob"] for r in _lines(ledger)] == \
        ["HOROVOD_SERVE_MAX_RETRIES"]


def test_a_refresh_after_init_writes_the_references_recorder_records(
        tmp_path):
    """The same env change and refresh under each package's armed
    recorder: the bundles' "config" records are the same."""
    got = {}
    for name in ("reference", "port"):
        p = PKGS[name]
        base = dict(os.environ)
        for k in list(os.environ):
            if k.startswith("HOROVOD_BLACKBOX"):
                del os.environ[k]
        p.config.refresh()      # from the environment as it is now
        p.blackbox.reset()
        p.bus.reset()
        os.environ.update(HOROVOD_BLACKBOX="1",
                          HOROVOD_BLACKBOX_DIR=str(tmp_path / name))
        p.config.refresh()      # audited: arms the recorder
        p.bus.reset()
        rec = p.blackbox.ensure(rank=0, world=1)
        os.environ.update(HOROVOD_SERVE_MAX_RETRIES="7",
                          HOROVOD_SERVE_AUTH_TOKEN=TOKEN,
                          HOROVOD_LOG_LEVEL="error")
        p.config.refresh()
        p.hvd.set_config("HOROVOD_SERVE_HEDGE_MS", 12, reason="probe")
        p.hvd.set_config("HOROVOD_MESH", "dp1xmp1")
        bundle = rec.dump(trigger="manual")
        with open(os.path.join(bundle, "events.jsonl")) as f:
            got[name] = [json.loads(x) for x in f if x.strip()]
        p.blackbox.reset()
        p.bus.reset()
        os.environ.clear()
        os.environ.update(base)
        p.config.refresh()
        p.bus.reset()

    def config_records(recs):
        return [{k: v for k, v in r.items() if k != "ts"}
                for r in recs if r["type"] == "config"]

    port, ref = config_records(got["port"]), config_records(got["reference"])
    assert port == ref
    assert [(r["knob"], r.get("epoch")) for r in port] == [
        ("HOROVOD_BLACKBOX", 1), ("HOROVOD_BLACKBOX_DIR", 2),
        ("HOROVOD_SERVE_AUTH_TOKEN", 1), ("HOROVOD_SERVE_MAX_RETRIES", 2),
        ("HOROVOD_LOG_LEVEL", 3), ("HOROVOD_SERVE_HEDGE_MS", 4),
        ("HOROVOD_MESH", None)]
    assert TOKEN not in json.dumps(got["port"])
