"""horovod_tpu_torch.metrics.metrics_http: the live scrape endpoint.

Every route of the reference's ``MetricsHTTPServer``
(``horovod_tpu/metrics.py:935-1111``) is held against the reference's own
server, started beside the port's with both registries holding the same
series: the same status, Content-Type and body for ``/metrics`` and ``/``,
``/metrics.json`` (but its timestamp), ``/trace``, ``/healthz`` and
``/config`` (both config buses at epoch 0 over the same environment), an
unknown path, and each ``POST /config`` case, an applied mutation
included. Where the module behind a route (``serving.reqtrace``,
``health``) is not ported, the reference is made to miss it too, so both
take their fallback branches; with the port's ``confbus`` hidden as well,
``/config`` gives that fallback and ``POST /config`` its 500. ``/doctor`` serves ``hvd.doctor()``, the reference's
report but the suggestion texts the port rewrites (ROADMAP.md section C);
unknown paths 404 without a log line. ``POST /config`` is gated by
``HOROVOD_SERVE_AUTH_TOKEN`` (403 with none configured, 401 on a
mismatch, 400 on a malformed body, 200 with the bus's typed result, 500
while the config bus is absent) and never echoes the token. ``fallback_ports`` retries the next ports.
Scrapes taken while a tiny gloo training loop writes the registry parse,
and no counter goes backwards between them.
"""

import importlib.abc
import json
import os
import re
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from horovod_tpu import confbus as RBUS
from horovod_tpu import config as RC
from horovod_tpu import metrics as RM
from horovod_tpu_torch import confbus as PBUS
from horovod_tpu_torch import config
from horovod_tpu_torch import metrics as PM

TOKEN = "s3cret-token-value"


def _get(url, data=None, headers=None):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.fixture(scope="module")
def server():
    """One endpoint for the file (a stop waits out the serve loop's
    0.5 s poll)."""
    srv = PM.metrics_http(0)
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def ref_server():
    """The reference's endpoint, beside the port's."""
    srv = RM.metrics_http(0)
    yield srv
    srv.stop()


def _refresh():
    config.refresh()
    RC.refresh()


@pytest.fixture
def no_token(monkeypatch):
    monkeypatch.delenv("HOROVOD_SERVE_AUTH_TOKEN", raising=False)
    _refresh()
    yield
    _refresh()


@pytest.fixture
def token(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_AUTH_TOKEN", TOKEN)
    _refresh()
    yield TOKEN
    monkeypatch.delenv("HOROVOD_SERVE_AUTH_TOKEN")
    _refresh()


# The reference's modules that the port has not ported yet. The reference
# must miss them as the port does, so that its routes take the same
# fallback branches.
UNPORTED = ("horovod_tpu.serving.reqtrace", "horovod_tpu.health")
# Both packages' config buses, hidden where a test takes the branches a
# missing bus takes.
CONFBUSES = ("horovod_tpu.confbus", "horovod_tpu_torch.confbus")


class _Unfindable(importlib.abc.MetaPathFinder):
    """Finds none of ``names``: an import of one fails as the import of a
    module that does not exist does."""

    def __init__(self, names):
        self.names = frozenset(names)

    def find_spec(self, fullname, path=None, target=None):
        if fullname in self.names:
            raise ModuleNotFoundError(f"No module named {fullname!r}",
                                      name=fullname)
        return None


def _hide(monkeypatch, names):
    """``names`` gone for one test: out of ``sys.modules``, off their
    package, unfindable."""
    for name in names:
        parent, _, child = name.rpartition(".")
        monkeypatch.delitem(sys.modules, name, raising=False)
        if parent in sys.modules:
            monkeypatch.delattr(sys.modules[parent], child, raising=False)
    monkeypatch.setattr(sys, "meta_path",
                        [_Unfindable(names)] + sys.meta_path)


@pytest.fixture
def unported(monkeypatch):
    """For one test, the reference's copies of the modules the port lacks
    are gone."""
    _hide(monkeypatch, UNPORTED)
    yield


@pytest.fixture
def no_confbus(monkeypatch):
    """For one test, neither package has a config bus (nor the modules
    ``unported`` hides)."""
    _hide(monkeypatch, UNPORTED + CONFBUSES)
    yield


@pytest.fixture
def same_buses():
    """Both configs read from one environment, both buses at epoch 0; the
    environment, both configs and both buses as they were afterwards
    (``POST /config`` writes the environment)."""
    env = dict(os.environ)
    _refresh()
    for bus in (PBUS, RBUS):
        bus.reset()
    yield
    os.environ.clear()
    os.environ.update(env)
    _refresh()
    for bus in (PBUS, RBUS):
        bus.reset()


def _seed(m=PM):
    m.counter("collective_calls_total", kind="allreduce").inc(3)
    m.gauge("world_size").set(1)
    m.histogram("negotiation_seconds").observe(0.002)


@pytest.fixture
def same_series():
    """Both registries hold the same series and nothing else."""
    for m in (PM, RM):
        m.reset_metrics()
        _seed(m)
        m.counter("collective_bytes_total", kind="allgather").inc(4096)
        m.histogram("ratio_probe", buckets=m.RATIO_BUCKETS).observe(0.5)
    yield
    for m in (PM, RM):
        m.reset_metrics()


def _both(server, ref_server, path, data=None, headers=None):
    """The port's and the reference's (status, content type, body) for
    one request; the port's own package name in a body reads as the
    reference's (an import error names the package it searched)."""
    port = _get(server.url + path, data=data, headers=headers)
    ref = _get(ref_server.url + path, data=data, headers=headers)
    port = port[:2] + (port[2].replace(b"horovod_tpu_torch",
                                       b"horovod_tpu"),)
    return port, ref


GET_ROUTES = ["/metrics", "/", "/metrics?name=x", "/trace", "/healthz",
              "/config", "/nope", "/metrics/x"]


@pytest.mark.parametrize("path", GET_ROUTES)
def test_get_routes_answer_as_the_reference(server, ref_server, unported,
                                            same_series, same_buses, path):
    port, ref = _both(server, ref_server, path)
    assert port[:2] == ref[:2]
    assert port[2] == ref[2]


def test_json_route_answers_as_the_reference(server, ref_server, unported,
                                            same_series):
    port, ref = _both(server, ref_server, "/metrics.json")
    assert port[:2] == ref[:2] == (200, "application/json")
    got, want = json.loads(port[2]), json.loads(ref[2])
    got.pop("timestamp")
    want.pop("timestamp")
    assert got == want
    assert got["counters"]["collective_calls_total"] == [
        {"labels": {"kind": "allreduce"}, "value": 3}]


def test_unknown_post_answers_as_the_reference(server, ref_server):
    port, ref = _both(server, ref_server, "/metrics", data=b"{}")
    assert port == ref
    assert port[0] == 404


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["/metrics", "/", "/metrics?name=x"])
def test_prometheus_routes_are_to_prometheus(server, path):
    _seed()
    code, ctype, body = _get(server.url + path)
    assert code == 200
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert body.decode() == PM.to_prometheus()
    assert 'horovod_tpu_collective_calls_total{kind="allreduce"}' in \
        body.decode()


def test_json_route_is_to_json(server):
    _seed()
    code, ctype, body = _get(server.url + "/metrics.json")
    assert (code, ctype) == (200, "application/json")
    got, want = json.loads(body), json.loads(PM.to_json())
    assert got.pop("timestamp") <= want.pop("timestamp")
    assert got == want


FALLBACKS = {
    "/trace": (200, {"traceEvents": [], "displayTimeUnit": "ms"}),
    "/healthz": (200, {"status": "ok", "ok": True, "alerts": []}),
    "/config": (200, {"epoch": 0, "values": {}}),
}


@pytest.mark.parametrize("path", sorted(FALLBACKS))
def test_unported_modules_give_the_references_fallback(server, no_confbus,
                                                       path):
    code, ctype, body = _get(server.url + path)
    assert (code, json.loads(body)) == FALLBACKS[path]
    assert ctype == "application/json"


def test_doctor_serves_the_profilers_report(server, ref_server, unported,
                                            same_series):
    """``/doctor`` serves ``hvd.doctor()`` (the health plane is not ported,
    so the one-shot report), as the reference's route serves its own: with
    the same series and the same planted recompile, the same findings but
    the recompile suggestion the port rewrites (ROADMAP.md section C)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu import profiler as RP
    from horovod_tpu_torch import profiler as PP
    for prof in (PP, RP):
        prof.registry.reset()
        prof.note_trace("train_step", {"tokens": "int64[8, 1024]"})
        prof.note_trace("train_step", {"tokens": "int64[4, 1024]"})
    try:
        code, ctype, body = _get(server.url + "/doctor")
        ref = _get(ref_server.url + "/doctor")
        assert (code, ctype) == ref[:2] == (200, "application/json")
        got, want = json.loads(body), json.loads(ref[2])
        assert got == json.loads(json.dumps(hvd.doctor(), default=str))
        assert [f["category"] for f in got["findings"]] == ["recompile"]
        assert got["findings"][0]["evidence"]["blamed_arguments"] == \
            ["tokens"]
        for f in (got, want):
            f["findings"][0].pop("suggestion")
        assert got == want
    finally:
        for prof in (PP, RP):
            prof.registry.reset()


@pytest.mark.parametrize("method,path", [("GET", "/nope"),
                                         ("GET", "/metrics/x"),
                                         ("POST", "/metrics")])
def test_unknown_paths_404_quietly(server, capfd, method, path):
    capfd.readouterr()
    code, _, _ = _get(server.url + path,
                      data=b"{}" if method == "POST" else None)
    _get(server.url + "/metrics")
    assert code == 404
    out, err = capfd.readouterr()
    assert out == "" and err == ""


def test_server_threads_are_daemons_and_stop():
    server = PM.metrics_http(0)
    assert server.url == f"http://127.0.0.1:{server.port}"
    assert server._thread.daemon
    assert server._httpd.daemon_threads
    name = f"hvd-metrics-http-{server.port}"
    assert name in {t.name for t in threading.enumerate()}
    server.stop()
    assert name not in {t.name for t in threading.enumerate()}
    with pytest.raises(OSError):
        urllib.request.urlopen(server.url + "/metrics", timeout=2)


# ---------------------------------------------------------------------------
# ports
# ---------------------------------------------------------------------------

def _taken_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(1)
    return s, s.getsockname()[1]


def test_fallback_ports_take_the_next_free_port():
    holder, port = _taken_port()
    try:
        with pytest.raises(OSError):
            PM.metrics_http(port)
        srv = None
        for _ in range(5):      # the next port may itself be taken
            try:
                srv = PM.metrics_http(port, fallback_ports=8)
                break
            except OSError:
                continue
        assert srv is not None
        try:
            assert port < srv.port <= port + 8
            assert _get(srv.url + "/metrics")[0] == 200
        finally:
            srv.stop()
    finally:
        holder.close()


def test_port_zero_binds_an_ephemeral_port():
    a, b = PM.metrics_http(0), PM.metrics_http(0, fallback_ports=3)
    try:
        assert a.port > 0 and b.port > 0 and a.port != b.port
    finally:
        a.stop()
        b.stop()


# ---------------------------------------------------------------------------
# POST /config and HOROVOD_SERVE_AUTH_TOKEN
# ---------------------------------------------------------------------------

def _post(server, ref_server, body=b'{"name": "HOROVOD_FUSION_THRESHOLD", '
                                   b'"value": 1024}', tok=None):
    """The port's and the reference's reply to one ``POST /config``; both
    must be the same."""
    headers = {"Content-Type": "application/json"}
    if tok is not None:
        headers["X-Auth-Token"] = tok
    port, ref = _both(server, ref_server, "/config", data=body,
                      headers=headers)
    assert port == ref
    return port


def test_post_config_is_off_without_a_token(server, ref_server, unported,
                                            no_token):
    code, ctype, body = _post(server, ref_server, tok="anything-at-all")
    assert (code, ctype) == (403, "application/json")
    assert json.loads(body) == {
        "ok": False, "error": "POST /config disabled: no "
                              "HOROVOD_SERVE_AUTH_TOKEN configured"}


@pytest.mark.parametrize("tok", [None, "", "wrong-token-value",
                                 TOKEN + "x", TOKEN[:-1]])
def test_post_config_refuses_a_bad_token(server, ref_server, unported,
                                         token, tok):
    code, _, body = _post(server, ref_server, tok=tok)
    assert code == 401
    assert json.loads(body) == {"ok": False, "error": "bad auth token"}
    assert TOKEN.encode() not in body


def test_post_config_malformed_body_is_400(server, ref_server, unported,
                                           token):
    code, _, body = _post(server, ref_server, body=b"{not json", tok=token)
    assert code == 400
    assert json.loads(body) == {"ok": False, "error": "malformed JSON body"}


def test_post_config_is_500_while_confbus_is_absent(server, ref_server,
                                                    no_confbus, token):
    code, _, body = _post(server, ref_server, tok=token)
    assert code == 500
    doc = json.loads(body)
    assert doc["ok"] is False
    # the reference's reply when its import fails: the exception's repr
    assert doc["error"].startswith("set_config: ImportError(")
    assert "confbus" in doc["error"]
    assert TOKEN.encode() not in body


@pytest.mark.parametrize("body", [
    b'{"name": "HOROVOD_SERVE_HEDGE_MS", "value": 25, "reason": "http"}',
    b'{"name": "serve_max_retries", "value": 7}',
    b'{"name": "HOROVOD_SERVE_RPC_TIMEOUT", "value": -1}',
    b'{"name": "HOROVOD_SERVE_AUTH_TOKEN", "value": "another-token"}',
    b'{"name": "HOROVOD_TIMELINE", "value": "/x"}',
    b'{"name": "HOROVOD_NO_SUCH_KNOB", "value": 1}',
    b'{}'])
def test_post_config_applies_as_the_reference(server, ref_server, unported,
                                              token, same_buses, body):
    """With the token, the port's bus and the reference's give the same
    typed reply (applied, refused, rejected or unknown), and ``GET
    /config`` then shows the same view but the ledger's times."""
    code, ctype, reply = _post(server, ref_server, body=body, tok=token)
    assert (code, ctype) == (200, "application/json")
    doc = json.loads(reply)
    assert doc["outcome"] in ("applied", "refused", "rejected", "unknown")
    assert TOKEN.encode() not in reply
    port, ref = _both(server, ref_server, "/config")
    got, want = json.loads(port[2]), json.loads(ref[2])
    for view in (got, want):
        for rec in view["ledger_tail"]:
            assert rec.pop("ts") > 0
        for e in view["pending_experiments"]:
            e.pop("t0")
    assert got == want
    assert got["epoch"] == int(doc["outcome"] == "applied")
    assert [r["origin"] for r in got["ledger_tail"]] == ["http"]
    assert TOKEN.encode() not in port[2]


def test_short_token_refused_and_never_echoed(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_AUTH_TOKEN", "tiny7ch")
    try:
        with pytest.raises(ValueError, match="token too short") as e:
            config.refresh()
        assert "tiny7ch" not in str(e.value)
    finally:
        monkeypatch.delenv("HOROVOD_SERVE_AUTH_TOKEN")
        config.refresh()


def test_token_read_stripped_and_kept_out_of_repr(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_AUTH_TOKEN", f"  {TOKEN}\n")
    try:
        cfg = config.refresh()
        assert cfg.serve_auth_token == TOKEN
        assert TOKEN not in repr(cfg) and TOKEN not in str(cfg)
    finally:
        monkeypatch.delenv("HOROVOD_SERVE_AUTH_TOKEN")
        assert config.refresh().serve_auth_token == ""


# ---------------------------------------------------------------------------
# scrapes during training
# ---------------------------------------------------------------------------

_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')


def _parse_prometheus(text):
    """{(name, labels): value} of a text exposition; raises on a bad line."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            assert re.match(r"^# (HELP|TYPE) \S+ ", line), line
            continue
        m = _SAMPLE.match(line)
        assert m, f"unparseable line {line!r}"
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _counters(doc):
    return {(n, json.dumps(s["labels"], sort_keys=True)): s["value"]
            for n, series in doc["counters"].items() for s in series}


def test_scrapes_during_a_gloo_training_loop_never_go_backwards(
        server, monkeypatch):
    import horovod_tpu_torch as hvd
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_TIMELINE",
              "HOROVOD_METRICS_FILE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    scrapes, stop = [], threading.Event()

    def scraper():
        while not stop.is_set():
            for path in ("/metrics.json", "/metrics"):
                scrapes.append((path,) + _get(server.url + path))
            time.sleep(0.002)

    th = threading.Thread(target=scraper)
    try:
        g = torch.Generator().manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                    torch.nn.Linear(16, 4))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05))
        x = torch.randn(16, 8, generator=g)
        th.start()
        for _ in range(40):
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step()
            hvd.allreduce(torch.ones(3), name="probe")
    finally:
        stop.set()
        if th.ident is not None:
            th.join(timeout=30)
        hvd.shutdown()
    assert not th.is_alive()
    assert len(scrapes) >= 4
    assert all(code == 200 for _, code, _, _ in scrapes)
    last_json, last_prom = {}, {}
    for path, _, _, body in scrapes:
        if path == "/metrics.json":
            doc = json.loads(body)
            for h in (s for series in doc["histograms"].values()
                      for s in series):
                assert h["buckets"][-1][1] == h["count"]
            cur, last = _counters(doc), last_json
        else:
            fam = _parse_prometheus(body.decode())
            cur = {k: v for k, v in fam.items()
                   if k[0].endswith("_total") or k[0].endswith("_count")}
            last = last_prom
        for k, v in cur.items():
            assert v >= last.get(k, 0), (path, k, last.get(k), v)
        last.clear()
        last.update(cur)
    grew = _counters(json.loads(scrapes[-2][3]))
    assert grew[("collective_calls_total",
                 '{"kind": "allreduce"}')] >= 1
    # once the writes stop, a scrape is the exporter's output exactly
    assert _get(server.url + "/metrics")[2].decode() == PM.to_prometheus()


def test_histograms_stay_whole_under_concurrent_writes():
    """More writers than cores, a short switch interval: every snapshot's
    +Inf bucket equals its count, and counters read in one snapshot never
    fall below the last."""
    import os
    import sys
    h = PM.histogram("scrape_probe_seconds")
    c = PM.counter("scrape_probe_total")
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            h.observe((i % 7) * 1e-3)
            c.inc()
            i += 1

    ths = [threading.Thread(target=writer)
           for _ in range((os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ths:
            t.start()
        last = 0
        for _ in range(300):
            snap = PM.snapshot()
            (s,) = snap["histograms"]["scrape_probe_seconds"]
            assert s["buckets"][-1][1] == s["count"]
            (v,) = snap["counters"]["scrape_probe_total"]
            assert v["value"] >= last
            last = v["value"]
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for t in ths:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in ths)
