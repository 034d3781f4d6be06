"""Elastic state, the elastic driver, discovery and the fault plan of
horovod_tpu_torch against the reference (``horovod_tpu.elastic``,
``horovod_tpu.faults``), on the CPU.

* ``TorchState``: the port's and the reference's own torch state on the
  same seeded ``nn.Module`` and ``AdamW``, through the same commit /
  restore / save / load / sync sequence: model and optimizer state dicts
  bit-equal at every point (exact equality, no tolerance), the same
  attributes, the same per-restore warning for a non-copyable attribute.
* ``_sync_attrs``' merge cases (``tests/test_elastic.py:260-297``) on the
  same inputs, both packages.
* ``@run``: the reference's recovery test (``tests/test_elastic.py:181-225``)
  with the same step sequence and final values (exact), the port's world
  staying one gloo rank; ``reset_limit``; the notification manager; both
  host discoveries.
* The fault plan: ``parse_plan`` on a table of plans, the port's
  ``FaultAction`` fields and ``describe()`` or its error message equal to
  the reference's; ``fault_point`` firing, counting and restart gating;
  ``net_fault`` / ``partitioned``; a ``kill`` in a subprocess.
"""

import copy
import dataclasses
import logging
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import config as jconfig
from horovod_tpu import faults as jfaults
from horovod_tpu.elastic import state as jstate
from horovod_tpu_torch import config as pconfig
from horovod_tpu_torch import elastic as pel
from horovod_tpu_torch import faults as pfaults
from horovod_tpu_torch.elastic import state as pstate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HOROVOD_FAULT_PLAN", "HVD_TPU_ELASTIC_RESTART",
              "HVD_TPU_FLEET_RESTART", "HVD_TPU_ELASTIC_SPARE",
              "HVD_TPU_ELASTIC_FAILED_AT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "LOCAL_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    yield
    monkeypatch.undo()
    for k in ("HOROVOD_FAULT_PLAN", "HVD_TPU_ELASTIC_RESTART"):
        os.environ.pop(k, None)
    jfaults.reset()
    pfaults.reset()
    jconfig.refresh()
    pconfig.refresh()
    if hvd.is_initialized():
        hvd.shutdown()


# ------------------------------------------------------------------ states

def _model_and_opt(seed=0):
    g = torch.Generator().manual_seed(seed)
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                            torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m, torch.optim.AdamW(m.parameters(), lr=1e-2, weight_decay=1e-4,
                                eps=1e-8)


def _batch(step):
    g = np.random.default_rng(100 + step)
    return (torch.from_numpy(g.standard_normal((5, 4)).astype(np.float32)),
            torch.from_numpy(g.standard_normal((5, 3)).astype(np.float32)))


def _train(m, opt, step):
    x, y = _batch(step)
    opt.zero_grad()
    torch.nn.functional.mse_loss(m(x), y).backward()
    opt.step()


def _same(a, b, where=""):
    """Exact equality of two state dicts (nested dicts, lists, tensors)."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.shape == b.shape and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


class _Pair:
    """The same model, optimizer and attributes under the reference's
    TorchState and the port's."""

    def __init__(self, **attrs):
        self.jm, self.jo = _model_and_opt()
        self.pm, self.po = _model_and_opt()
        self.js = jstate.TorchState(model=self.jm, optimizer=self.jo,
                                    **attrs)
        self.ps = pstate.TorchState(model=self.pm, optimizer=self.po,
                                    **attrs)

    def train(self, step):
        _train(self.jm, self.jo, step)
        _train(self.pm, self.po, step)

    def both(self, fn):
        fn(self.js)
        fn(self.ps)

    def check(self):
        _same(self.jm.state_dict(), self.pm.state_dict(), "model")
        _same(self.jo.state_dict(), self.po.state_dict(), "optimizer")
        assert self.js._attrs.keys() == self.ps._attrs.keys()
        assert self.js.commit_count == self.ps.commit_count


def test_torch_state_commit_restore_matches_reference():
    p = _Pair(epoch=0)
    w0 = copy.deepcopy(p.pm.state_dict())
    p.train(0)
    p.check()
    p.both(lambda s: s.restore())
    p.check()
    _same(p.pm.state_dict(), w0)
    assert p.po.state_dict()["state"] == {}       # rolled back to fresh
    for step in (1, 2):
        p.train(step)
    p.both(lambda s: setattr(s, "epoch", 3))
    p.both(lambda s: s.commit())
    committed = copy.deepcopy(p.po.state_dict())
    p.train(3)
    p.both(lambda s: setattr(s, "epoch", 7))
    p.both(lambda s: s.sync())       # world of one: restore the commit
    p.check()
    _same(p.po.state_dict(), committed)
    assert p.js.epoch == p.ps.epoch == 3
    assert p.ps.commit_count == 2


def test_torch_state_save_load_round_trip_matches_reference(tmp_path):
    p = _Pair(epoch=5)
    p.train(0)
    p.both(lambda s: s.commit())
    p.js.save(str(tmp_path / "ref.pkl"))
    p.ps.save(str(tmp_path / "port.pt"))
    q = _Pair(epoch=0)
    q.js.load(str(tmp_path / "ref.pkl"))
    q.ps.load(str(tmp_path / "port.pt"))
    q.check()
    _same(q.pm.state_dict(), p.pm.state_dict())
    _same(q.po.state_dict(), p.po.state_dict())
    assert q.ps.epoch == q.js.epoch == 5
    assert q.ps.commit_count == q.js.commit_count == 2


def test_attributes_match_reference(caplog, tmp_path):
    """Late-added attributes are tracked; a non-copyable one is kept by
    reference, excluded from save(), and every restore() says that its
    rollback is a no-op, in both packages."""
    p = _Pair()
    p.both(lambda s: setattr(s, "epoch", 3))        # set after construction
    p.both(lambda s: setattr(s, "lock", threading.Lock()))
    with caplog.at_level(logging.WARNING):
        p.both(lambda s: s.commit())
    p.both(lambda s: setattr(s, "epoch", 9))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        p.both(lambda s: s.restore())
        p.both(lambda s: s.restore())
    msgs = {}
    for r in caplog.records:
        if "NO-OP" in r.getMessage():
            msgs.setdefault(r.name, []).append(r.getMessage())
    assert len(msgs["horovod_tpu"]) == 2
    assert msgs["horovod_tpu_torch"] == msgs["horovod_tpu"]
    assert p.js.epoch == p.ps.epoch == 3
    assert hasattr(p.ps.lock, "acquire")
    p.ps.save(str(tmp_path / "c.pt"))               # lock left out
    blob = torch.load(str(tmp_path / "c.pt"), weights_only=False)
    assert set(blob["attrs"]) == {"epoch"}


def test_tensor_state_matches_jax_state():
    """TensorState is the reference's JaxState over tensors: the same
    commit / restore / late-attribute sequence gives the same values."""
    import jax.numpy as jnp
    from horovod_tpu.elastic import JaxState
    js = JaxState(params={"w": jnp.ones((3,))}, epoch=0)
    ps = pel.TensorState(params={"w": torch.ones(3)}, epoch=0)
    js.params = {"w": jnp.full((3,), 2.0)}
    ps.params = {"w": torch.full((3,), 2.0)}
    js.step, ps.step = 10, 10
    js.commit()
    ps.commit()
    js.params = {"w": jnp.zeros((3,))}
    ps.params["w"].zero_()                       # in place: a host copy
    js.step, ps.step = 11, 11
    js.restore()
    ps.restore()
    np.testing.assert_array_equal(ps.params["w"].numpy(),
                                  np.asarray(js.params["w"]))
    assert (ps.step, ps.epoch, ps.commit_count) == \
        (js.step, js.epoch, js.commit_count)


def test_sync_zeroes_error_feedback_residuals():
    """As the reference's JaxState.sync (tests/test_elastic.py:47-66):
    after a re-init the quantized wire's residuals restart at zero; the
    model, the inner optimizer state and the attributes survive."""
    hvd.init(device="cpu")
    m, inner = _model_and_opt()
    opt = hvd.DistributedOptimizer(inner, compression=hvd.Compression.int8,
                                   error_feedback=True)
    _train(m, opt, 0)
    assert opt._residual and any(float(r.abs().max()) > 0
                                 for r in opt._residual.values())
    s = pel.TorchState(model=m, optimizer=opt, epoch=3)
    w = copy.deepcopy(m.state_dict())
    adam = copy.deepcopy(inner.state_dict())
    s.sync()
    assert all(float(r.abs().max()) == 0 for r in opt._residual.values())
    _same(m.state_dict(), w)
    _same(inner.state_dict(), adam)
    assert s.epoch == 3


_SYNC_CASES = [
    ({"step": 9, "lr": 0.5}, ({"step": 3, "lr": 0.1}, []),
     {"step": 3, "lr": 0.1}),
    ({"step": 9, "loader": "LOCAL"}, ({"step": 3}, ["loader"]),
     {"step": 3, "loader": "LOCAL"}),
    ({"step": 9}, ({"step": 3}, ["loader"]), {"step": 3}),
    ({"step": 9, "stale": 1}, ({"step": 3}, []), {"step": 3}),
]


@pytest.mark.parametrize("saved,root_payload,want", _SYNC_CASES,
                         ids=["root-wins", "dropped-keeps-local",
                              "dropped-absent", "root-never-had"])
def test_sync_attrs_merge_matches_reference(saved, root_payload, want):
    calls = {"ref": [], "port": []}

    def fake(tag):
        def bcast(payload, root):
            calls[tag].append((payload, root))
            return root_payload
        return bcast

    ref = jstate._sync_attrs(dict(saved), set(), broadcast_fn=fake("ref"))
    port = pstate._sync_attrs(dict(saved), set(), broadcast_fn=fake("port"))
    assert port == ref == want
    assert calls["port"] == calls["ref"]     # the root's payload, root 0


# ----------------------------------------------------------------- driver

def test_elastic_run_recovery_matches_reference():
    """tests/test_elastic.py:181-214 on both packages: a membership change
    at step 3 rolls the state back to the last commit, the world re-forms
    and the run completes. The reference's world shrinks 8 -> 4 devices;
    the port's stays one gloo rank, re-formed (init_epoch + 1)."""
    import jax
    import jax.numpy as jnp
    from horovod_tpu.elastic import HostsUpdatedInterrupt as JInterrupt
    from horovod_tpu.elastic import JaxState, run as jrun
    from horovod_tpu.elastic.discovery import DeviceDiscovery as JDisco

    all_devices = jax.devices()
    current = {"devs": all_devices}
    jevents = []

    @jrun
    def jtrain(state):
        while state.step < 6:
            if state.step == 3 and len(current["devs"]) == 8:
                current["devs"] = all_devices[:4]
                raise JInterrupt("simulated preemption")
            state.params = jax.tree_util.tree_map(lambda w: w * 2.0,
                                                  state.params)
            state.step += 1
            state.commit()
            jevents.append((state.step, jhvd.size()))
        return np.asarray(state.params["w"])

    try:
        jout = jtrain(JaxState(params={"w": jnp.ones((4,))}, step=0),
                      discovery=JDisco(probe=lambda: current["devs"]))
    finally:
        jhvd.init()

    hvd.init(device="cpu")
    epoch0 = hvd.core.init_epoch()
    pdevs = {"devs": ["a", "b"]}
    pevents = []

    @pel.run
    def ptrain(state):
        while state.step < 6:
            if state.step == 3 and len(pdevs["devs"]) == 2:
                pdevs["devs"] = ["a"]
                raise pel.HostsUpdatedInterrupt("simulated preemption")
            state.params = {"w": state.params["w"] * 2.0}
            state.step += 1
            state.commit()
            pevents.append((state.step, hvd.core.init_epoch()))
        return state.params["w"].numpy()

    pout = ptrain(pel.TensorState(params={"w": torch.ones(4)}, step=0),
                  discovery=pel.DeviceDiscovery(probe=lambda: pdevs["devs"]))
    assert [s for s, _ in pevents] == [s for s, _ in jevents] == \
        [1, 2, 3, 4, 5, 6]
    assert jevents == [(1, 8), (2, 8), (3, 8), (4, 4), (5, 4), (6, 4)]
    assert pevents == [(s, epoch0 + (s > 3)) for s in range(1, 7)]
    np.testing.assert_array_equal(pout, jout)
    assert hvd.size() == 1 and hvd.backend() == "gloo"


def test_reset_limit_matches_reference():
    from horovod_tpu.elastic import HostsUpdatedInterrupt as JInterrupt
    from horovod_tpu.elastic import JaxState, run as jrun
    from horovod_tpu.elastic.discovery import DeviceDiscovery as JDisco
    import jax
    import jax.numpy as jnp

    @jrun
    def jtrain(state):
        raise JInterrupt("always")

    try:
        with pytest.raises(RuntimeError, match="reset limit") as jerr:
            jtrain(JaxState(params={"w": jnp.ones(2)}, step=0),
                   reset_limit=2, discovery=JDisco(probe=jax.devices))
    finally:
        jhvd.init()
    hvd.init(device="cpu")

    @pel.run
    def ptrain(state):
        raise pel.HostsUpdatedInterrupt("always")

    with pytest.raises(RuntimeError, match="reset limit") as perr:
        ptrain(pel.TensorState(params={"w": torch.ones(2)}, step=0),
               reset_limit=2, discovery=pel.DeviceDiscovery(device="cpu"))
    assert str(perr.value) == str(jerr.value)


def test_notification_manager_detects_change():
    current = {"devs": ["a", "b"]}
    mgr = pel.WorkerNotificationManager(poll_interval_s=0.05)
    mgr.init(pel.DeviceDiscovery(probe=lambda: current["devs"]))
    try:
        assert not mgr.changed
        current["devs"] = ["a"]
        for _ in range(100):
            if mgr.changed:
                break
            time.sleep(0.02)
        assert mgr.changed
        mgr.acknowledge()
        assert not mgr.changed
    finally:
        mgr.stop()


def test_host_discoveries_match_reference(tmp_path):
    from horovod_tpu.elastic import FixedHostDiscovery, ScriptHostDiscovery
    hosts = {"a": 4, "b": 4}
    assert pel.FixedHostDiscovery(hosts).find_available_hosts_and_slots() \
        == FixedHostDiscovery(hosts).find_available_hosts_and_slots() \
        == hosts
    script = tmp_path / "disc.sh"
    script.write_text("#!/bin/sh\necho host1:8\necho host2:4\necho host3\n")
    script.chmod(0o755)
    want = ScriptHostDiscovery(str(script)).find_available_hosts_and_slots()
    assert pel.ScriptHostDiscovery(
        str(script)).find_available_hosts_and_slots() == want == {
            "host1": 8, "host2": 4, "host3": 1}


def test_device_discovery_default_probe():
    assert pel.DeviceDiscovery(device="cpu").find_available_devices() == \
        [torch.device("cpu")]
    cuda = pel.DeviceDiscovery(device="cuda").find_available_devices()
    assert cuda == [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    assert not torch.cuda.is_initialized()


def test_init_refuses_unpromoted_spare_and_reinit_marks_epoch(
        monkeypatch, tmp_path):
    monkeypatch.setenv("HVD_TPU_ELASTIC_SPARE", "1")
    with pytest.raises(RuntimeError, match="hot spare"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    monkeypatch.delenv("HVD_TPU_ELASTIC_SPARE")
    hvd.init(device="cpu")
    e0 = hvd.core.init_epoch()
    hvd.shutdown()
    trace = tmp_path / "t.json"
    hvd.start_timeline(str(trace))
    hvd.init(device="cpu")
    assert hvd.core.init_epoch() == e0 + 1
    hvd.stop_timeline()
    import json
    events = json.loads(trace.read_text())["traceEvents"]
    marks = [e for e in events if e["name"] == "elastic_epoch"]
    anchors = [e for e in events if e["name"] == "clock_anchor"]
    assert [m["args"]["epoch"] for m in marks] == [e0 + 1]
    assert anchors and anchors[-1]["args"]["epoch"] == e0 + 1


def test_standby_waits_without_cuda_and_installs_the_contract(tmp_path):
    """A spare registers, heartbeats and blocks in standby() until
    promote_spare names its slot; then the port's rendezvous contract is
    in the environment and no CUDA context was made."""
    sdir = str(tmp_path)
    env = dict(os.environ, HVD_TPU_ELASTIC_SPARE="1",
               HVD_TPU_ELASTIC_SPARE_ID="spare-x",
               HVD_TPU_ELASTIC_STATE_DIR=sdir,
               PYTHONPATH=REPO)
    code = textwrap.dedent("""
        import json, os, torch
        from horovod_tpu_torch import elastic
        promo = elastic.standby_if_spare(poll_s=0.02)
        print(json.dumps({"promo": promo, "cuda": torch.cuda.is_initialized(),
                          "env": {k: os.environ.get(k) for k in (
                              "RANK", "WORLD_SIZE", "LOCAL_RANK",
                              "LOCAL_SIZE", "MASTER_ADDR", "MASTER_PORT",
                              "HVD_TPU_ELASTIC_RESTART",
                              "HVD_TPU_ELASTIC_FAILED_AT",
                              "HVD_TPU_ELASTIC_SPARE")}}))
    """)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 60
    while pel.list_spares(sdir) != ["spare-x"]:
        assert time.monotonic() < deadline and proc.poll() is None
        time.sleep(0.05)
    pel.promote_spare(sdir, "spare-x", rank=1, world=2,
                      coordinator="127.0.0.1:4567", restart=1,
                      failed_at=12.5)
    out, _ = proc.communicate(timeout=60)
    import json
    got = json.loads(out.strip().splitlines()[-1])
    assert got["cuda"] is False
    assert got["env"] == {
        "RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "LOCAL_SIZE": "2",
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "4567",
        "HVD_TPU_ELASTIC_RESTART": "1", "HVD_TPU_ELASTIC_FAILED_AT": "12.5",
        "HVD_TPU_ELASTIC_SPARE": None}
    assert pel.list_spares(sdir) == []


# -------------------------------------------------------------- fault plan

_PLANS = [
    "",
    "kill@rank=1,step=5",
    "kill@rank=1,step=5;stall@rank=0,step=7,seconds=2.5",
    "slow_write@rank=2,step=3,seconds=0.5,restart=*",
    "stall@rank=0,step=1,restart=2",
    "KILL@ rank = 3 , step = 4 ;",
    "kill@rank=1,step=8,space=net",
    "drop@rank=0,step=9",
    "delay@rank=1,step=2,seconds=0.25",
    "partition@rank=2,step=4,seconds=2",
    "crash_loop@rank=0,step=3,count=2",
    "flap@rank=1,step=1,seconds=3,period=0.25",
    "flap@rank=1,step=1,restart=0",
    "boom@rank=0,step=1",
    "kill@rank=0",
    "kill@step=1",
    "kill rank=0 step=1",
    "kill@rank=0,step=1,volume=11",
    "kill@rank=x,step=1",
    "kill@rank=-1,step=1",
    "kill@rank=1,step=5,restart=-1",
    "kill@rank=0,step=1,count=2",
    "stall@rank=0,step=1,period=1",
    "crash_loop@rank=0,step=1,count=0",
    "flap@rank=0,step=1,period=0",
    "drop@rank=0,step=1,space=step",
    "kill@rank=0,step=1,space=disk",
    "stall@rank=0,step=1,seconds=-1",
    "kill@rank=0,step=1,rank",
]


@pytest.mark.parametrize("plan", _PLANS)
def test_parse_plan_matches_reference(plan):
    try:
        want = jfaults.parse_plan(plan)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pfaults.parse_plan(plan)
        assert str(got.value) == str(e)
        return
    got = pfaults.parse_plan(plan)
    assert [dataclasses.asdict(a) for a in got] == \
        [dataclasses.asdict(a) for a in want]
    assert [a.describe() for a in got] == [a.describe() for a in want]


def test_config_validates_plan_and_elastic_knobs(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", "kill@rank=0")
    with pytest.raises(ValueError) as perr:
        pconfig.refresh()
    with pytest.raises(ValueError) as jerr:
        jconfig.refresh()
    assert str(perr.value) == str(jerr.value)
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", " kill@rank=0,step=2 ")
    monkeypatch.setenv("HOROVOD_ELASTIC_TIMEOUT", "45")
    monkeypatch.setenv("HOROVOD_PREEMPTION_NOTICE", "-3")
    p, j = pconfig.refresh(), jconfig.refresh()
    assert (p.fault_plan, p.elastic_timeout_seconds,
            p.preemption_notice_seconds) == (
        j.fault_plan, j.elastic_timeout_seconds,
        j.preemption_notice_seconds) == ("kill@rank=0,step=2", 45.0, 0.0)
    for k in ("HOROVOD_FAULT_PLAN", "HOROVOD_ELASTIC_TIMEOUT",
              "HOROVOD_PREEMPTION_NOTICE"):
        monkeypatch.delenv(k)
    p, j = pconfig.refresh(), jconfig.refresh()
    assert (p.fault_plan, p.elastic_timeout_seconds,
            p.preemption_notice_seconds) == ("", 600.0, 30.0) == (
        j.fault_plan, j.elastic_timeout_seconds,
        j.preemption_notice_seconds)


def _stall_counts():
    snap = hvd.metrics.snapshot()
    return {c["labels"]["kind"]: c["value"]
            for c in snap["counters"].get("fault_injected_total", [])}


def test_fault_point_fires_once_counts_and_marks(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN",
                       "stall@rank=0,step=2,seconds=0.2;"
                       "slow_write@rank=0,step=3,seconds=0.15;"
                       "stall@rank=1,step=2,seconds=5")
    pconfig.refresh()
    hvd.reset_metrics()
    trace = tmp_path / "t.json"
    hvd.start_timeline(str(trace))
    t0 = time.perf_counter()
    pfaults.fault_point(1)
    assert time.perf_counter() - t0 < 0.15
    t0 = time.perf_counter()
    pfaults.fault_point(2)                 # rank 0's stall, not rank 1's
    assert 0.2 <= time.perf_counter() - t0 < 2
    t0 = time.perf_counter()
    pfaults.fault_point(2)                 # already fired this attempt
    assert time.perf_counter() - t0 < 0.15
    assert pfaults.slow_write_seconds() == 0.0
    pfaults.fault_point(3)
    assert pfaults.slow_write_seconds() == 0.15
    hvd.stop_timeline()
    assert _stall_counts() == {"stall": 1, "slow_write": 1}
    import json
    marks = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e["name"] == "FAULT"]
    assert [(m["args"]["kind"], m["args"]["step"]) for m in marks] == \
        [("stall", 2), ("slow_write", 3)]


def test_fault_point_restart_gating_and_rank(monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN",
                       "stall@rank=0,step=1,seconds=5;"
                       "stall@rank=0,step=2,seconds=0.1,restart=*;"
                       "stall@rank=3,step=4,seconds=0.1,restart=1")
    monkeypatch.setenv("HVD_TPU_ELASTIC_RESTART", "1")
    pconfig.refresh()
    t0 = time.perf_counter()
    pfaults.fault_point(1)              # restart=0 only: must not fire
    assert time.perf_counter() - t0 < 0.5
    t0 = time.perf_counter()
    pfaults.fault_point(2)              # restart=*: fires
    assert time.perf_counter() - t0 >= 0.1
    t0 = time.perf_counter()
    pfaults.fault_point(4)              # rank 3's: not this rank (RANK 0)
    assert time.perf_counter() - t0 < 0.1
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29999")
    t0 = time.perf_counter()
    pfaults.fault_point(4)              # RANK 3 before init
    assert time.perf_counter() - t0 >= 0.1


def test_net_faults_match_reference(monkeypatch):
    plan = ("drop@rank=0,step=2;delay@rank=0,step=2,seconds=0.25;"
            "delay@rank=1,step=3,seconds=0.5;kill@rank=0,step=2;"
            "partition@rank=2,step=1,seconds=30;"
            "flap@rank=3,step=1,seconds=30,period=10")
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", plan)
    pconfig.refresh()
    jconfig.refresh()
    for rank, step in ((0, 1), (0, 2), (0, 2), (1, 3), (1, 2), (2, 1),
                       (3, 1)):
        assert pfaults.net_fault(step, rank) == \
            jfaults.net_fault(step, rank)
    for rank in range(4):
        assert pfaults.partitioned(rank) == jfaults.partitioned(rank)
    assert [pfaults.partitioned(r) for r in range(4)] == \
        [False, False, True, True]


def test_kill_sigkills_the_process_at_its_step():
    code = textwrap.dedent("""
        import sys
        from horovod_tpu_torch import faults
        for s in range(5):
            faults.fault_point(s)
            print("step", s, flush=True)
    """)
    env = dict(os.environ, PYTHONPATH=REPO,
               HOROVOD_FAULT_PLAN="kill@rank=0,step=2")
    first = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, text=True)
    # a relaunch does not kill again (both processes run at once)
    again = subprocess.Popen([sys.executable, "-c", code],
                             env=dict(env, HVD_TPU_ELASTIC_RESTART="1"),
                             stdout=subprocess.PIPE, text=True)
    out, _ = first.communicate(timeout=60)
    assert first.returncode == -9
    assert out.split() == ["step", "0", "step", "1"]
    out, _ = again.communicate(timeout=60)
    assert again.returncode == 0 and out.count("step") == 5
