"""Checkpoints of horovod_tpu_torch against the reference
(``horovod_tpu.checkpoint_sharded``), on the CPU.

* The on-disk format both ways: a step written by the reference's
  ``ShardedCheckpointManager`` (4 shards, a replicated tree, meta)
  restores in the port at 4 and at 2 shards equal to the reference's own
  restore; a step written by the port restores in the reference; the two
  managers write the same manifest and receipt fields, leaves and key
  strings. Every comparison is exact (the same bytes; bf16 as raw words).
* The two-phase commit: a torn step is invisible and refuses a restore, a
  missing shard file is named, receipts are salted with the attempt, the
  ``slow_write`` fault stalls without tearing, pruning keeps
  ``max_to_keep``, the recovery stamp is consumed once.
* ``save_state`` / ``adopt_state`` of a ``TorchState``: a fresh process's
  state (a fresh ``AdamW`` with no state yet) adopts the commit exactly,
  ``step`` tensors and ``param_groups`` included; a newer in-memory
  commit is kept.
* The full-state ``CheckpointManager``.
"""

import json
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import checkpoint_sharded as jcs
from horovod_tpu import config as jconfig
from horovod_tpu_torch import checkpoint as pck
from horovod_tpu_torch import checkpoint_sharded as pcs
from horovod_tpu_torch import config as pconfig
from horovod_tpu_torch import elastic as pel
from horovod_tpu_torch import faults as pfaults

N = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HOROVOD_FAULT_PLAN", "HVD_TPU_ELASTIC_RESTART",
              "HVD_TPU_ELASTIC_FAILED_AT"):
        monkeypatch.delenv(k, raising=False)
    yield
    monkeypatch.undo()
    pfaults.reset()
    pconfig.refresh()
    jconfig.refresh()


def _data():
    g = np.random.default_rng(11)
    return {
        "mu": g.standard_normal((N, 5)).astype(np.float32),
        "nu": g.random((N, 5)).astype(np.float32),
        "step": np.full((N,), 12, np.int32),
        "w": g.standard_normal((3,)).astype(np.float32),
        "b": np.float32(0.25),
        "e": g.standard_normal((2, 2)).astype(ml_dtypes.bfloat16),
    }


def _ref_trees(d):
    shards = {"opt_state": {"mu": jnp.asarray(d["mu"]),
                            "nu": jnp.asarray(d["nu"]),
                            "step": jnp.asarray(d["step"])}}
    rep = {"params": {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])},
           "emb": jnp.asarray(d["e"])}
    return shards, rep


def _port_trees(d):
    shards = {"opt_state": {"mu": torch.from_numpy(d["mu"]),
                            "nu": torch.from_numpy(d["nu"]),
                            "step": torch.from_numpy(d["step"])}}
    rep = {"params": {"w": torch.from_numpy(d["w"]),
                      "b": torch.tensor(d["b"])},
           "emb": torch.from_numpy(d["e"].view(np.int16)).view(
               torch.bfloat16)}
    return shards, rep


_UNPADDED = {"['opt_state']['mu']": 17, "['opt_state']['nu']": 17}
_META = {"cursor": 7, "rng": [1, 2]}


def _raw(x):
    """Exact bytes of a restored leaf: a torch tensor or a numpy array
    (bf16 both as 16-bit words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), tuple(x.shape)
    a = np.asarray(x)
    if a.dtype in (np.dtype("V2"), np.dtype(ml_dtypes.bfloat16)):
        a = a.view(np.int16)
    return a.tobytes(), tuple(a.shape)


def _assert_same_restore(port, ref):
    assert port.step == ref.step and port.meta == ref.meta
    for name in ("shards", "replicated"):
        p, j = getattr(port, name), getattr(ref, name)
        assert sorted(p) == sorted(j), name
        for k in j:
            assert _raw(p[k]) == _raw(j[k]), (name, k)


def test_reference_step_restores_in_the_port(tmp_path):
    d = _data()
    shards, rep = _ref_trees(d)
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    jm.save(3, shards=shards, replicated=rep, meta=_META,
            unpadded=_UNPADDED, wait=True)
    jm.close()
    pm = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    assert pm.latest_step() == jm.latest_step() == 3
    for n in (N, 2):
        _assert_same_restore(pm.restore(num_shards=n),
                             jm.restore(num_shards=n))
    r2 = pm.restore(num_shards=2)
    assert tuple(r2.shards["['opt_state']['mu']"].shape) == (2, 9)
    assert r2.replicated["['emb']"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        r2.replicated["['emb']"].view(torch.int16).numpy(),
        d["e"].view(np.int16))
    # with templates: the port's tree and dtypes
    tpl_s, tpl_r = _port_trees(d)
    r = pm.restore(shards_template=tpl_s, replicated_template=tpl_r)
    assert torch.equal(r.shards["opt_state"]["mu"], tpl_s["opt_state"]["mu"])
    assert torch.equal(r.replicated["emb"], tpl_r["emb"])
    pm.close()


def test_port_step_restores_in_the_reference(tmp_path):
    d = _data()
    shards, rep = _port_trees(d)
    pm = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pm.save(5, shards=shards, replicated=rep, meta=_META,
            unpadded=_UNPADDED, wait=True)
    pm.close()
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    assert jm.latest_step() == 5
    for n in (N, 2):
        _assert_same_restore(pm.restore(num_shards=n),
                             jm.restore(num_shards=n))
    jm.close()


def test_both_write_the_same_manifest_and_receipts(tmp_path):
    """Same data through both managers: the same files (names, sizes),
    leaves, key strings and JSON fields; only wall times differ. The port
    also records the dtype of a replicated bf16 leaf, which numpy's |V2
    cannot say."""
    d = _data()
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "j"))
    jm.save(1, *_ref_trees(d), meta=_META, unpadded=_UNPADDED, wait=True)
    pm = pcs.ShardedCheckpointManager(str(tmp_path / "p"))
    pm.save(1, *_port_trees(d), meta=_META, unpadded=_UNPADDED, wait=True)
    jman, pman = jm.read_manifest(1), pm.read_manifest(1)
    assert set(pman) == set(jman)
    for k in jman:
        if k in ("wall_time", "leaves"):
            continue
        assert pman[k] == jman[k], k
    bf16 = {"['emb']": {"shape": [2, 2], "dtype": "bfloat16"}}
    assert pman["leaves"] == dict(jman["leaves"], **bf16)
    step = "step-00000001"
    assert sorted(os.listdir(tmp_path / "p" / step)) == \
        sorted(os.listdir(tmp_path / "j" / step))
    receipt = "rank-00000-of-00001.a0.ok"
    jr = json.loads((tmp_path / "j" / step / receipt).read_text())
    pr = json.loads((tmp_path / "p" / step / receipt).read_text())
    assert set(pr) == set(jr)
    assert pr["files"] == jr["files"]
    for f in jr["files"]:
        with np.load(tmp_path / "j" / step / f) as zj, \
                np.load(tmp_path / "p" / step / f) as zp:
            assert zp.files == zj.files
            for k in zj.files:
                assert zp[k].dtype == zj[k].dtype
                assert zp[k].tobytes() == zj[k].tobytes()
    jm.close()
    pm.close()


def test_torn_step_is_invisible_and_refuses_restore(tmp_path):
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    m.save(4, shards={"v": torch.ones(N, 3)}, wait=True)
    os.makedirs(tmp_path / "c" / "step-00000009")
    (tmp_path / "c" / "step-00000009" / "shard-00000-of-00004.npz"
     ).write_bytes(b"partial")
    assert m.latest_step() == 4
    with pytest.raises(pcs.TornCheckpointError, match="torn"):
        m.restore(step=9)
    with pytest.raises(FileNotFoundError, match="no checkpoint manifest"):
        m.restore(step=10)
    m.close()


def test_missing_shard_file_is_named(tmp_path):
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    m.save(3, shards={"v": torch.ones(N, 3)}, wait=True)
    os.remove(tmp_path / "c" / "step-00000003" / "shard-00002-of-00004.npz")
    with pytest.raises(FileNotFoundError, match="shard-00002"):
        m.restore(step=3)
    m.close()


def test_bad_shard_leaves_and_template_mismatch(tmp_path):
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="scalar"):
        m.save(1, shards={"v": torch.tensor(1.0)})
    with pytest.raises(ValueError, match="leading dim"):
        m.save(1, shards={"a": torch.ones(N, 2), "b": torch.ones(N + 1, 2)})
    m.save(1, replicated={"params": {"w": torch.ones(3)}}, wait=True)
    with pytest.raises(KeyError, match="does not match"):
        m.restore(step=1, replicated_template={"params": {"v": torch.ones(3)}})
    m.close()


def test_receipts_are_attempt_salted(tmp_path, monkeypatch):
    d = tmp_path / "c"
    stale_dir = d / "step-00000002"
    os.makedirs(stale_dir)
    (stale_dir / "rank-00000-of-00001.a0.ok").write_text(json.dumps(
        {"rank": 0, "num_ranks": 1, "attempt": 0, "files": {}, "leaves": {},
         "wall_time": 0.0}))
    monkeypatch.setenv("HVD_TPU_ELASTIC_RESTART", "1")
    m = pcs.ShardedCheckpointManager(str(d))
    m.save(2, shards={"v": torch.ones(N, 2)}, wait=True)
    names = os.listdir(stale_dir)
    assert "rank-00000-of-00001.a1.ok" in names
    assert "rank-00000-of-00001.a0.ok" not in names
    assert m.latest_step() == 2
    m.close()


def test_slow_write_stalls_without_tearing(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_FAULT_PLAN",
                       "slow_write@rank=0,step=1,seconds=0.15")
    pconfig.refresh()
    pfaults.fault_point(1)
    assert pfaults.slow_write_seconds() == 0.15
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    t0 = time.perf_counter()
    m.save(1, shards={"v": torch.ones(N, 2)}, wait=True)
    assert time.perf_counter() - t0 >= N * 0.15     # one delay a file
    assert m.latest_step() == 1
    assert torch.equal(m.restore().shards["['v']"], torch.ones(N, 2))
    m.close()


def test_pruning_keeps_max_to_keep_and_bounds_pending(tmp_path):
    hvd.reset_metrics()
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                                     max_pending=1)
    v = torch.zeros(N, 2)
    for s in (1, 2, 3):
        v.fill_(float(s))
        m.save(s, shards={"v": v})          # a mutable tensor: copied
    m.wait()
    assert m.all_steps() == [2, 3]
    assert not os.path.isdir(tmp_path / "c" / "step-00000001")
    for s in (2, 3):
        assert torch.equal(m.restore(step=s).shards["['v']"],
                           torch.full((N, 2), float(s)))
    holds = hvd.metrics.snapshot()["histograms"][
        "checkpoint_save_hold_seconds"]
    assert holds[0]["count"] == 3
    m.close()


def test_recovery_stamp_consumed_once(tmp_path, monkeypatch):
    hvd.reset_metrics()
    m = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    m.save(1, shards={"v": torch.ones(N, 2)}, wait=True)
    monkeypatch.setenv("HVD_TPU_ELASTIC_FAILED_AT", str(time.time() - 4.0))
    pcs.stash_failure_stamp()
    assert "HVD_TPU_ELASTIC_FAILED_AT" not in os.environ
    m.restore()
    g = hvd.metrics.gauge("elastic_recovery_seconds")
    first = g.value
    assert 4.0 <= first < 60.0
    time.sleep(0.05)
    m.restore()
    assert g.value == first
    m.close()


# ------------------------------------------------------- elastic bridge

def _trained_state(steps=3):
    g = torch.Generator().manual_seed(0)
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 3))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    m[1].bias.data = m[1].bias.data.to(torch.bfloat16).float()
    opt = torch.optim.AdamW(m.parameters(), lr=1e-2, betas=(0.8, 0.95),
                            weight_decay=1e-4, eps=1e-8)
    m.register_buffer("scale", torch.tensor([1.5], dtype=torch.bfloat16))
    st = pel.TorchState(model=m, optimizer=opt, step=0, name="run-a")
    x = torch.randn(6, 4, generator=g)
    for s in range(steps):
        opt.zero_grad()
        m(x).square().mean().backward()
        opt.step()
        st.step = s + 1
        st.commit()
    return m, opt, st


def _fresh():
    m = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Linear(8, 3))
    m.register_buffer("scale", torch.tensor([0.0], dtype=torch.bfloat16))
    opt = torch.optim.AdamW(m.parameters(), lr=1e-2, betas=(0.8, 0.95),
                            weight_decay=1e-4, eps=1e-8)
    return m, opt, pel.TorchState(model=m, optimizer=opt, step=0)


def _exact(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _exact(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _exact(x, y)
    else:
        assert a == b and type(a) is type(b)


def test_save_state_adopt_state_round_trip_exact(tmp_path):
    m, opt, st = _trained_state()
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.save_state(mgr, 2, st, meta={"cursor": 3}, wait=True)
    man = mgr.read_manifest(2)
    assert man["meta"]["attrs"] == {"step": 3, "name": "run-a"}
    assert man["meta"]["cursor"] == 3 and man["num_shards"] == 0
    assert "['optimizer']['state'][0]['exp_avg']" in \
        json.dumps(man["meta"]["trees"])
    m2, opt2, st2 = _fresh()
    assert opt2.state_dict()["state"] == {}
    assert pcs.adopt_state(mgr, st2) == 2
    _exact(m2.state_dict(), m.state_dict())
    _exact(opt2.state_dict(), opt.state_dict())
    assert st2.step == 3 and st2.name == "run-a"
    # the next step is the one the original would take
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(9))
    for mm, oo in ((m, opt), (m2, opt2)):
        oo.zero_grad()
        mm(x).square().mean().backward()
        oo.step()
    _exact(m2.state_dict(), m.state_dict())
    mgr.close()


def test_adopt_keeps_a_newer_in_memory_commit(tmp_path):
    m, opt, st = _trained_state(steps=2)
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.save_state(mgr, 1, st, wait=True)
    x = torch.randn(6, 4, generator=torch.Generator().manual_seed(5))
    opt.zero_grad()
    m(x).square().mean().backward()
    opt.step()
    st.step = 3
    st.commit()                     # newer than the manifest
    newer = {k: v.clone() for k, v in m.state_dict().items()}
    with torch.no_grad():
        m[0].weight.add_(1.0)       # post-failure damage
    assert pcs.adopt_state(mgr, st) == 1
    _exact(m.state_dict(), newer)
    assert st.step == 3
    mgr.close()


def test_elastic_run_with_checkpoint_adopts_on_reset(tmp_path):
    """``@run(checkpoint=mgr)``: after a membership change rank 0 adopts
    the newest published step before sync(): the in-memory commit that ran
    ahead of the manifest wins, an older one is replaced by the
    manifest's."""
    hvd.init(device="cpu")
    try:
        m, opt, st = _trained_state(steps=1)
        mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
        pcs.save_state(mgr, 0, st, wait=True)
        want = {k: v.clone() for k, v in m.state_dict().items()}
        st.commit_count = 0         # an older commit than the manifest's
        st._saved["model"] = {k: torch.zeros_like(v)
                              for k, v in want.items()}
        devs = {"d": ["a", "b"]}
        seen = []

        @pel.run
        def train(state):
            if devs["d"] == ["a", "b"]:
                devs["d"] = ["a"]
                raise pel.HostsUpdatedInterrupt("changed")
            seen.append({k: v.clone() for k, v in m.state_dict().items()})

        hvd.reset_metrics()
        train(st, checkpoint=mgr,
              discovery=pel.DeviceDiscovery(probe=lambda: devs["d"]))
        _exact(seen[0], want)
        snap = hvd.metrics.snapshot()
        assert snap["counters"]["elastic_shard_adoption_total"][0][
            "value"] == 1
        assert snap["counters"]["elastic_reset_total"][0]["value"] == 1
        mgr.close()
    finally:
        hvd.shutdown()


# --------------------------------------------------------- full state

def test_full_checkpoint_manager(tmp_path):
    hvd.reset_metrics()
    m = pck.CheckpointManager(str(tmp_path / "f"), max_to_keep=2)
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 1,
             "h": torch.ones(2, dtype=torch.bfloat16)}
    for s in (1, 2, 3):
        state["step"] = s
        m.save(s, state)
        state["w"].add_(1.0)        # after save: the snapshot is a copy
    m.wait()
    assert m.all_steps() == [2, 3] and m.latest_step() == 3
    out = m.restore()
    assert out["step"] == 3
    assert torch.equal(out["w"], torch.arange(6.0).reshape(2, 3) + 2)
    tpl = {"w": torch.zeros(2, 3, dtype=torch.float64), "step": 0,
           "h": torch.zeros(2, dtype=torch.bfloat16)}
    out = m.restore(step=2, template=tpl)
    assert out["w"].dtype == torch.float64 and out["step"] == 2
    m.close()
    pck.save_checkpoint(str(tmp_path / "g"), {"x": torch.ones(2)}, 7)
    assert pck.latest_step(str(tmp_path / "g")) == 7
    assert torch.equal(pck.restore_checkpoint(str(tmp_path / "g"))["x"],
                       torch.ones(2))
    snap = hvd.metrics.snapshot()
    saves = [h for h in snap["histograms"]["checkpoint_save_seconds"]
             if h["labels"] == {"kind": "full"}]
    assert saves and saves[0]["count"] == 4
    assert [g["value"] for g in snap["gauges"][
        "checkpoint_interval_seconds"] if g["labels"] == {"kind": "full"}]
    with pytest.raises(FileNotFoundError):
        pck.restore_checkpoint(str(tmp_path / "empty"))


# ------------------------------------------------------------ ZeRO-1

ZL = 17          # unpadded flat length: 4 shards of 5, 3 of them padding


def _zero1_global(n=4, seed=4):
    """A reference ZeRO-1 state over n shards: padding zero, as
    ``sharded_adamw`` keeps it."""
    from horovod_tpu.optimizer_sharded import ShardedAdamWState as JState
    c = -(-ZL // n)
    g = np.random.default_rng(seed)
    mu = np.zeros(n * c, np.float32)
    nu = np.zeros(n * c, np.float32)
    mu[:ZL] = g.standard_normal(ZL)
    nu[:ZL] = g.random(ZL)
    return JState(step=jnp.full((n,), 9, jnp.int32), mu=jnp.asarray(mu),
                  nu=jnp.asarray(nu))


def _port_rows(jstate):
    """Each rank's row of a reference global state, as the port holds it."""
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    n = int(jstate.step.shape[0])
    glob = ShardedAdamWState(*(torch.from_numpy(np.array(x))
                               for x in jstate))
    return [pcs.unpack_opt_state(pcs.pack_opt_state(glob)[0], rank=r)
            for r in range(n)]


def _unpadded_bytes(mu):
    return np.asarray(mu, np.float32).reshape(-1)[:ZL].tobytes()


def _restored_rows(res, m):
    packed = {k.split("['opt_state']")[1].strip("[]'"): v
              for k, v in res.shards.items()}
    return [pcs.unpack_opt_state(packed, rank=r) for r in range(m)]


@pytest.mark.parametrize("m", [4, 2, 1])
def test_reference_zero1_step_restores_in_the_port(tmp_path, m):
    """Written by the reference at n 4, restored by the port at m: rank
    r's row is the reference's own restore's row r, bit for bit, and the
    unpadded moments are the saved ones."""
    jstate = _zero1_global()
    packed, unp, info = jcs.pack_opt_state(jstate, unpadded_len=ZL)
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    jm.save(5, shards={"opt_state": packed},
            unpadded={f"['opt_state']{k}": v for k, v in unp.items()},
            meta={"sharded": {"opt_state": info}}, wait=True)
    want = jcs.unpack_opt_state({
        k.split("['opt_state']")[1].strip("[]'"): v
        for k, v in jm.restore(num_shards=m).shards.items()})
    jm.close()
    rows = _restored_rows(
        pcs.ShardedCheckpointManager(str(tmp_path / "c")).restore(
            num_shards=m), m)
    c = -(-ZL // m)
    for r, row in enumerate(rows):
        assert row.step.dtype == torch.int32 and row.step.tolist() == [9]
        assert tuple(row.mu.shape) == (c,)
        for f in ("mu", "nu"):
            assert getattr(row, f).numpy().tobytes() == np.asarray(
                getattr(want, f))[r * c:(r + 1) * c].tobytes()
    got_mu = np.concatenate([row.mu.numpy() for row in rows])
    assert _unpadded_bytes(got_mu) == _unpadded_bytes(jstate.mu)


def _save_as_ranks(directory, rows, step=6):
    """Four port ranks, simulated in one process, each saving its row."""
    n = len(rows)
    for r in list(range(1, n)) + [0]:
        packed, unp, _ = pcs.pack_opt_state(rows[r], unpadded_len=ZL)
        pm = pcs.ShardedCheckpointManager(directory)
        real = pcs._world
        pcs._world = lambda r=r: (n, r)
        try:
            pm.save(step, shards={"opt_state": packed},
                    unpadded={f"['opt_state']{k}": v
                              for k, v in unp.items()},
                    num_shards=n, owned=[r], wait=True)
        finally:
            pcs._world = real
        pm.close()


def test_save_with_owned_takes_exactly_the_owned_shards(tmp_path):
    """``save(owned=)``: each leaf holds the owned shards by position, one
    rule whatever the world; whole shard-major leaves, or ``owned``
    without ``num_shards``, are refused."""
    pm = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="owned shards"):
        pm.save(1, shards={"v": torch.zeros(2, 3)}, num_shards=2,
                owned=[1])
    with pytest.raises(ValueError, match="needs num_shards"):
        pm.save(1, shards={"v": torch.zeros(1, 3)}, owned=[0])
    pm.save(2, shards={"v": torch.full((1, 3), 5.0)}, num_shards=1,
            owned=[0], wait=True)
    assert torch.equal(pm.restore(2).shards["['v']"],
                       torch.full((1, 3), 5.0))
    pm.close()


@pytest.mark.parametrize("m", [4, 2, 1])
def test_port_zero1_rows_restore_in_the_reference(tmp_path, m):
    """Each of four port ranks writes the row it owns; the reference
    restores the step at m, bit for bit on the unpadded moments."""
    jstate = _zero1_global()
    _save_as_ranks(str(tmp_path / "c"), _port_rows(jstate))
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    man = jm.read_manifest(6)
    assert man["num_shards"] == 4 and man["num_ranks"] == 4
    assert man["leaves"]["['opt_state']['mu']"]["unpadded"] == ZL
    got = jcs.unpack_opt_state({
        k.split("['opt_state']")[1].strip("[]'"): v
        for k, v in jm.restore(num_shards=m).shards.items()})
    jm.close()
    assert np.asarray(got.step).tolist() == [9] * m
    for f in ("mu", "nu"):
        assert _unpadded_bytes(getattr(got, f)) == \
            _unpadded_bytes(getattr(jstate, f))
        assert np.asarray(getattr(got, f)).shape == (m * -(-ZL // m),)


@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_reshard_opt_state_in_memory_as_the_reference(m):
    jstate = _zero1_global()
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    glob = ShardedAdamWState(*(torch.from_numpy(np.array(x))
                               for x in jstate))
    got = pcs.reshard_opt_state(glob, m, unpadded_len=ZL)
    want = jcs.reshard_opt_state(jstate, m, unpadded_len=ZL)
    for f in ("step", "mu", "nu"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _tensor_state(row, params, epoch):
    return pel.TensorState(params=params, opt_state=row, epoch=epoch)


def test_tensor_state_with_zero1_saves_and_adopts_exactly(tmp_path):
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    row = _port_rows(_zero1_global(n=1))[0]
    params = {"w": torch.randn(ZL, generator=torch.Generator()
                               .manual_seed(2))}
    st = _tensor_state(row, params, 3)
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.save_state(mgr, 7, st, wait=True)
    man = mgr.read_manifest(7)
    assert man["meta"]["sharded"] == {"opt_state": {"error_feedback": False}}
    assert man["leaves"]["['opt_state']['mu']"]["unpadded"] == ZL
    fresh = _tensor_state(
        ShardedAdamWState(torch.zeros(1, dtype=torch.int32),
                          torch.zeros(ZL), torch.zeros(ZL)),
        {"w": torch.zeros(ZL)}, 0)
    assert pcs.adopt_state(mgr, fresh) == 7
    for f in ("step", "mu", "nu"):
        _exact(getattr(fresh.opt_state, f), getattr(row, f))
    _exact(fresh.params, params)
    assert fresh.epoch == 3 and isinstance(fresh.opt_state,
                                           ShardedAdamWState)
    # The reference reads the port's shard files.
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    res = jm.restore(7)
    assert np.asarray(res.shards["['opt_state']['mu']"]).tobytes() == \
        row.mu.numpy().tobytes()
    jm.close()
    mgr.close()


def test_tensor_state_rows_of_two_ranks_adopt_on_one(tmp_path):
    """2 -> 1: each of two ranks saves its committed row through
    ``save_state``; one rank adopts the whole unpadded moments."""
    rows = _port_rows(_zero1_global(n=2))
    params = {"w": torch.arange(ZL, dtype=torch.float32)}
    real = pcs._world
    for r in (1, 0):
        pcs._world = lambda r=r: (2, r)
        try:
            mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
            pcs.save_state(mgr, 4, _tensor_state(rows[r], params, 1),
                           wait=True)
            mgr.close()
        finally:
            pcs._world = real
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    fresh = _tensor_state(
        ShardedAdamWState(torch.zeros(1, dtype=torch.int32),
                          torch.zeros(ZL), torch.zeros(ZL)),
        {"w": torch.zeros(ZL)}, 0)
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.adopt_state(mgr, fresh)
    mgr.close()
    whole = torch.cat([rows[0].mu, rows[1].mu])[:ZL]
    assert fresh.opt_state.mu.numpy().tobytes() == whole.numpy().tobytes()
    assert fresh.opt_state.step.tolist() == [9]
    _exact(fresh.params, params)


def test_reference_state_with_error_feedback_adopts_without_it(tmp_path):
    """A reference ``JaxState`` whose ZeRO-1 state is wrapped in
    ``ErrorFeedbackState`` restores in the port as the plain state (the
    port has no wrapper)."""
    from horovod_tpu.elastic.state import JaxState
    from horovod_tpu.optimizer import ErrorFeedbackState
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    jstate = _zero1_global(n=2)
    w = np.random.default_rng(8).standard_normal(ZL).astype(np.float32)
    js = JaxState(params={"w": jnp.asarray(w)},
                  opt_state=ErrorFeedbackState(
                      jstate, {"w": jnp.zeros(ZL, jnp.float32)}))
    jm = jcs.ShardedCheckpointManager(str(tmp_path / "c"))
    jcs.save_state(jm, 2, js, wait=True)
    jm.close()
    fresh = _tensor_state(
        ShardedAdamWState(torch.zeros(1, dtype=torch.int32),
                          torch.zeros(ZL), torch.zeros(ZL)),
        {"w": torch.zeros(ZL)}, 0)
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.adopt_state(mgr, fresh)
    mgr.close()
    assert isinstance(fresh.opt_state, ShardedAdamWState)
    assert _unpadded_bytes(fresh.opt_state.mu) == _unpadded_bytes(jstate.mu)
    assert fresh.params["w"].numpy().tobytes() == w.tobytes()


def test_newer_commit_is_kept_and_resharded_as_the_reference(tmp_path):
    """An in-memory commit newer than the manifest is kept; its ZeRO-1
    state goes through the in-memory reshard (stripped to the unpadded
    length the parameters give), as the reference's
    ``_reshard_committed`` does."""
    from horovod_tpu.elastic.state import JaxState
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    jstate = _zero1_global(n=1)
    row = _port_rows(jstate)[0]
    w = np.arange(ZL, dtype=np.float32)
    st = _tensor_state(row, {"w": torch.from_numpy(w.copy())}, 1)
    mgr = pcs.ShardedCheckpointManager(str(tmp_path / "c"))
    pcs.save_state(mgr, 1, st, wait=True)
    st.opt_state = ShardedAdamWState(row.step + 1, row.mu * 2, row.nu * 3)
    st.commit()
    assert pcs.adopt_state(mgr, st) == 1
    mgr.close()
    js = JaxState(params={"w": jnp.asarray(w)}, opt_state=jstate._replace(
        step=jstate.step + 1, mu=jstate.mu * 2, nu=jstate.nu * 3))
    jcs._reshard_committed(js, 1)
    want = js._saved_pytrees["opt_state"]
    for f in ("step", "mu", "nu"):
        assert getattr(st.opt_state, f).numpy().tobytes() == \
            np.asarray(getattr(want, f)).tobytes(), f


_ELASTIC_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint_sharded as pcs
from horovod_tpu_torch import elastic as pel
from horovod_tpu_torch.optimizer_sharded import (ShardedAdamWState,
                                                 sharded_adamw)

directory, out, mode = sys.argv[2], sys.argv[3], sys.argv[4]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
mgr = pcs.ShardedCheckpointManager(directory)
opt = sharded_adamw(0.05, weight_decay=0.1)
shapes = {"w": (4, 5), "b": (3,)}          # 23 elements: padded at n 2
res = {}


def grads(step):
    g = np.random.default_rng((r, step))
    return {k: torch.tensor(g.standard_normal(s), dtype=torch.float32)
            for k, s in shapes.items()}


def keep(tag, ts):
    for f in ("step", "mu", "nu"):
        res[f"{tag}:{f}"] = getattr(ts.opt_state, f).numpy().copy()
    for k in shapes:
        res[f"{tag}:p:{k}"] = ts.params[k].numpy().copy()
    res[f"{tag}:epoch"] = np.array(ts.epoch)


def reset(ts):
    devs = {"d": ["a", "b"]}
    seen = []

    @pel.run
    def train(state):
        if devs["d"] == ["a", "b"]:
            devs["d"] = ["a"]
            # Post-failure damage that the adoption must undo.
            state.opt_state = ShardedAdamWState(
                state.opt_state.step * 0, state.opt_state.mu + 7,
                state.opt_state.nu + 7)
            raise pel.HostsUpdatedInterrupt("changed")
        seen.append(True)

    train(ts, checkpoint=mgr,
          discovery=pel.DeviceDiscovery(probe=lambda: devs["d"]))
    assert seen == [True]


if mode == "first":
    g = np.random.default_rng(3)
    params = {k: torch.tensor(g.standard_normal(s), dtype=torch.float32)
              for k, s in shapes.items()}
    ts = pel.TensorState(params=params, opt_state=opt.init(params), epoch=0)
    for s in range(3):
        upd, row = opt.update(grads(s), ts.opt_state, ts.params)
        ts.params = {k: ts.params[k] + upd[k] for k in shapes}
        ts.opt_state, ts.epoch = row, s + 1
        ts.commit()
        if s == 1:
            pcs.save_state(mgr, 2, ts, wait=True)
            keep("saved", ts)
    keep("newer", ts)
    reset(ts)                     # every rank kept its newer commit
    keep("in_memory", ts)
    if r == 1:                    # as if rank 1 were a fresh process
        ts.commit_count = 0
    reset(ts)                     # so every rank adopts the manifest
    keep("mixed", ts)
else:                             # a relaunched world of fresh processes
    zeros = {k: torch.zeros(s) for k, s in shapes.items()}
    ts = pel.TensorState(params=zeros, opt_state=opt.init(zeros), epoch=0)
    reset(ts)
    keep("relaunch", ts)
np.savez(f"{out}.rank{r}.npz", **res)
mgr.close()
hvd.shutdown()
"""


def _ranks(tmp_path, np_, mode):
    import subprocess
    import sys
    script = tmp_path / "elastic_worker.py"
    script.write_text(_ELASTIC_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(np_), "--timeout", "240", str(script), repo,
         str(tmp_path / "c"), str(tmp_path / f"{mode}{np_}"), mode],
        cwd=repo, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, out[-2000:] + err[-4000:]


def test_zero1_rows_adopt_on_every_rank_through_elastic_run(tmp_path):
    """Two gloo ranks train ``sharded_adamw`` in an elastic
    ``TensorState``, save their rows at step 2 and commit step 3. Through
    ``hvd.elastic.run(checkpoint=...)``: a reset that lost no process keeps
    each rank's newer row; a reset where one rank's commit is older than
    the manifest's (a fresh process) adopts the manifest on both ranks; a
    relaunched world of two fresh processes, and one of one (2 -> 1),
    adopts each rank's row of the manifest. Every row is compared exactly
    with the saved one, the parameters and the epoch too."""
    _finish(_ranks(tmp_path, 2, "first"))
    again = [_ranks(tmp_path, 2, "relaunch"), _ranks(tmp_path, 1,
                                                     "relaunch")]
    for p in again:
        _finish(p)
    first = [np.load(tmp_path / f"first2.rank{r}.npz") for r in (0, 1)]

    def same(a, tag_a, b, tag_b, fields=("step", "mu", "nu", "p:w", "p:b",
                                         "epoch")):
        for f in fields:
            x, y = a[f"{tag_a}:{f}"], b[f"{tag_b}:{f}"]
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (tag_a, tag_b, f)

    for r in (0, 1):
        assert first[r]["saved:mu"].shape == (12,)
        assert first[r]["newer:step"].tolist() == [3]
        same(first[r], "in_memory", first[r], "newer")
        same(first[r], "mixed", first[r], "saved")
        same(np.load(tmp_path / f"relaunch2.rank{r}.npz"), "relaunch",
             first[r], "saved")
    one = np.load(tmp_path / "relaunch1.rank0.npz")
    for f in ("mu", "nu"):
        whole = np.concatenate([first[r][f"saved:{f}"] for r in (0, 1)])
        assert one[f"relaunch:{f}"].tobytes() == whole[:23].tobytes()
    same(one, "relaunch", first[0], "saved", ("step", "p:w", "p:b",
                                              "epoch"))


def test_sync_refuses_rows_of_another_world():
    """A committed row of rank 1 of two cannot be restored by the one rank
    of a world of one: ``sync()`` raises instead of training on it."""
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    row = ShardedAdamWState(torch.ones(1, dtype=torch.int32),
                            torch.ones(ZL), torch.ones(ZL))
    st = _tensor_state(row, {"w": torch.zeros(ZL)}, 1)
    st.sync()                       # committed in this world: kept
    st._commit_world = (2, 1)
    with pytest.raises(RuntimeError, match="cannot be resharded"):
        st.sync()
    assert not pcs._reshard_committed(st)


def test_pack_opt_state_refuses_other_states():
    with pytest.raises(TypeError, match="ShardedAdamWState"):
        pcs.pack_opt_state({"mu": torch.zeros(3)})
