"""horovod_tpu_torch's ``elastic.FsdpState`` == horovod_tpu's: the port of
``tests/test_elastic.py``'s ``TestFsdpState``.

A spawned world re-meshes in process: four gloo ranks take three
``fsdp_adamw(0.05)`` steps of an MLP block (flat length 82, so the padding
differs at 4 and 2 ranks) on a fixed batch of 8 rows split evenly over the
ranks, commit (collective: the rows are gathered), lose ranks 2 and 3,
restore at two ranks from memory, take three steps, commit, grow back to
four ranks, where the two joiners hold no commit and ``sync()`` gives
them rank 0's, and take three more steps. Checks:

* the canonical commit is ``(82,)`` with the step collapsed to 3, and a
  lost rank's row is rebuilt from the survivors' commit: each survivor's
  restored row equals, exactly, its row of the four ranks' rows gathered,
  stripped and padded for two; after the grow each rank's row equals its
  row of the two-rank commit padded for four;
* the parameters after 6 and 9 steps equal the reference's uninterrupted
  run at four devices (rtol 1e-4, atol 1e-5, the reference test's), and
  the plain attributes survive;
* a commit saved at four ranks and loaded into a fresh state at two gives
  the restored rows exactly.

In one process (the port's world of one): a file written by the
reference's ``FsdpState`` loads in the port (every canonical array and
attribute exactly), and a file written by the port loads in the
reference; ``load`` refuses another model with the reference's message;
``restore`` rolls back an uncommitted change; stacked per-layer rows
canonicalise to ``(layers, 82)`` and restore as the reference's rows for
four shards (this rank's); a full template with per-layer rows raises the
reference's message.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.elastic import FsdpState as JFsdpState
from horovod_tpu.parallel import fsdp as jfsdp

from horovod_tpu_torch.elastic import FsdpState
from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D_IN, D_H, L, N = 5, 7, 82, 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _template_np():
    g = np.random.default_rng(7)
    return {"w1": (g.standard_normal((D_IN, D_H)) * 0.4).astype(np.float32),
            "b1": np.zeros(D_H, np.float32),
            "w2": (g.standard_normal((D_H, D_IN)) * 0.4).astype(np.float32),
            "b2": np.zeros(D_IN, np.float32)}


def _X():
    return np.random.default_rng(8).standard_normal((8, D_IN)).astype(
        np.float32)


def _pad(a, n):
    c = -(-a.shape[-1] // n)
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, n * c - a.shape[-1])])


_WORKER = textwrap.dedent('''
    import json, os, socket, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.elastic import FsdpState
    from horovod_tpu_torch.parallel import fsdp

    d = dict(np.load(sys.argv[2] + ".in.npz"))
    T = lambda a: torch.from_numpy(np.asarray(a))
    template = {k: T(d["t:" + k]) for k in ("w1", "b1", "w2", "b2")}
    X = T(d["X"])
    out, info = {}, {}

    def block(p, x):
        return x + torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def steps(shard, st, k):
        tx = fsdp.fsdp_adamw(0.05)
        n, r = hvd.size(), hvd.rank()
        xs = X[r * (8 // n):(r + 1) * (8 // n)]
        for _ in range(k):
            s = shard.clone().requires_grad_()
            (fsdp.fsdp_apply(block, template, s, xs) ** 2).mean().backward()
            upd, st = tx.update(s.grad, st, shard)
            shard = shard + upd
        return shard, st

    def world(n, r, port):
        os.environ.update(WORLD_SIZE=str(n), RANK=str(r),
                          LOCAL_SIZE=str(n), LOCAL_RANK=str(r),
                          MASTER_PORT=str(port))
        hvd.init(device="cpu")

    hvd.init(device="cpu")
    r0 = hvd.rank()
    ports = C.broadcast_object(
        [socket.create_server(("127.0.0.1", 0)).getsockname()[1]
         for _ in range(2)] if r0 == 0 else None, 0)
    shard = fsdp.fsdp_shard_params(template)
    st = fsdp.fsdp_adamw(0.05).init(shard)
    shard, st = steps(shard, st, 3)
    out["a_rows"] = shard.numpy()
    state = FsdpState(template, shard=shard, opt_state=st, epoch=1)
    state.commit()
    out["a_canon"] = state._saved["shard"]
    info["a_step"] = state._saved["step"]
    path = sys.argv[2] + ".ckpt"
    if r0 == 0:
        state.save(path)
    hvd.barrier()
    hvd.shutdown()

    if r0 < 2:                       # the survivors, from memory
        world(2, r0, ports[0])
        state.restore()
        out["b_restored"] = state.shard.numpy()
        out["b_restored_mu"] = state.opt_state.mu.numpy()
        info["b_step"] = state.opt_state.step.tolist()
        fresh = FsdpState(template, epoch=0)
        fresh.load(path)
        out["b_loaded"] = fresh.shard.numpy()
        info["b_loaded_epoch"] = fresh.epoch
        shard, st = steps(state.shard, state.opt_state, 3)
        out["b_rows"] = shard.numpy()
        state.shard, state.opt_state = shard, st
        state.commit()
        out["b_canon"] = state._saved["shard"]
        hvd.shutdown()
    else:                            # joiners: no commit
        state = FsdpState(template, epoch=-1)
    world(4, r0, ports[1])
    state.sync()
    out["c_synced"] = state.shard.numpy()
    info["c_epoch"] = state.epoch
    shard, st = steps(state.shard, state.opt_state, 3)
    out["c_rows"] = shard.numpy()
    np.savez(sys.argv[2] + f".rank{r0}.npz", **out)
    with open(sys.argv[2] + f".rank{r0}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_state")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    np.savez(tmp / "out.in.npz", X=_X(), **{"t:" + k: v for k, v in
                                           _template_np().items()})
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(N),
         "--timeout", "240", str(script), REPO, str(tmp / "out")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return [(dict(np.load(tmp / f"out.rank{r}.npz")),
             json.load(open(tmp / f"out.rank{r}.json"))) for r in range(N)]


@pytest.fixture(scope="module")
def reference():
    """The reference's uninterrupted run at four devices: the unpadded
    parameters after 3, 6 and 9 steps."""
    template = {k: jnp.asarray(v) for k, v in _template_np().items()}

    def block(p, x):
        return x + jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    tx = jfsdp.fsdp_adamw(0.05)

    def body(shard, opt_state, xs):
        _, g = jax.value_and_grad(lambda s: jnp.mean(
            jfsdp.fsdp_apply(block, template, s, xs) ** 2))(shard)
        upd, opt_state = tx.update(g, opt_state, shard)
        return shard + upd, opt_state

    jhvd.init(devices=jax.devices()[:N])
    try:
        step = jhvd.spmd(body, in_specs=(P("hvd"), P("hvd"), P("hvd")),
                         out_specs=(P("hvd"), P("hvd")))
        shard = jfsdp.fsdp_shard_params(template)
        st = tx.init(shard)
        out = []
        for _ in range(3):
            for _ in range(3):
                shard, st = step(shard, st, jnp.asarray(_X()))
            out.append(np.asarray(shard)[:L])
        return out
    finally:
        jhvd.init()


def test_commit_is_canonical_and_lost_rows_are_rebuilt(world):
    rows = np.concatenate([res["a_rows"] for res, _ in world])
    canon = rows[:L]
    for r, (res, info) in enumerate(world):
        np.testing.assert_array_equal(res["a_canon"], canon)
        assert info["a_step"] == 3
        if r < 2:
            c2 = -(-L // 2)
            np.testing.assert_array_equal(res["b_restored"],
                                          _pad(canon, 2)[r * c2:(r + 1) * c2])
            assert info["b_step"] == [3]
    b = np.concatenate([world[r][0]["b_rows"] for r in range(2)])[:L]
    c4 = -(-L // 4)
    for r, (res, info) in enumerate(world):
        np.testing.assert_array_equal(res["c_synced"],
                                      _pad(b, 4)[r * c4:(r + 1) * c4])
        assert info["c_epoch"] == 1


def test_remesh_4_to_2_to_4_equals_the_uninterrupted_reference(world,
                                                               reference):
    np.testing.assert_allclose(
        np.concatenate([res["a_rows"] for res, _ in world])[:L],
        reference[0], **TOL)
    np.testing.assert_allclose(
        np.concatenate([world[r][0]["b_rows"] for r in range(2)])[:L],
        reference[1], **TOL)
    np.testing.assert_allclose(
        np.concatenate([res["c_rows"] for res, _ in world])[:L],
        reference[2], **TOL)


def test_load_across_world_sizes(world):
    for r in range(2):
        res, info = world[r]
        np.testing.assert_array_equal(res["b_loaded"], res["b_restored"])
        assert info["b_loaded_epoch"] == 1


def _port_template():
    return {k: torch.from_numpy(v) for k, v in _template_np().items()}


def _reference_state(n=8):
    template = {k: jnp.asarray(v) for k, v in _template_np().items()}
    g = np.random.default_rng(9)
    c = -(-L // n)
    st = JFsdpState(
        template,
        shard=jnp.asarray(g.standard_normal(n * c).astype(np.float32)),
        opt_state=jfsdp.ShardedAdamWState(
            step=jnp.full((n,), 4, jnp.int32),
            mu=jnp.asarray(g.standard_normal(n * c).astype(np.float32)),
            nu=jnp.asarray(g.random(n * c).astype(np.float32))),
        epoch=3)
    st.commit()
    return st


def test_reference_file_loads_in_the_port(tmp_path):
    ref = _reference_state()
    path = str(tmp_path / "ref.ckpt")
    ref.save(path)
    port = FsdpState(_port_template(), epoch=0)
    port.load(path)
    for k in ("shard", "mu", "nu"):
        np.testing.assert_array_equal(port._saved[k], ref._saved[k])
    np.testing.assert_array_equal(port.shard.numpy(), ref._saved["shard"])
    assert port.opt_state.step.tolist() == [4]
    np.testing.assert_array_equal(port.opt_state.nu.numpy(),
                                  ref._saved["nu"])
    assert port.epoch == 3 and port.commit_count == ref.commit_count
    port.load(path, num_shards=4)
    c4 = -(-L // 4)
    np.testing.assert_array_equal(port.shard.numpy(),
                                  _pad(ref._saved["shard"], 4)[:c4])


def test_port_file_loads_in_the_reference(tmp_path):
    g = np.random.default_rng(10)
    rows = torch.from_numpy(g.standard_normal(L).astype(np.float32))
    st = ShardedAdamWState(torch.full((1,), 2, dtype=torch.int32),
                           torch.from_numpy(g.standard_normal(L)
                                            .astype(np.float32)),
                           torch.from_numpy(g.random(L).astype(np.float32)))
    port = FsdpState(_port_template(), shard=rows, opt_state=st, epoch=5)
    path = str(tmp_path / "port.ckpt")
    port.save(path)
    ref = JFsdpState({k: jnp.asarray(v) for k, v in _template_np().items()},
                     epoch=0)
    ref.load(path, num_shards=8)
    np.testing.assert_array_equal(np.asarray(ref.shard),
                                  _pad(rows.numpy(), 8))
    np.testing.assert_array_equal(np.asarray(ref.opt_state.mu),
                                  _pad(st.mu.numpy(), 8))
    assert np.asarray(ref.opt_state.step).tolist() == [2] * 8
    assert ref.epoch == 5


def test_load_refuses_another_model_as_reference(tmp_path):
    port = FsdpState(_port_template(), shard=torch.zeros(L))
    path = str(tmp_path / "p.ckpt")
    port.save(path)
    with pytest.raises(ValueError) as got:
        FsdpState({"w": torch.zeros(3, 3)}).load(path)
    with pytest.raises(ValueError) as want:
        JFsdpState({"w": jnp.zeros((3, 3))}).load(path)
    assert str(got.value) == str(want.value)
    assert "different model" in str(got.value)


def test_restore_rolls_back_uncommitted():
    state = FsdpState(_port_template(), shard=torch.ones(L), epoch=0)
    state.shard = torch.zeros(L)
    state.epoch = 5
    state.restore()
    np.testing.assert_array_equal(state.shard.numpy(), np.ones(L))
    assert state.epoch == 0


def test_stacked_rows_canonicalise_as_reference():
    rows = torch.arange(3 * L, dtype=torch.float32).reshape(3, L)
    state = FsdpState(_port_template(), shard=rows)
    assert state._saved["shard"].shape == (3, L)
    state.restore(num_shards=4)
    c4 = -(-L // 4)
    ref = JFsdpState({k: jnp.asarray(v) for k, v in _template_np().items()},
                     shard=jnp.asarray(rows.numpy()))
    ref.restore(num_shards=4)
    assert state.shard.shape == (3, c4)
    np.testing.assert_array_equal(state.shard.numpy(),
                                  np.asarray(ref.shard)[:, :c4])


def test_strip_rejects_mismatched_template_as_reference():
    state = FsdpState(_port_template())
    state.shard = torch.zeros(3, 24)
    with pytest.raises(ValueError) as got:
        state.commit()
    ref = JFsdpState({k: jnp.asarray(v) for k, v in _template_np().items()})
    ref.shard = jnp.zeros((3, 24))
    with pytest.raises(ValueError) as want:
        ref.commit()
    assert str(got.value) == str(want.value)
    assert "ONE layer" in str(got.value)
