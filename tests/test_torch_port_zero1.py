"""horovod_tpu_torch's ZeRO-1 (``optimizer_sharded.sharded_adamw``) ==
horovod_tpu's.

A tree of parameters with fp32 and bf16 leaves, built in an order that is
not the sorted one (51 elements, so no world size here divides them),
takes three ``sharded_adamw(0.05, weight_decay=0.1)`` steps on spawned
gloo worlds of 1, 2 and 4 ranks (started together), each rank with its own
seeded gradients; the reference takes the same steps under ``hvd.spmd``
over 1, 2 and 4 devices of its CPU mesh, each device with that rank's
gradients. After every step rank r's ``(step, mu, nu)`` row must equal row
r of the reference's global state and every rank's updates the
reference's: fp32 within rtol 1e-5, atol 1e-6 (the gradient sums are
taken in another order), bf16 update leaves within one bf16 rounding
(rtol 2^-7), the step counter exactly. The update takes no negotiation
round (its reduce-scatter and all-gather are in-step collectives), and
``init`` gives each rank ceil(L/n) elements.

The leaf-order trap: the same world runs one step with the leaves
flattened in registration (insertion) order, and its rows must fail the
row check. ``reshard_opt_state`` of the four ranks' last rows (gathered
first) must equal, exactly, the reference's in-memory reshard to 1, 2 and
3 shards of the global state those rows make.
An elastic ``TensorState`` that commits a row keeps it through ``sync()``
(only the other trees come from rank 0). Without params, ``update`` raises
the reference's ``ValueError``.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import checkpoint_sharded as jcs
from horovod_tpu.optimizer_sharded import ShardedAdamWState as jshard_state
from horovod_tpu.optimizer_sharded import sharded_adamw as jsharded_adamw

from horovod_tpu_torch.optimizer_sharded import (ShardedAdamWState,
                                                 sharded_adamw)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD, STEPS = 0.05, 0.1, 3
F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=1e-6)
WORLDS = (1, 2, 4)
# (key path, shape, dtype) in insertion order: not the sorted order.
LEAVES = [("w_out", (5, 3), "f32"), ("bias", (7,), "bf16"),
          ("emb/tok", (6, 4), "f32"), ("emb/pos", (3,), "bf16"),
          ("a_scale", (2,), "f32")]
L = sum(int(np.prod(s)) for _, s, _ in LEAVES)
RESHARD = (1, 2, 3)


def _np(x, dt):
    x = np.asarray(x, np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32) \
        if dt == "bf16" else x


def _inputs():
    g = np.random.default_rng(12)
    d = {}
    for key, shape, dt in LEAVES:
        d["p:" + key] = _np(g.standard_normal(shape), dt)
        for r in range(4):
            for s in range(STEPS):
                d[f"g{r}_{s}:{key}"] = _np(g.standard_normal(shape), dt)
    return d


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint_sharded as pcs
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import optimizer_sharded as S

    LEAVES = json.loads(sys.argv[4])
    RESHARD = json.loads(sys.argv[5])
    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    d = np.load(sys.argv[2])
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}

    def tree(prefix):
        out = {}
        for key, _, t in LEAVES:
            *path, leaf = key.split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = torch.tensor(d[prefix + key]).to(dt[t])
        return out

    def leaves(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v

    def count(name):
        return sum(s["value"] for s in
                   hvd.metrics()["counters"].get(name, []))

    out, info = {}, {"rounds": [], "traced": []}
    opt = S.sharded_adamw(0.05, weight_decay=0.1)
    params = tree("p:")
    state = opt.init(params)
    info["c"] = int(state.mu.shape[0])
    for s in range(3):
        r0 = sum(C.negotiation_stats().values())
        t0 = count("collective_traced_total")
        upd, state = opt.update(tree(f"g{r}_{s}:"), state, params)
        info["rounds"].append(sum(C.negotiation_stats().values()) - r0)
        info["traced"].append(count("collective_traced_total") - t0)
        flat_u = dict(leaves(upd))

        def apply(p, u):
            if isinstance(p, dict):
                return {k: apply(p[k], u[k]) for k in p}
            return p + u
        params = apply(params, upd)
        for k, v in flat_u.items():
            out[f"u{s}:{k}"] = v.float().numpy()
        for f in ("step", "mu", "nu"):
            out[f"{f}{s}"] = getattr(state, f).numpy()
    for m in RESHARD:
        g = pcs.reshard_opt_state(state, m, unpadded_len=sum(
            int(np.prod(sh)) for _, sh, _ in LEAVES))
        for f in ("step", "mu", "nu"):
            out[f"reshard{m}:{f}"] = getattr(g, f).numpy()

    # An elastic TensorState's sync keeps each rank's own row and
    # broadcasts the rest from rank 0.
    from horovod_tpu_torch.elastic import TensorState
    ts = TensorState(opt_state=state, w=torch.full((2,), float(r)), epoch=r)
    ts.sync()
    out["sync_mu"], out["sync_w"] = ts.opt_state.mu.numpy(), ts.w.numpy()
    info["sync_epoch"] = ts.epoch

    # The planted fault: leaves flattened in registration order.
    def registration_order(t, prefix=""):
        if isinstance(t, dict):
            return [kv for k, v in t.items()
                    for kv in registration_order(v, prefix + f"[{k!r}]")]
        return [(prefix, t)]

    S._flatten_with_keys = registration_order
    planted = opt.init(tree("p:"))
    _, planted = opt.update(tree(f"g{r}_0:"), planted, tree("p:"))
    out["planted_mu0"], out["planted_nu0"] = (planted.mu.numpy(),
                                              planted.nu.numpy())
    np.savez(sys.argv[3] + f".rank{r}.npz", **out)
    with open(sys.argv[3] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "--timeout", "240", str(script), REPO, str(data),
         str(tmp / f"out{n}"), json.dumps(LEAVES), json.dumps(RESHARD)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in WORLDS}
    out = {}
    for n, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        out[n] = [(dict(np.load(tmp / f"out{n}.rank{r}.npz")),
                   json.load(open(tmp / f"out{n}.rank{r}.json")))
                  for r in range(n)]
    return out


@pytest.fixture(scope="module")
def reference():
    """{n: [per step: (step (n,), mu (n*c,), nu (n*c,), {key: update})]}
    of the reference over n devices."""
    d = _inputs()
    out = {}
    for n in WORLDS:
        jhvd.init(devices=jax.devices()[:n])
        try:
            opt = jsharded_adamw(LR, weight_decay=WD)
            params = _nest({k: jnp.asarray(d["p:" + k], jnp.bfloat16
                                           if t == "bf16" else jnp.float32)
                            for k, _, t in LEAVES})
            state = opt.init(params)

            def body(g, st, p):
                g = jax.tree_util.tree_map(lambda x: x[0], g)
                u, st = opt.update(g, st, p)
                return jax.tree_util.tree_map(lambda x: x[None], u), st

            step = jhvd.spmd(body, in_specs=(P("hvd"), P("hvd"), P()),
                             out_specs=(P("hvd"), P("hvd")))
            steps = []
            for s in range(STEPS):
                grads = _nest({k: jnp.asarray(
                    np.stack([d[f"g{r}_{s}:{k}"] for r in range(n)]),
                    jnp.bfloat16 if t == "bf16" else jnp.float32)
                    for k, _, t in LEAVES})
                u, state = step(grads, state, params)
                u = jax.tree_util.tree_map(lambda x: x[0], u)
                params = optax.apply_updates(params, u)
                flat = {k: np.asarray(_get(u, k), np.float32)
                        for k, _, _ in LEAVES}
                steps.append((np.asarray(state.step), np.asarray(state.mu),
                              np.asarray(state.nu), flat))
            out[n] = steps
        finally:
            jhvd.init()
    return out


def _get(tree, key):
    for p in key.split("/"):
        tree = tree[p]
    return tree


@pytest.mark.parametrize("n", WORLDS)
def test_rows_and_updates_equal_the_reference(worlds, reference, n):
    steps = reference[n]
    c = -(-L // n)
    for r, (res, info) in enumerate(worlds[n]):
        assert info["c"] == c
        for s, (jstep, jmu, jnu, jupd) in enumerate(steps):
            np.testing.assert_array_equal(res[f"step{s}"], jstep[r:r + 1])
            np.testing.assert_allclose(res[f"mu{s}"],
                                       jmu[r * c:(r + 1) * c], **F32)
            np.testing.assert_allclose(res[f"nu{s}"],
                                       jnu[r * c:(r + 1) * c], **F32)
            for key, _, t in LEAVES:
                np.testing.assert_allclose(
                    res[f"u{s}:{key}"], jupd[key],
                    err_msg=f"rank {r} step {s} {key}",
                    **(BF16 if t == "bf16" else F32))


@pytest.mark.parametrize("n", WORLDS)
def test_update_takes_no_negotiation_round(worlds, n):
    for _, info in worlds[n]:
        assert info["rounds"] == [0] * STEPS
        assert info["traced"] == [0 if n == 1 else 2] * STEPS


@pytest.mark.parametrize("n", WORLDS)
def test_registration_order_flatten_fails_the_row_check(worlds, reference,
                                                        n):
    _, jmu, jnu, _ = reference[n][0]
    c = -(-L // n)
    for r, (res, _) in enumerate(worlds[n]):
        # The shipped flatten passes, the planted one does not.
        np.testing.assert_allclose(res["mu0"], jmu[r * c:(r + 1) * c], **F32)
        assert not np.allclose(res["planted_mu0"], jmu[r * c:(r + 1) * c],
                               **F32)
        assert not np.allclose(res["planted_nu0"], jnu[r * c:(r + 1) * c],
                               **F32)


@pytest.mark.parametrize("m", RESHARD)
def test_reshard_of_gathered_rows_equals_the_reference(worlds, m):
    last = STEPS - 1
    rows = [res for res, _ in worlds[4]]
    glob = jshard_state(
        step=jnp.asarray(np.concatenate([x[f"step{last}"] for x in rows])),
        mu=jnp.asarray(np.concatenate([x[f"mu{last}"] for x in rows])),
        nu=jnp.asarray(np.concatenate([x[f"nu{last}"] for x in rows])))
    want = jcs.reshard_opt_state(glob, m, unpadded_len=L)
    assert np.asarray(want.step).shape == (m,)
    for res, _ in worlds[4]:
        for f in ("step", "mu", "nu"):
            np.testing.assert_array_equal(res[f"reshard{m}:{f}"],
                                          np.asarray(getattr(want, f)))


def test_tensor_state_sync_keeps_each_ranks_row(worlds):
    for r, (res, info) in enumerate(worlds[4]):
        np.testing.assert_array_equal(res["sync_mu"], res[f"mu{STEPS - 1}"])
        np.testing.assert_array_equal(res["sync_w"], np.zeros(2))
        assert info["sync_epoch"] == 0
    assert not np.array_equal(worlds[4][0][0]["sync_mu"],
                              worlds[4][1][0]["sync_mu"])


def test_update_without_params_raises_as_the_reference():
    row = ShardedAdamWState(torch.zeros(1, dtype=torch.int32),
                            torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError) as got:
        sharded_adamw(1e-3).update({"w": torch.ones(3)}, row)
    with pytest.raises(ValueError) as want:
        jsharded_adamw(1e-3).update({"w": jnp.ones(3)}, None)
    assert str(got.value) == str(want.value)
