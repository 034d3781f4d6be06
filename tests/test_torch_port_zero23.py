"""horovod_tpu_torch's ZeRO-2 / ZeRO-3 surface (``parallel/mp.py``) ==
horovod_tpu's, on a spawned four-rank gloo world against the reference on
devices 0-3 of its CPU mesh (under ``hvd.spmd``).

* ``gather_shard`` of rows of c = 300 elements (one whole 256-value block
  and a ragged tail of 44 a row): fp32 equals the rows concatenated,
  exactly; bf16 and int8 equal the reference's, exactly; fp8 within an
  fp32 ulp (the reference's compiled program rounds its fp8 scales by a
  reciprocal product); int8 and fp8 equal, bit for bit, each row
  quantized and dequantized by the reference's own functions. The planted tiled form (the gathered codes
  dequantized as one vector with one scale per 256 of its values, so the
  rows' ragged tails put later scales on the wrong values) must differ.
  An unknown wire raises the reference's ``ValueError``.
* ``zero2_grad_shard``: rank r's chunk equals the reference's r-th chunk
  of the mean (rtol 1e-6, atol 1e-7: the same fp32 sums).
* ``zero2_update``: three steps, each rank with its own gradients, weight
  decay 0.1: the new parameters and rank r's (step, mu, nu) row equal the
  reference's (fp32: rtol 1e-5, atol 1e-6; step exactly), on the default
  wire and on the int8 wire.
* ``zero3_apply`` on the bf16 and int8 wires: the block's output (rtol
  1e-5, atol 1e-5) and the row's gradient (rtol 1e-4, atol 1e-5) equal
  the reference's.
* The ``zero3_*`` names are the fsdp functions.
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
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.optimizer_sharded import ShardedAdamWState as JState
from horovod_tpu.parallel import mp as jmp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, C, D, STEPS = 4, 300, 16, 3
WIRES = ("fp32", "bf16", "int8", "fp8")
F32 = dict(rtol=1e-5, atol=1e-6)


def _inputs():
    g = np.random.default_rng(33)
    d = {"x": g.standard_normal(N * C).astype(np.float32)
         * np.repeat(np.float32([1.0, 3.0, 0.01, 7.0]), C)}
    d["p:w"] = g.standard_normal((8, 9)).astype(np.float32)
    d["p:b"] = g.standard_normal(9).astype(np.float32)
    for s in range(STEPS):
        for r in range(N):
            d[f"g{s}_{r}:w"] = g.standard_normal((8, 9)).astype(np.float32)
            d[f"g{s}_{r}:b"] = g.standard_normal(9).astype(np.float32)
    d["m:w1"] = (g.standard_normal((D, 2 * D)) * 0.3).astype(np.float32)
    d["m:b1"] = (g.standard_normal(2 * D) * 0.1).astype(np.float32)
    d["m:w2"] = (g.standard_normal((2 * D, D)) * 0.3).astype(np.float32)
    d["m:b2"] = (g.standard_normal(D) * 0.1).astype(np.float32)
    d["mx"] = g.standard_normal((N, 4, D)).astype(np.float32)
    return d


def _block(p, x):
    return x + jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.ops.quantized import (dequantize_blocks,
                                                 quantize_blocks)
    from horovod_tpu_torch.optimizer_sharded import ShardedAdamWState
    from horovod_tpu_torch.parallel import fsdp, mp

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    d = dict(np.load(sys.argv[2] + ".in.npz"))
    T = lambda a: torch.from_numpy(np.asarray(a))
    out, info = {}, {}
    c = 300
    row = T(d["x"][r * c:(r + 1) * c])
    for wire in ("fp32", "bf16", "int8", "fp8"):
        out["gather_" + wire] = mp.gather_shard(row, wire=wire).numpy()
    # the planted tiled gather: codes and scales as two flat vectors
    q, s = quantize_blocks(row, "int8")
    gq = C._in_step_allgather(q.view(torch.uint8), C._resolve_ps(None))
    gs = C._in_step_allgather(s, C._resolve_ps(None))
    # One scale per 256 values of the concatenated payload: the rows'
    # ragged tails put every later scale on the wrong values.
    out["gather_tiled_int8"] = dequantize_blocks(
        gq.view(torch.int8), gs[:-(-gq.numel() // 256)]).numpy()
    try:
        mp.gather_shard(row, wire="int4")
    except ValueError as e:
        info["bad_wire"] = str(e)

    def tree(prefix):
        return {k: T(d[prefix + k]) for k in ("w", "b")}

    out["g_shard"] = mp.zero2_grad_shard(tree(f"g0_{r}:")).numpy()
    for wire in ("fp32", "int8"):
        params = tree("p:")
        cc = -(-sum(v.numel() for v in params.values()) // n)
        st = ShardedAdamWState(torch.zeros(1, dtype=torch.int32),
                               torch.zeros(cc), torch.zeros(cc))
        for s_ in range(3):
            gsh = mp.zero2_grad_shard(tree(f"g{s_}_{r}:"))
            params, st = mp.zero2_update(
                params, gsh, st, learning_rate=1e-2, weight_decay=0.1,
                wire=wire)
            for k, v in params.items():
                out[f"z2_{wire}_{s_}:{k}"] = v.numpy()
            for f in ("step", "mu", "nu"):
                out[f"z2_{wire}_{s_}:{f}"] = getattr(st, f).numpy()

    mlp = {k: T(d["m:" + k]) for k in ("w1", "b1", "w2", "b2")}
    def block(p, x):
        return x + torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    for wire in ("bf16", "int8"):
        sh = mp.zero3_shard_params(mlp).requires_grad_()
        y = mp.zero3_apply(block, mlp, sh, T(d["mx"][r]), wire=wire)
        (y ** 2).mean().backward()
        out["z3_" + wire], out["z3_" + wire + "_grad"] = (
            y.detach().numpy(), sh.grad.numpy())
    np.savez(sys.argv[2] + f".rank{r}.npz", **out)
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero23")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    np.savez(tmp / "out.in.npz", **_inputs())
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
    d = _inputs()
    out = {}
    jhvd.init(devices=jax.devices()[:N])
    try:
        def spmd(f, i, o):
            return jhvd.spmd(f, in_specs=i, out_specs=o)
        x = jnp.asarray(d["x"])
        for wire in WIRES:
            out["gather_" + wire] = np.asarray(spmd(
                lambda s, w=wire: jmp.gather_shard(s, None, w)[None],
                P("hvd"), P("hvd"))(x))
        try:
            spmd(lambda s: jmp.gather_shard(s, None, "int4")[None],
                 P("hvd"), P("hvd"))(x)
        except ValueError as e:
            out["bad_wire"] = str(e)

        params = {k: jnp.asarray(d["p:" + k]) for k in ("w", "b")}

        def grads(s):
            return {k: jnp.asarray(np.stack([d[f"g{s}_{r}:{k}"]
                                             for r in range(N)]))
                    for k in ("w", "b")}
        g0 = grads(0)
        out["g_shard"] = np.asarray(spmd(
            lambda g: jmp.zero2_grad_shard(
                jax.tree_util.tree_map(lambda a: a[0], g)),
            P("hvd"), P("hvd"))(g0))
        length = 8 * 9 + 9
        c = -(-length // N)
        for wire in ("fp32", "int8"):
            def body(p, g, st, wire=wire):
                g = jax.tree_util.tree_map(lambda a: a[0], g)
                new_p, st2 = jmp.zero2_update(
                    p, jmp.zero2_grad_shard(g), JState(*st),
                    learning_rate=1e-2, weight_decay=0.1, wire=wire)
                return jax.tree_util.tree_map(lambda a: a[None], new_p), \
                    tuple(st2)
            fn = spmd(body, (P(), P("hvd"), P("hvd")), (P("hvd"), P("hvd")))
            p_ = params
            st = (jnp.zeros((N,), jnp.int32), jnp.zeros((N * c,)),
                  jnp.zeros((N * c,)))
            for s in range(STEPS):
                new_p, st = fn(p_, grads(s), st)
                p_ = jax.tree_util.tree_map(lambda a: a[0], new_p)
                out[f"z2_{wire}_{s}"] = (
                    {k: np.asarray(v) for k, v in p_.items()},
                    [np.asarray(a) for a in st])
        mlp = {k: jnp.asarray(d["m:" + k]) for k in ("w1", "b1", "w2", "b2")}
        shards = jmp.zero3_shard_params(mlp)
        for wire in ("bf16", "int8"):
            def zbody(s, xs, wire=wire):
                def loss(s):
                    y = jmp.zero3_apply(_block, mlp, s, xs[0], wire=wire)
                    return jnp.mean(y ** 2), y
                (_, y), g = jax.value_and_grad(loss, has_aux=True)(s)
                return y[None], g
            y, g = spmd(zbody, (P("hvd"), P("hvd")), (P("hvd"), P("hvd")))(
                shards, jnp.asarray(d["mx"]))
            out["z3_" + wire] = (np.asarray(y), np.asarray(g))
    finally:
        jhvd.init()
    return out


@pytest.mark.parametrize("wire", WIRES)
def test_gather_shard_equals_reference(world, reference, wire):
    want = reference["gather_" + wire]
    for r, (res, _) in enumerate(world):
        if wire == "fp8":
            # The reference's compiled program computes absmax / 448 as a
            # product with the reciprocal: its fp8 scales are an fp32 ulp
            # off its own eager quantizer's, which the port follows (see
            # the bit-for-bit test below).
            np.testing.assert_allclose(res["gather_fp8"], want[r],
                                       rtol=2.4e-7, atol=0)
        else:
            np.testing.assert_array_equal(res["gather_" + wire], want[r])
    if wire == "fp32":
        np.testing.assert_array_equal(world[0][0]["gather_fp32"],
                                      _inputs()["x"])


@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_quantized_gather_is_the_reference_rows_bit_for_bit(world, wire):
    """Each rank's row quantized and dequantized by the reference's
    ``quantize_blocks`` / ``dequantize_blocks``, row by row, then
    concatenated: the port's gather, bit for bit."""
    from horovod_tpu.ops import quantized as jq
    x = _inputs()["x"].reshape(N, C)
    want = np.concatenate([np.asarray(jq.dequantize_blocks(
        *jq.quantize_blocks(jnp.asarray(row), wire=wire))) for row in x])
    for res, _ in world:
        np.testing.assert_array_equal(res["gather_" + wire], want)


def test_tiled_quantized_gather_misaligns_the_scale_tails(world, reference):
    want = reference["gather_int8"][0]
    got = world[0][0]["gather_tiled_int8"]
    assert got.shape == want.shape
    assert not np.array_equal(got, want)
    # The first row's whole block still lines up; the damage starts at its
    # ragged tail.
    np.testing.assert_array_equal(got[:256], want[:256])


def test_unknown_wire_raises_as_reference(world, reference):
    for _, info in world:
        assert info["bad_wire"] == reference["bad_wire"]


def test_zero2_grad_shard_rows_equal_reference(world, reference):
    g = reference["g_shard"]
    c = g.shape[0] // N
    for r, (res, _) in enumerate(world):
        np.testing.assert_allclose(res["g_shard"], g[r * c:(r + 1) * c],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_zero2_update_three_steps_equal_reference(world, reference, wire):
    for s in range(STEPS):
        params, (step, mu, nu) = reference[f"z2_{wire}_{s}"]
        c = mu.shape[0] // N
        for r, (res, _) in enumerate(world):
            for k, v in params.items():
                np.testing.assert_allclose(res[f"z2_{wire}_{s}:{k}"], v,
                                           err_msg=f"{k} step {s}", **F32)
            np.testing.assert_array_equal(res[f"z2_{wire}_{s}:step"],
                                          step[r:r + 1])
            np.testing.assert_allclose(res[f"z2_{wire}_{s}:mu"],
                                       mu[r * c:(r + 1) * c], **F32)
            np.testing.assert_allclose(res[f"z2_{wire}_{s}:nu"],
                                       nu[r * c:(r + 1) * c], **F32)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_zero3_apply_on_a_wire_equals_reference(world, reference, wire):
    y, g = reference["z3_" + wire]
    c = g.shape[0] // N
    for r, (res, _) in enumerate(world):
        np.testing.assert_allclose(res["z3_" + wire], y[r], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["z3_" + wire + "_grad"],
                                   g[r * c:(r + 1) * c], rtol=1e-4,
                                   atol=1e-5)


def test_zero3_names_are_the_fsdp_functions():
    from horovod_tpu_torch.parallel import fsdp, mp
    assert mp.zero3_shard_params is fsdp.fsdp_shard_params
    assert mp.zero3_scan_blocks is fsdp.fsdp_scan_blocks
    assert mp.zero3_stack_layer_shards is fsdp.stack_layer_shards
    assert mp.zero3_adamw is fsdp.fsdp_adamw
    assert mp.MP_AXIS == jmp.MP_AXIS == "mp"
    assert {n for n in jmp.__all__ if n.startswith(("zero", "gather"))} \
        <= set(mp.__all__)
