"""horovod_tpu_torch Adasum and the join mask == horovod_tpu's.

Two spawned gloo worlds of the port (``python -m horovod_tpu_torch.runner``)
run the port's Adasum over ``torch.distributed`` point-to-point ops:

* five ranks: sets of k = 2, 3, 4 and 5 ranks (k = 3 and 5 pre-pair an
  extra rank and post-broadcast to it), a subset set {1, 3}, a length that
  no power of two divides, a zero vector, bf16 buffers, fp16 compression
  with prescale and postscale, and ``grouped_allreduce`` under a small
  fusion threshold (several buckets, each with its own coefficients); and
  the join mask of ``allreduce_gradients`` on the set {0, 1};
* four ranks on two fake nodes of two (``LOCAL_SIZE=2``) with
  ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``: the global set (two groups), the
  set {0, 1} (one node: the mean) and the set {0, 2} (groups of one: plain
  Adasum).

In one process: Adasum of one rank is its input, and the join mask under
``backward_passes_per_step=2``.

The JAX package computes the same reductions under its ``tensor[r]`` =
rank r convention over process sets of the same ranks of the 8-device CPU
mesh: eagerly through ``allreduce(op=Adasum)``, by calling
``hierarchical_adasum_allreduce`` under the reference's ``shard_map`` with
the port's node groups (the reference groups by JAX process, and this test
world has one), and by ``allreduce_gradients(alive=)`` inside
``hvd.spmd``. Tolerances are the reference's own Adasum tests' (rtol 1e-4,
atol 1e-5 in fp32), and for bf16 results two bf16 ulps (rtol 2^-7).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu import optimizer as joptimizer
from horovod_tpu.adasum import hierarchical_adasum_allreduce
from horovod_tpu.compression import Compression as JCompression

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8                     # devices of the reference's mesh
ADASUM = 5
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-2)
THRESHOLD = 512           # bytes: several fusion buckets
SUBSETS = {"k2": [0, 1], "k3": [0, 1, 2], "k4": [0, 1, 2, 3],
           "k5": [0, 1, 2, 3, 4], "s13": [1, 3]}
HIER_SETS = {"global": [0, 1, 2, 3], "node": [0, 1], "leaders": [0, 2]}
ALIVE = {"alive10": (1, 0), "alive00": (0, 0)}


def _inputs():
    g = np.random.default_rng(11)
    zero = g.standard_normal((5, 37)).astype(np.float32)
    zero[1] = 0.0
    return {
        "x": g.standard_normal((5, 37)).astype(np.float32),
        "zero": zero,
        "g0": g.standard_normal((5, 2, 5)).astype(np.float32),
        "g1": g.standard_normal((5, 300)).astype(np.float32),
        "g2": g.standard_normal((5, 3, 3)).astype(np.float32),
        "grad0": g.standard_normal((5, 4, 3)).astype(np.float32),
        "grad1": g.standard_normal((5, 7)).astype(np.float32),
    }


_WORKER = textwrap.dedent("""
    import os, sys
    if sys.argv[4] == "hier":
        os.environ["LOCAL_SIZE"] = "2"
        os.environ["LOCAL_RANK"] = str(int(os.environ["RANK"]) % 2)
        os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    data = {k: torch.tensor(v[r]) for k, v in np.load(sys.argv[2]).items()}
    out = {}
    A = hvd.Adasum
    if sys.argv[4] == "hier":
        sets = {"global": None, "node": hvd.add_process_set([0, 1]),
                "leaders": hvd.add_process_set([0, 2])}
        for name, ps in sets.items():
            out[name] = hvd.allreduce(data["x"], op=A, process_set=ps)
    else:
        sets = {f"k{k}": hvd.add_process_set(list(range(k)))
                for k in (2, 3, 4)}
        sets["k5"] = None
        sets["s13"] = hvd.add_process_set([1, 3])
        for name, ps in sets.items():
            out[name] = hvd.allreduce(data["x"], op=A, process_set=ps)
        x = data["x"]
        out["zero"] = hvd.allreduce(data["zero"], op=A)
        out["all_zero"] = hvd.allreduce(torch.zeros(37), op=A)
        out["bf16"] = hvd.allreduce(x.to(torch.bfloat16), op=A)
        out["fp16_scaled"] = hvd.allreduce(
            x, op=A, compression=hvd.Compression.fp16, prescale_factor=0.5,
            postscale_factor=3.0)
        h = hvd.allreduce_async(x, op=A, process_set=sets["k3"])
        out["async_k3"] = hvd.synchronize(h)
        y = x.clone()
        hvd.allreduce_(y, op=A, process_set=sets["k4"])
        out["inplace_k4"] = y
        for i, t in enumerate(hvd.grouped_allreduce(
                [data["g0"], data["g1"], data["g2"]], op=A,
                fusion_threshold_bytes=512)):
            out[f"grouped_{i}"] = t
        pair = hvd.add_process_set([0, 1])
        alive = {"alive10": (1, 0), "alive00": (0, 0)}
        # Every rank takes part in every eager op's negotiation round, the
        # ranks outside the set too (they get their own tensors back).
        for name, a in alive.items():
            for op_name, op in (("avg", hvd.Average), ("sum", hvd.Sum)):
                grads = [data["grad0"].clone(), data["grad1"].clone()]
                res = hvd.allreduce_gradients(grads, op=op,
                                              process_set=pair,
                                              alive=a[r] if r < 2 else 1)
                out[f"{name}_{op_name}_0"], out[f"{name}_{op_name}_1"] \\
                    = res
        try:
            hvd.allreduce_gradients([x.clone()], op=hvd.Max, alive=1)
            out["flag:alive_max_raises"] = torch.tensor(False)
        except ValueError:
            out["flag:alive_max_raises"] = torch.tensor(True)
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.float().numpy() for k, v in out.items()})
    hvd.shutdown()
""")


def _world(tmp_path_factory, nranks, mode):
    tmp = tmp_path_factory.mktemp(f"adasum_{mode}")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(nranks), "--timeout", "240", str(script), REPO, str(data),
         str(out), mode], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(nranks)]


@pytest.fixture(scope="module")
def five(tmp_path_factory):
    return _world(tmp_path_factory, 5, "flat")


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return _world(tmp_path_factory, 4, "hier")


def _stack8(rows):
    """The reference's eager input: row r is rank r's value; rows of
    devices the port's world lacks repeat the last rank's."""
    rows = np.asarray(rows)
    pad = np.repeat(rows[-1:], N - rows.shape[0], axis=0)
    return jnp.asarray(np.concatenate([rows, pad]))


def _reference(x, ranks, dtype=None, **kw):
    ps = jhvd.add_process_set(ranks)
    try:
        arr = _stack8(x) if dtype is None else _stack8(x).astype(dtype)
        return np.asarray(jhvd.allreduce(arr, op=ADASUM, process_set=ps,
                                         **kw).astype(jnp.float32))
    finally:
        jhvd.remove_process_set(ps)


@pytest.mark.parametrize("name", sorted(SUBSETS))
def test_adasum_sets_match_jax(five, name):
    x = _inputs()["x"]
    ranks = SUBSETS[name]
    want = _reference(x, ranks)
    for r in range(5):
        # A rank outside the set gets its own tensor back.
        np.testing.assert_allclose(five[r][name],
                                   want[r] if r in ranks else x[r],
                                   err_msg=f"rank {r}", **TOL)


def test_adasum_of_one_rank_is_its_input():
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        x = torch.randn(5, 3)
        assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("name", ["zero", "all_zero"])
def test_adasum_zero_vectors_match_jax(five, name):
    x = _inputs()["zero"] if name == "zero" else np.zeros((5, 37),
                                                           np.float32)
    want = _reference(x, list(range(5)))
    for r in range(5):
        np.testing.assert_allclose(five[r][name], want[r], **TOL)
    if name == "all_zero":
        assert not np.any(five[0][name])


def test_adasum_bf16_matches_jax(five):
    want = _reference(_inputs()["x"], list(range(5)), jnp.bfloat16)
    for r in range(5):
        np.testing.assert_allclose(five[r]["bf16"], want[r], **BF16_TOL)


def test_adasum_fp16_compression_and_scaling_match_jax(five):
    want = _reference(_inputs()["x"], list(range(5)),
                      compression=JCompression.fp16, prescale_factor=0.5,
                      postscale_factor=3.0)
    for r in range(5):
        # fp16 on the wire: the result is an fp16 rounding of Adasum.
        np.testing.assert_allclose(five[r]["fp16_scaled"], want[r],
                                   rtol=2 ** -10, atol=1e-3)


@pytest.mark.parametrize("name,set_name", [("async_k3", "k3"),
                                           ("inplace_k4", "k4")])
def test_adasum_async_and_inplace_forms(five, name, set_name):
    for r in range(5):
        np.testing.assert_array_equal(five[r][name], five[r][set_name])


def test_grouped_adasum_per_bucket_matches_jax(five):
    d = _inputs()
    ps = jhvd.add_process_set(list(range(5)))
    try:
        want = jhvd.grouped_allreduce(
            [_stack8(d[k]) for k in ("g0", "g1", "g2")], op=ADASUM,
            process_set=ps, fusion_threshold_bytes=THRESHOLD)
    finally:
        jhvd.remove_process_set(ps)
    for i, w in enumerate(want):
        for r in range(5):
            np.testing.assert_allclose(five[r][f"grouped_{i}"],
                                       np.asarray(w)[r], **TOL)
    # Per-bucket coefficients differ from one Adasum over everything.
    whole = _reference(np.concatenate(
        [d[k].reshape(5, -1) for k in ("g0", "g1", "g2")], axis=1),
        list(range(5)))
    assert not np.allclose(five[0]["grouped_1"].ravel(),
                           whole[0][10:310], **TOL)


@pytest.mark.parametrize("name", sorted(HIER_SETS))
def test_hierarchical_adasum_matches_jax(hier, name):
    x = _inputs()["x"][:4]
    ranks = HIER_SETS[name]
    groups = [[r for r in ranks if r // 2 == node]
              for node in sorted({r // 2 for r in ranks})]

    def body(xs):
        return hierarchical_adasum_allreduce(xs[0], "hvd", N, groups)[None]

    want = np.asarray(jhvd.spmd(body, in_specs=P("hvd"),
                                out_specs=P("hvd"))(_stack8(x)))
    for r in range(4):
        np.testing.assert_allclose(hier[r][name],
                                   want[r] if r in ranks else x[r],
                                   err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("name", sorted(ALIVE))
@pytest.mark.parametrize("op_name", ["avg", "sum"])
def test_join_mask_matches_jax(five, name, op_name):
    d = _inputs()
    alive = np.array(ALIVE[name] + (1,) * (N - 2), np.float32)
    op = jhvd.Average if op_name == "avg" else jhvd.Sum
    ps = jhvd.add_process_set([0, 1])
    try:
        def body(g0, g1, a):
            out = joptimizer.allreduce_gradients(
                [g0[0], g1[0]], op=op, process_set=ps, alive=a[0])
            return [o[None] for o in out]

        want = jhvd.spmd(body, in_specs=(P("hvd"), P("hvd"), P("hvd")),
                         out_specs=P("hvd"))(
            _stack8(d["grad0"]), _stack8(d["grad1"]), jnp.asarray(alive))
    finally:
        jhvd.remove_process_set(ps)
    for r in range(2):
        for i in range(2):
            np.testing.assert_allclose(five[r][f"{name}_{op_name}_{i}"],
                                       np.asarray(want[i])[r], **TOL)


def test_join_mask_takes_sum_and_average_only(five):
    assert five[0]["flag:alive_max_raises"] == 1.0


def test_join_mask_applies_to_the_kth_backward_pass():
    """With ``backward_passes_per_step=2`` the mask of the second call,
    where the allreduce runs, applies to the sum of both passes; the first
    call's is not used."""
    import torch

    import horovod_tpu_torch as hvd
    g = np.random.default_rng(3).standard_normal((4, 4)).astype(np.float32)
    hvd.init(device="cpu")
    try:
        w = torch.zeros(4, requires_grad=True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                       backward_passes_per_step=2)
        for p, alive in enumerate((0, 1, 1, 0)):
            opt.zero_grad()
            (w * torch.tensor(g[p])).sum().backward()
            opt.step(alive=alive)
            if p == 1:
                np.testing.assert_allclose(w.detach().numpy(),
                                           -(g[0] + g[1]), rtol=1e-6)
        # Passes 2 and 3 ended in a masked step: nothing applied.
        np.testing.assert_allclose(w.detach().numpy(), -(g[0] + g[1]),
                                   rtol=1e-6)
    finally:
        hvd.shutdown()
