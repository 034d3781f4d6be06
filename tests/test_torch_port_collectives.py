"""horovod_tpu_torch collectives, fusion and optimizer semantics ==
horovod_tpu's.

Collectives run on a two-rank gloo world launched by the port's runner
(``python -m horovod_tpu_torch.runner -np 2``); each rank passes its own
tensor. The JAX package runs the same reductions eagerly under its
``tensor[r]`` = rank r convention (horovod_tpu/collective.py), over a
process set of ranks {0, 1} of the 8-device CPU mesh, so both reduce the
same two values. The fusion planner is compared bucket for bucket with
``horovod_tpu.fusion.fuse``.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu import fusion as jfusion
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JConfig

import horovod_tpu_torch as hvd
from horovod_tpu_torch import fusion as pfusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OPS = {"Sum": 1, "Average": 0, "Min": 2, "Max": 3, "Product": 4}
SCALED = [("Sum", 0.5, 3.0), ("Average", 2.0, 0.25)]


def _rank_inputs():
    g = np.random.default_rng(7)
    return {
        "x": g.standard_normal((2, 3, 4)).astype(np.float32),
        "xi": g.integers(-9, 10, (2, 5)).astype(np.int32),
        "g0": g.standard_normal((2, 6)).astype(np.float32),
        "g1": g.standard_normal((2, 130)).astype(np.float32),
        "g2": g.integers(0, 50, (2, 3, 3)).astype(np.int32),
        "bpps": g.standard_normal((2, 2, 4)).astype(np.float32),
    }


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    data = np.load(sys.argv[2])
    x = torch.tensor(data["x"][r])
    out = {}
    ops = {"Sum": hvd.Sum, "Average": hvd.Average, "Min": hvd.Min,
           "Max": hvd.Max, "Product": hvd.Product}
    for name, op in ops.items():
        out[f"allreduce_{name}"] = hvd.allreduce(x, op=op)
    for name, pre, post in [("Sum", 0.5, 3.0), ("Average", 2.0, 0.25)]:
        out[f"scaled_{name}"] = hvd.allreduce(
            x, op=ops[name], prescale_factor=pre, postscale_factor=post)
    out["int_average"] = hvd.allreduce(torch.tensor(data["xi"][r]))
    for c in ("fp16", "bf16"):
        out[f"compressed_{c}"] = hvd.allreduce(
            x, op=hvd.Sum, compression=getattr(hvd.Compression, c))
    grouped = hvd.grouped_allreduce(
        [torch.tensor(data[k][r]) for k in ("g0", "g1", "g2")],
        op=hvd.Sum, fusion_threshold_bytes=512)
    for i, t in enumerate(grouped):
        out[f"grouped_{i}"] = t
    y = x.clone()
    hvd.broadcast_(y, root_rank=1)
    out["broadcast"] = y
    out["allgather"] = hvd.allgather(x)
    obj = hvd.broadcast_object({"from": r, "list": [r, r]}, root_rank=1)
    out["object_ok"] = torch.tensor(obj == {"from": 1, "list": [1, 1]})
    errors = []
    try:
        hvd.allreduce(x, op=hvd.Min, prescale_factor=2.0)
    except ValueError as e:
        errors.append("prescale" in str(e))
    try:
        hvd.allreduce(x, compression=hvd.Compression.int8)
    except NotImplementedError as e:
        errors.append("quantized wire" in str(e))
    out["errors_ok"] = torch.tensor(errors == [True, True])

    # backward_passes_per_step=2 with SGD(lr=1): after the 2nd pass the
    # step applies the rank-average of the SUM of both passes' grads.
    w = torch.zeros(4, requires_grad=True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   backward_passes_per_step=2)
    for p in range(2):
        opt.zero_grad()
        (w * torch.tensor(data["bpps"][r, p])).sum().backward()
        opt.step()
        out[f"bpps_after_{p}"] = w.detach().clone()
        out[f"bpps_updated_{p}"] = torch.tensor(opt.has_updated)
    hvd.barrier()
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.float().numpy() for k, v in out.items()})
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_rank_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]


@pytest.fixture(scope="module")
def pair_set():
    ps = jhvd.add_process_set([0, 1])
    yield ps
    jhvd.remove_process_set(ps)


def _stack8(two):
    """JAX eager input: rows 0 and 1 are ranks 0 and 1, the other six rows
    belong to ranks outside the process set."""
    pad = np.ones((6,) + two.shape[1:], two.dtype)
    return jnp.asarray(np.concatenate([two, pad]))


def _jax_rows(res):
    return np.asarray(res)[:2]


@pytest.mark.parametrize("op", sorted(OPS))
def test_allreduce_ops_match_jax(port_results, pair_set, op):
    x = _rank_inputs()["x"]
    want = _jax_rows(jhvd.allreduce(_stack8(x), op=OPS[op],
                                    process_set=pair_set))
    for r in range(2):
        np.testing.assert_allclose(port_results[r][f"allreduce_{op}"],
                                   want[r], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op,pre,post", SCALED)
def test_allreduce_prescale_postscale_match_jax(port_results, pair_set, op,
                                                pre, post):
    x = _rank_inputs()["x"]
    want = _jax_rows(jhvd.allreduce(_stack8(x), op=OPS[op],
                                    process_set=pair_set,
                                    prescale_factor=pre,
                                    postscale_factor=post))
    for r in range(2):
        np.testing.assert_allclose(port_results[r][f"scaled_{op}"], want[r],
                                   rtol=1e-6, atol=1e-6)


def test_integer_average_floors_like_jax(port_results, pair_set):
    xi = _rank_inputs()["xi"]
    want = _jax_rows(jhvd.allreduce(_stack8(xi), process_set=pair_set))
    for r in range(2):
        np.testing.assert_array_equal(port_results[r]["int_average"],
                                      want[r])


@pytest.mark.parametrize("comp", ["fp16", "bf16"])
def test_compressed_allreduce_matches_jax(port_results, pair_set, comp):
    x = _rank_inputs()["x"]
    want = _jax_rows(jhvd.allreduce(_stack8(x), op=1, process_set=pair_set,
                                    compression=getattr(JCompression, comp)))
    for r in range(2):
        got = port_results[r][f"compressed_{comp}"]
        # Both sum two wire-dtype values and cast back: equal to the ulp.
        np.testing.assert_allclose(got, want[r], rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got, x.sum(0), rtol=1e-2, atol=1e-2)


def test_grouped_allreduce_matches_jax(port_results, pair_set):
    d = _rank_inputs()
    want = jhvd.grouped_allreduce([_stack8(d[k]) for k in ("g0", "g1", "g2")],
                                  op=1, process_set=pair_set)
    for r in range(2):
        for i, w in enumerate(want):
            np.testing.assert_allclose(port_results[r][f"grouped_{i}"],
                                       _jax_rows(w)[r], rtol=1e-6,
                                       atol=1e-6)


def test_broadcast_matches_jax(port_results, pair_set):
    x = _rank_inputs()["x"]
    want = _jax_rows(jhvd.broadcast(_stack8(x), 1, process_set=pair_set))
    for r in range(2):
        np.testing.assert_array_equal(port_results[r]["broadcast"], want[r])


def test_allgather_matches_jax(port_results, pair_set):
    x = _rank_inputs()["x"]
    want = _jax_rows(jhvd.allgather(_stack8(x), process_set=pair_set))
    for r in range(2):
        np.testing.assert_array_equal(port_results[r]["allgather"], want[r])


def test_broadcast_object_and_error_paths(port_results):
    for r in range(2):
        assert port_results[r]["object_ok"] == 1.0
        assert port_results[r]["errors_ok"] == 1.0


def test_backward_passes_per_step_on_two_ranks(port_results):
    g = _rank_inputs()["bpps"]          # (rank, pass, 4)
    for r in range(2):
        res = port_results[r]
        # Accumulation pass: nothing applied yet.
        np.testing.assert_array_equal(res["bpps_after_0"], np.zeros(4))
        assert res["bpps_updated_0"] == 0.0 and res["bpps_updated_1"] == 1.0
        # k-th pass: SGD(1.0) applies -(rank-average of g_pass0 + g_pass1).
        want = -(g[:, 0] + g[:, 1]).mean(axis=0)
        np.testing.assert_allclose(res["bpps_after_1"], want, rtol=1e-6)


def test_backward_passes_per_step_single_process_matches_jax():
    import optax
    rng = np.random.default_rng(42)
    g1, g2 = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    jopt = jhvd.DistributedOptimizer(optax.sgd(1.0),
                                     backward_passes_per_step=2)
    params = {"w": jnp.zeros(4)}
    st = jopt.init(params)
    u1, st = jopt.update({"w": jnp.asarray(g1)}, st, params)
    u2, st = jopt.update({"w": jnp.asarray(g2)}, st, params)
    hvd.init(device="cpu")
    try:
        w = torch.zeros(4, requires_grad=True)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                       backward_passes_per_step=2)
        for g, u in ((g1, u1), (g2, u2)):
            before = w.detach().clone()
            opt.zero_grad()
            (w * torch.tensor(g)).sum().backward()
            opt.step()
            np.testing.assert_allclose((w.detach() - before).numpy(),
                                       np.asarray(u["w"]), rtol=1e-6)
    finally:
        hvd.shutdown()
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 backward_passes_per_step=0)


# ------------------------------------------------------------------ fusion

def _gpt2_leaves():
    """Tiny GPT-2's parameter leaves in flax order, plus an int32 and a
    bf16 leaf so the plan splits by dtype."""
    params = JGPT2(JConfig.tiny(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(params)]
    leaves.insert(3, np.arange(37, dtype=np.int32))
    leaves.append(np.linspace(-1, 1, 300, dtype=np.float32))
    dtypes = [None] * len(leaves)
    dtypes[-1] = "bf16"
    return leaves, dtypes


def _to_jax(leaf, dt):
    return jnp.asarray(leaf, jnp.bfloat16 if dt == "bf16" else None)


def _to_torch(leaf, dt):
    t = torch.tensor(leaf)
    return t.to(torch.bfloat16) if dt == "bf16" else t


@pytest.mark.parametrize("threshold,pad", [
    (64 * 1024 * 1024, 1),    # everything of a dtype in one bucket
    (40_000, 1),              # capacity closes buckets
    (8_192, 1),               # wte / fc kernels are split (oversize)
    (3_000, 1),
    (8_192, 4),               # pad_elems > 1
    (1_000, 256),
])
def test_fusion_buckets_match_reference(threshold, pad):
    leaves, dts = _gpt2_leaves()
    jb, junpack = jfusion.fuse([_to_jax(l, d) for l, d in zip(leaves, dts)],
                               threshold, pad_elems=pad)
    tensors = [_to_torch(l, d) for l, d in zip(leaves, dts)]
    pb, punpack = pfusion.fuse(tensors, threshold, pad_elems=pad)
    assert [b.shape[0] for b in pb] == [b.shape[0] for b in jb]
    for a, b in zip(pb, jb):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))
    # unpack in place restores every tensor exactly
    dst = [torch.zeros_like(t) for t in tensors]
    punpack([b * 1 for b in pb], out=dst)
    for a, b in zip(dst, tensors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("threshold", [512, 4096, 100_000])
def test_planner_matches_python_reference(threshold):
    sizes = [4, 600, 511, 513, 4096, 12, 70_000, 3, 1024]
    want, used, bucket = [], 0, -1
    for sz in sizes:     # horovod_tpu/fusion.py:_plan_buckets, Python path
        sz = -(-sz // jfusion.FUSION_ALIGN_BYTES) * jfusion.FUSION_ALIGN_BYTES
        if bucket < 0 or used + sz > threshold:
            bucket += 1
            used = 0
        want.append(bucket)
        used += sz
    assert pfusion.plan_buckets(sizes, threshold) == want
    assert pfusion.FUSION_ALIGN_BYTES == jfusion.FUSION_ALIGN_BYTES


def test_default_threshold_and_config(monkeypatch):
    from horovod_tpu_torch import config as pconfig
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD", raising=False)
    assert pconfig.refresh().fusion_threshold_bytes == \
        jfusion.DEFAULT_FUSION_THRESHOLD_BYTES
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    assert pconfig.refresh().fusion_threshold_bytes == 4096
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "lots")
    with pytest.raises(ValueError):
        pconfig.refresh()
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "4096")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="RANK"):
        pconfig.refresh()
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pconfig.refresh()
    monkeypatch.undo()
    pconfig.refresh()
