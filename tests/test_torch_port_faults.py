"""Faults of the port against the reference, each pinned by a test.

* A single-tensor allreduce goes through the fusion plan: a tensor above
  ``fusion_threshold_bytes`` is reduced in aligned chunks, so Adasum takes
  its coefficients per chunk, as the reference's eager ``allreduce`` does
  (``horovod_tpu/collective.py``, ``fusion.fused_apply``). A spawned
  two-rank gloo world reduces a 300-element fp32 tensor at a 512-byte
  threshold; Adasum must match the reference at that threshold (rtol 1e-4,
  atol 1e-5, its Adasum tests' tolerance), and Sum, Average, Min, Max and
  Product must be the same at 512 bytes and at the default threshold (they
  are elementwise) and equal the reference's.
* ``broadcast_optimizer_state`` when the ranks' states differ (the root
  resumed, the others are fresh): ``torch.optim.Adam`` stepped on rank 0
  only, then broadcast; both ranks' ``exp_avg``, ``exp_avg_sq`` and
  ``step`` must equal rank 0's, and one more step on both must give the
  same parameters. The reverse case (a root with no state) leaves no state
  on the other rank.
* ``name=`` reaches the op's span, its timeline events and the pending
  entry the stall watchdog reports, on every public collective.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu_torch import metrics as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
OPS = {"average": 0, "sum": 1, "min": 2, "max": 3, "product": 4}


def _inputs():
    g = np.random.default_rng(17)
    return {"x": g.standard_normal((2, 300)).astype(np.float32),
            "w": g.standard_normal((2, 7, 5)).astype(np.float32),
            "b": g.standard_normal((2, 5)).astype(np.float32)}


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    d = np.load(sys.argv[2])
    x = torch.tensor(d["x"][r])
    out = {"adasum_512": hvd.allreduce(x, op=hvd.Adasum,
                                       fusion_threshold_bytes=512),
           "adasum_default": hvd.allreduce(x, op=hvd.Adasum)}
    h = hvd.allreduce_async(x, op=hvd.Adasum, fusion_threshold_bytes=512)
    out["adasum_512_async"] = hvd.synchronize(h)
    ops = {"average": hvd.Average, "sum": hvd.Sum, "min": hvd.Min,
           "max": hvd.Max, "product": hvd.Product}
    for name, op in ops.items():
        out[name + "_512"] = hvd.allreduce(x, op=op,
                                           fusion_threshold_bytes=512)
        out[name + "_default"] = hvd.allreduce(x, op=op)

    # Optimizer state: Adam stepped on rank 0 only (a resumed root).
    w = torch.nn.Parameter(torch.tensor(d["w"][0]))
    b = torch.nn.Parameter(torch.tensor(d["b"][0]))
    opt = torch.optim.Adam([{"params": [w]}, {"params": [b], "lr": 0.01}],
                           lr=0.05)
    if r == 0:
        for _ in range(2):
            opt.zero_grad()
            ((w * b).sum(1).square().sum()).backward()
            opt.step()
    hvd.broadcast_parameters([w, b], root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for i, p in enumerate((w, b)):
        st = opt.state[p]
        out[f"p{i}_exp_avg"] = st["exp_avg"].clone()
        out[f"p{i}_exp_avg_sq"] = st["exp_avg_sq"].clone()
        out[f"p{i}_step"] = torch.as_tensor(st["step"]).reshape(1).clone()
    out["lr1"] = torch.tensor([opt.param_groups[1]["lr"]])
    opt.zero_grad()
    ((w * b).sum(1).square().sum()).backward()
    opt.step()
    out["w_after"], out["b_after"] = w.detach(), b.detach()
    # The reverse: the root has no state, rank 1 has.
    opt2 = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=0.1)
    if r == 1:
        p = opt2.param_groups[0]["params"][0]
        p.grad = torch.ones(3)
        opt2.step()
    hvd.broadcast_optimizer_state(opt2, root_rank=0)
    out["reverse_state_len"] = torch.tensor([len(opt2.state)])
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.float().numpy() for k, v in out.items()})
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]


def _reference(op, threshold=None):
    x = _inputs()["x"]
    ps = jhvd.add_process_set([0, 1])
    try:
        stacked = np.concatenate([x, np.repeat(x[1:], 6, axis=0)])
        kw = {} if threshold is None else {
            "fusion_threshold_bytes": threshold}
        return np.asarray(jhvd.allreduce(jnp.asarray(stacked), op=op,
                                         process_set=ps, **kw))[:2]
    finally:
        jhvd.remove_process_set(ps)


@pytest.mark.parametrize("name", ["adasum_512", "adasum_512_async"])
def test_single_tensor_adasum_takes_the_fusion_threshold(two, name):
    want = _reference(5, threshold=512)
    for r in range(2):
        np.testing.assert_allclose(two[r][name], want[r],
                                   err_msg=f"rank {r}", **TOL)
    # The chunks' coefficients differ from one Adasum over the tensor.
    whole = _reference(5)
    np.testing.assert_allclose(two[0]["adasum_default"], whole[0], **TOL)
    assert not np.allclose(two[0][name], whole[0], **TOL)


@pytest.mark.parametrize("name", sorted(OPS))
def test_elementwise_ops_are_unchanged_by_the_split(two, name):
    want = _reference(OPS[name], threshold=512)
    for r in range(2):
        np.testing.assert_array_equal(two[r][name + "_512"],
                                      two[r][name + "_default"])
        np.testing.assert_allclose(two[r][name + "_512"], want[r],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", ["p0_exp_avg", "p0_exp_avg_sq", "p0_step",
                                 "p1_exp_avg", "p1_exp_avg_sq", "p1_step",
                                 "lr1"])
def test_optimizer_state_of_a_resumed_root_reaches_fresh_ranks(two, key):
    np.testing.assert_array_equal(two[1][key], two[0][key])
    if key.endswith("step"):
        assert two[0][key][0] == 2.0


def test_step_after_the_state_broadcast_agrees(two):
    for key in ("w_after", "b_after"):
        np.testing.assert_array_equal(two[1][key], two[0][key])
    assert not np.array_equal(two[0]["w_after"], _inputs()["w"][0])


def test_a_root_without_state_clears_the_others(two):
    for r in range(2):
        assert two[r]["reverse_state_len"][0] == 0


# ---------------------------------------------------------------- name=

def _named_ops():
    x = torch.arange(6.0).reshape(2, 3)
    ops = {
        "allreduce": lambda n: hvd.allreduce(x, name=n),
        "allreduce_": lambda n: hvd.allreduce_(x.clone(), name=n),
        "allreduce_async": lambda n: hvd.synchronize(
            hvd.allreduce_async(x, name=n)),
        "allreduce_async_": lambda n: hvd.synchronize(
            hvd.allreduce_async_(x.clone(), name=n)),
        "grouped_allreduce": lambda n: hvd.grouped_allreduce([x, x],
                                                             name=n),
        "grouped_allreduce_async": lambda n: hvd.synchronize(
            hvd.grouped_allreduce_async([x], name=n)),
        "broadcast": lambda n: hvd.broadcast(x, 0, name=n),
        "broadcast_": lambda n: hvd.broadcast_(x.clone(), 0, name=n),
        "broadcast_async": lambda n: hvd.synchronize(
            hvd.broadcast_async(x, 0, name=n)),
        "broadcast_async_": lambda n: hvd.synchronize(
            hvd.broadcast_async_(x.clone(), 0, name=n)),
        "allgather": lambda n: hvd.allgather(x, name=n),
        "allgather_async": lambda n: hvd.synchronize(
            hvd.allgather_async(x, name=n)),
        "grouped_allgather": lambda n: hvd.grouped_allgather([x], name=n),
        "grouped_allgather_async": lambda n: hvd.synchronize(
            hvd.grouped_allgather_async([x], name=n)),
        "ragged_allgather": lambda n: hvd.ragged_allgather(x, name=n),
        "alltoall": lambda n: hvd.alltoall(x, name=n),
        "alltoall_splits": lambda n: hvd.alltoall(x, splits=[2], name=n),
        "alltoall_async": lambda n: hvd.synchronize(
            hvd.alltoall_async(x, name=n)),
        "reducescatter": lambda n: hvd.reducescatter(x, name=n),
        "reducescatter_async": lambda n: hvd.synchronize(
            hvd.reducescatter_async(x, name=n)),
        "grouped_reducescatter": lambda n: hvd.grouped_reducescatter(
            [x], name=n),
        "grouped_reducescatter_async": lambda n: hvd.synchronize(
            hvd.grouped_reducescatter_async([x], name=n)),
    }
    return ops


@pytest.mark.parametrize("op", sorted(_named_ops()))
def test_name_reaches_span_timeline_and_stall_entry(op, monkeypatch,
                                                   tmp_path):
    seen = []
    begin = M.collective_begin

    def spy(*args, **kwargs):
        tok = begin(*args, **kwargs)
        seen.extend(e["tensor"] for e in M.pending_collectives())
        return tok

    monkeypatch.setattr(M, "collective_begin", spy)
    hvd.init(device="cpu")
    try:
        hvd.start_timeline(str(tmp_path / "t.json"))
        _named_ops()[op](f"grad/{op}")
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
    assert f"grad/{op}" in seen
    evs = json.load(open(tmp_path / "t.json"))["traceEvents"]
    tagged = {e["name"] for e in evs
              if e.get("args", {}).get("tensor") == f"grad/{op}"}
    assert {"QUEUE", "EXEC"} <= tagged, tagged
