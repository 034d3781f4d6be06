"""horovod_tpu_torch's quantized wire == horovod_tpu's (``ops/quantized.py``).

``quantize_blocks`` / ``dequantize_blocks`` run in one process on the same
numpy inputs in both packages and must agree bit for bit: int8 and fp8
codes, fp32 scales, and the dequantized values, with ragged tails, zero
blocks, blocks whose max-abs is below the derived-scale floors, subnormal
inputs and bf16 inputs.

``quantized_allreduce`` and the ``Compression.int8`` / ``fp8`` marker path
of ``allreduce`` run on spawned gloo worlds of 2 and 4 ranks of the port
(``python -m horovod_tpu_torch.runner``), over the global set and subsets,
with Sum and Average. The reference computes the same reductions under its
``tensor[r]`` = rank r convention over process sets of the same ranks of
the 8-device CPU mesh (eager ``allreduce(compression=...)``, which runs its
``quantized_allreduce``). Tolerances: the phase-1 codes are the same, but
the reference's compiled sum of the dequantized rows may contract the
multiply and the add (one rounding fewer) and takes its own order, so the
reduced chunk can differ in its last bits; that moves a block's scale by
an ulp, and now and then a re-quantized value by one step. So every
element must lie within one step (max-abs / 127 for int8, max-abs / 8 for
fp8, the coarsest fp8 step below 448) of the reference's block, and 99 %
within 1e-6 of the reference's value, relatively.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu.ops import quantized as R

from horovod_tpu_torch.ops import quantized as Q

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8                     # devices of the reference's mesh
WIRES = ("int8", "fp8")
STEPS = {"int8": 127.0, "fp8": 8.0}


def _case(name):
    g = np.random.default_rng(CASES.index(name))
    if name == "ragged":
        return g.standard_normal((3, 1000)).astype(np.float32)
    if name == "wide_range":
        return (g.standard_normal((2, 777))
                * np.exp(g.uniform(-30, 10, (2, 777)))).astype(np.float32)
    if name == "zero_blocks":
        x = g.standard_normal((2, 600)).astype(np.float32)
        x[0, :256] = 0.0
        x[1, 512:] = 0.0
        return x
    if name == "below_floor":
        x = g.standard_normal((1, 768)).astype(np.float32)
        x[0, :256] *= np.float32(1e-37)     # absmax / 127 would be subnormal
        x[0, 256:512] = np.float32(1e-40)   # subnormal inputs
        return x
    if name == "one_element":
        return np.asarray([[3.5]], np.float32)
    raise KeyError(name)


CASES = ("ragged", "wide_range", "zero_blocks", "below_floor", "one_element")


def _codes(q):
    q = np.asarray(q)
    return q.view(np.uint8) if q.dtype.itemsize == 1 and q.dtype.kind != "i" \
        else q


def _pcodes(q):
    return q.view(torch.uint8).numpy() if q.dtype == torch.float8_e4m3fn \
        else q.numpy()


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("case", CASES)
def test_quantize_blocks_bit_exact(case, wire):
    x = _case(case)
    rq, rs = R.quantize_blocks(jnp.asarray(x), wire)
    pq, ps = Q.quantize_blocks(torch.tensor(x), wire)
    np.testing.assert_array_equal(_pcodes(pq), _codes(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        Q.dequantize_blocks(pq, ps).numpy(),
        np.asarray(R.dequantize_blocks(rq, rs)))
    assert np.isfinite(Q.dequantize_blocks(pq, ps).numpy()).all()


@pytest.mark.parametrize("wire", WIRES)
def test_quantize_blocks_bf16_input_bit_exact(wire):
    x = np.random.default_rng(5).standard_normal((2, 300)).astype(np.float32)
    rq, rs = R.quantize_blocks(jnp.asarray(x, jnp.bfloat16), wire)
    pq, ps = Q.quantize_blocks(torch.tensor(x).to(torch.bfloat16), wire)
    np.testing.assert_array_equal(_pcodes(pq), _codes(rq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))


def test_wire_overhead_and_constants_match():
    assert Q.BLOCK == R.BLOCK and Q.WIRE_FORMATS == R.WIRE_FORMATS
    for n in (0, 1, 255, 256, 257, 10 ** 6):
        assert Q.wire_overhead_bytes(n) == R.wire_overhead_bytes(n)
    with pytest.raises(ValueError, match="unknown wire format"):
        Q.quantize_blocks(torch.zeros(4), "int4")


# ------------------------------------------------ allreduce on gloo worlds

L = 1500                  # ragged: not a multiple of BLOCK * ranks


def _inputs(n):
    g = np.random.default_rng(17 + n)
    x = g.standard_normal((n, L)).astype(np.float32)
    x[:, 256:512] *= 1e3              # a block far above the others
    return {"x": x,
            "small": g.standard_normal((n, 40)).astype(np.float32) * 1e-3,
            "ints": g.integers(-50, 50, (n, 9)).astype(np.int32)}


SETS = {2: {"all": [0, 1]}, 4: {"all": [0, 1, 2, 3], "s13": [1, 3]}}

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    data = {k: torch.tensor(v[r]) for k, v in np.load(sys.argv[2]).items()}
    sets = {"all": None}
    if n == 4:
        sets["s13"] = hvd.add_process_set([1, 3])
    out = {}
    for sname, ps in sets.items():
        for wire in ("int8", "fp8"):
            comp = getattr(hvd.Compression, wire)
            for oname, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
                key = f"{sname}_{wire}_{oname}"
                if ps is None or ps.included():
                    out["qa_" + key] = hvd.quantized_allreduce(
                        data["x"], average=op == hvd.Average, wire=wire,
                        process_set=ps)
                res = hvd.grouped_allreduce(
                    [data["x"], data["small"], data["ints"]], op=op,
                    compression=comp, process_set=ps)
                for i, t in enumerate(res):
                    out[f"marker{i}_" + key] = t
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.numpy() for k, v in out.items()})
    hvd.shutdown()
""")


def _world(tmp_path_factory, n):
    tmp = tmp_path_factory.mktemp(f"quantized{n}")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs(n))
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: _world(tmp_path_factory, n) for n in (2, 4)}


def _stack8(rows):
    rows = np.asarray(rows)
    pad = np.zeros((N - rows.shape[0],) + rows.shape[1:], rows.dtype)
    return jnp.asarray(np.concatenate([rows, pad]))


_REF_CACHE: dict = {}


def _reference(n, members, wire, op):
    """The reference's member rows of the marker path: a list of three
    results (x, small, ints), each (8, ...)."""
    key = (n, tuple(members), wire, op)
    if key not in _REF_CACHE:
        data = _inputs(n)
        ps = jhvd.add_process_set(members)
        try:
            res = jhvd.grouped_allreduce(
                [_stack8(data["x"]), _stack8(data["small"]),
                 _stack8(data["ints"])], op=op,
                compression=getattr(JCompression, wire), process_set=ps)
            _REF_CACHE[key] = [np.asarray(t) for t in res]
        finally:
            jhvd.remove_process_set(ps)
    return _REF_CACHE[key]


def _assert_rows(got, want, wire):
    blocks = np.abs(np.pad(want, (0, (-len(want)) % Q.BLOCK))).reshape(
        -1, Q.BLOCK).max(axis=1)
    step = np.repeat(blocks / STEPS[wire], Q.BLOCK)[:len(want)]
    d = np.abs(got - want)
    assert (d <= step + 1e-30).all(), d.max()
    assert np.mean(d <= 1e-6 * np.abs(want) + 1e-30) >= 0.99


@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("n,sname", [(2, "all"), (4, "all"), (4, "s13")])
def test_quantized_allreduce_matches_reference_rows(worlds, n, sname, wire,
                                                    op):
    members = SETS[n][sname]
    jop = jhvd.Sum if op == "sum" else jhvd.Average
    want = _reference(n, members, wire, jop)
    x = _inputs(n)["x"]
    key = f"{sname}_{wire}_{op}"
    for r in range(n):
        res = worlds[n][r]
        if r not in members:
            # Outside the set: its own tensor back from the marker path.
            np.testing.assert_array_equal(res["marker0_" + key], x[r])
            continue
        _assert_rows(res["qa_" + key], want[0][r], wire)
        _assert_rows(res["marker0_" + key], want[0][r], wire)
        _assert_rows(res["marker1_" + key], want[1][r], wire)
        # Integer tensors take the exact reduction.
        np.testing.assert_array_equal(res["marker2_" + key], want[2][r])
        # Every member dequantizes the same bytes.
        np.testing.assert_array_equal(res["qa_" + key],
                                      worlds[n][members[0]]["qa_" + key])


@pytest.mark.parametrize("wire", WIRES)
def test_small_tensor_keeps_its_own_scale(worlds, wire):
    """A 1e-3 tensor fused with a 1e3-magnitude one: each tensor is padded
    to whole blocks, so the small one keeps its own scale."""
    data = _inputs(2)
    want = data["small"].mean(axis=0)
    got = worlds[2][0][f"marker1_all_{wire}_avg"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.abs(want).max() / STEPS[wire])
