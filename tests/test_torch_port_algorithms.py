"""horovod_tpu_torch's allreduce algorithm axis == horovod_tpu's
(``overlap.py``, ``collective.allreduce(algorithm=, overlap_chunks=,
wire=)``, the ``config.py`` knobs).

In one process: ``resolve_algorithm``, ``wire_bytes_by_phase``,
``_split_sizes``, ``parse_algorithm`` / ``compose_algorithm``, the
rejection messages, the Swing tables and the environment knobs (values and
error messages) of both packages on a grid of inputs; they must be equal.

On spawned gloo worlds of the port (``python -m horovod_tpu_torch.runner``)
of 2 ranks and of 4 ranks under ``HOROVOD_TOPOLOGY=2x2`` (so the ``_2d``
lowerings run two phases): the port of ``tests/test_overlap.py``'s matrix,
every algorithm x {Sum, Average} x {fp32, bf16}, against the reference's
``psum`` over a process set of the same ranks of its 8-device mesh
(``tensor[r]`` = rank r); prescale and postscale; a subset set; Min, Max,
Product and Adasum passing through unchanged; integer tensors exact under
the quantized algorithms; mixed-magnitude tensors under a quantized wire;
``swing`` bit-identical on every rank; and the per-bucket counters
(``allreduce_algorithm_total``, ``allreduce_wire_bytes_total`` per leg)
equal to the reference's for the same call. Tolerances are the reference's
own (``tests/test_overlap.py``): fp32 rtol 2e-6 / atol 1e-5, bf16 2e-2 /
2e-2, the quantized wires three half-steps of the largest value a
contribution (``_qtol``), integers exact.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu import config as jconfig
from horovod_tpu import overlap as R

from horovod_tpu_torch import config as pconfig
from horovod_tpu_torch import overlap as O

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
M = 777
OPS = {"sum": 1, "avg": 0}


# ------------------------------------------------------ one process, grids

def test_constants_match():
    assert O.ALGORITHMS == R.ALGORITHMS and O.WIRES == R.WIRES
    assert O.QUANT_WIRES == R.QUANT_WIRES
    assert (O.RS_AG_MIN_BYTES, O.CHUNKED_MIN_BYTES, O.DEFAULT_CHUNKS) == (
        R.RS_AG_MIN_BYTES, R.CHUNKED_MIN_BYTES, R.DEFAULT_CHUNKS)


@pytest.mark.parametrize("requested", R.ALGORITHMS)
def test_resolve_algorithm_matches_on_a_grid(requested):
    for nbytes in (0, 1024, R.RS_AG_MIN_BYTES - 1, R.RS_AG_MIN_BYTES,
                   R.CHUNKED_MIN_BYTES - 1, R.CHUNKED_MIN_BYTES, 1 << 30):
        for world in (1, 2, 3, 4, 6, 8):
            for reducible in (True, False):
                for wire in (None, "fp32", "bf16", "int8", "fp8"):
                    for topo in (None, (world,), (2, world // 2 or 1),
                                 (1, world)):
                        args = (requested, nbytes, 1, world, reducible,
                                wire, topo)
                        assert O.resolve_algorithm(*args) == \
                            R.resolve_algorithm(*args), args


def test_wire_bytes_by_phase_and_split_sizes_match_on_a_grid():
    for base in ("psum", "auto", "rs_ag", "chunked_rs_ag", "swing",
                 "rs_ag_2d", "chunked_rs_ag_2d"):
        for nelems in (0, 1, 255, 777, 4096, 10 ** 6 + 3):
            for wire in ("fp32", "bf16", "fp16", "int8", "fp8", "raw-int8"):
                for world, dims in ((2, None), (4, (2, 2)), (8, (2, 4)),
                                    (8, (8,)), (6, (3, 2))):
                    for eb in (4, 2):
                        args = (base, nelems, wire, world)
                        assert O.wire_bytes_by_phase(
                            *args, dims=dims, elem_bytes=eb) == \
                            R.wire_bytes_by_phase(*args, dims=dims,
                                                  elem_bytes=eb), args
    for m in (1, 5, 255, 777, 4096, 10 ** 6 + 3):
        for n in (1, 2, 3, 4, 512, 2048):
            for chunks in (0, 1, 3, 4, 8, 100):
                assert O._split_sizes(m, n, chunks) == \
                    R._split_sizes(m, n, chunks)


def test_parse_compose_and_rejections_match():
    for a in R.ALGORITHMS + ("swing_int8", "psum_fp8", "rs_ag_int4"):
        assert O.parse_algorithm(a) == R.parse_algorithm(a)
        for w in (None, "fp32", "bf16", "int8", "fp8"):
            base = R.parse_algorithm(a)[0]
            assert O.compose_algorithm(base, w) == \
                R.compose_algorithm(base, w)
    for bad in ("swing_int8", "psum_fp8", "ring", "rs_ag_int4"):
        for knob in (None, "allreduce(algorithm=...)"):
            with pytest.raises(ValueError) as want:
                R._reject_algorithm(bad, knob)
            with pytest.raises(ValueError) as got:
                O._reject_algorithm(bad, knob)
            assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_swing_schedule_matches(n):
    k, perms, keep, send = O._swing_schedule(n)
    rk, rperms, rkeep, rsend = R._swing_schedule(n)
    assert (k, perms) == (rk, rperms)
    for a, b in zip(keep + send, rkeep + rsend):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="power-of-two"):
        O._swing_schedule(6)


def test_torus_lines_match_the_reference_groups():
    from horovod_tpu.parallel.mesh import torus_groups
    for dims in ((2, 2), (2, 4), (4, 2), (2, 2, 2), (3, 2)):
        assert O.torus_lines(dims) == torus_groups(dims)


ENV_CASES = [
    ("HOROVOD_ALLREDUCE_ALGORITHM", "rs_ag_int8"),
    ("HOROVOD_ALLREDUCE_ALGORITHM", " SWING "),
    ("HOROVOD_ALLREDUCE_ALGORITHM", ""),
    ("HOROVOD_ALLREDUCE_ALGORITHM", "ring"),
    ("HOROVOD_ALLREDUCE_WIRE", "bf16"),
    ("HOROVOD_ALLREDUCE_WIRE", "off"),
    ("HOROVOD_ALLREDUCE_WIRE", "int4"),
    ("HOROVOD_OVERLAP_CHUNKS", "8"),
    ("HOROVOD_OVERLAP_CHUNKS", "0"),
    ("HOROVOD_OVERLAP_CHUNKS", "two"),
    ("HOROVOD_TOPOLOGY", "2x2"),
    ("HOROVOD_TOPOLOGY", "4X8x1"),
    ("HOROVOD_TOPOLOGY", "2xx2"),
    ("HOROVOD_TOPOLOGY", "0x4"),
]
_READERS = {"HOROVOD_ALLREDUCE_ALGORITHM": "_env_algorithm",
            "HOROVOD_ALLREDUCE_WIRE": "_env_wire",
            "HOROVOD_OVERLAP_CHUNKS": "_env_chunks",
            "HOROVOD_TOPOLOGY": "_env_topology"}


@pytest.mark.parametrize("var,value", ENV_CASES)
def test_env_knobs_and_errors_match(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    fn = _READERS[var]
    try:
        want = ("ok", getattr(jconfig, fn)())
    except ValueError as e:
        want = ("error", str(e))
    try:
        got = ("ok", getattr(pconfig, fn)())
    except ValueError as e:
        got = ("error", str(e))
    assert got == want


def test_config_reads_the_knobs(monkeypatch):
    for k, v in (("HOROVOD_ALLREDUCE_ALGORITHM", "chunked_rs_ag_fp8"),
                 ("HOROVOD_ALLREDUCE_WIRE", "bf16"),
                 ("HOROVOD_OVERLAP_CHUNKS", "3"),
                 ("HOROVOD_TOPOLOGY", "2x2"),
                 ("HOROVOD_AUTOTUNE", "1"),
                 ("HOROVOD_AUTOTUNE_MODE", "Bayes"),
                 ("HOROVOD_AUTOTUNE_PROBES", "4"),
                 ("HOROVOD_AUTOTUNE_SAMPLES", "2")):
        monkeypatch.setenv(k, v)
    try:
        c = pconfig.refresh()
        assert (c.allreduce_algorithm, c.allreduce_wire, c.overlap_chunks,
                c.topology, c.autotune, c.autotune_mode, c.autotune_probes,
                c.autotune_samples) == ("chunked_rs_ag_fp8", "bf16", 3,
                                        "2x2", True, "bayes", 4, 2)
    finally:
        monkeypatch.undo()
        pconfig.refresh()


def test_detect_topology_rules():
    from horovod_tpu.parallel.mesh import parse_topology as jparse
    from horovod_tpu_torch.parallel.mesh import (detect_topology,
                                                 parse_topology)
    assert parse_topology("4x8x2") == jparse("4x8x2") == (4, 8, 2)
    assert detect_topology(4, 4, override="2x2") == (2, 2)
    assert detect_topology(8, 4) == (2, 4)          # 2 hosts x 4 GPUs
    assert detect_topology(4, 4) == (4,)            # one host
    assert detect_topology(4, 1) == (4,)            # one GPU a host
    assert detect_topology(1, 1) == (1,)
    with pytest.raises(ValueError, match="describes 4 devices"):
        detect_topology(8, 8, override="2x2")


def test_allreduce_rejects_bad_axis_arguments():
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    try:
        x = torch.ones(4)
        with pytest.raises(ValueError, match="allreduce\\(algorithm=...\\)"):
            hvd.allreduce(x, algorithm="ring")
        with pytest.raises(ValueError, match="has no quantized lowering"):
            hvd.allreduce(x, algorithm="swing_int8")
        with pytest.raises(ValueError, match="unknown allreduce wire"):
            hvd.allreduce(x, wire="int4")
        with pytest.raises(ValueError, match="overlap_chunks must be >= 1"):
            hvd.allreduce(x, overlap_chunks=0)
        assert hvd.topology() == (1,) and hvd.topology_str() == "1"
        # One rank: every algorithm resolves to psum, values unchanged.
        for alg in O.ALGORITHMS:
            assert torch.equal(hvd.allreduce(x, op=hvd.Sum, algorithm=alg),
                               x)
    finally:
        hvd.shutdown()


# ------------------------------------------------------ gloo worlds

def _inputs(n):
    g = np.random.default_rng(23 + n)
    return {
        "x": g.standard_normal((n, M)).astype(np.float32),
        "xi": g.integers(-50, 50, (n, 37)).astype(np.int32),
        "big": np.full((n, 4), 100.0, np.float32),
        "small": np.full((n, 1000), 1e-3, np.float32),
        "c": g.standard_normal((n, 3000)).astype(np.float32),
        "i8": g.integers(-100, 100, (n, 512)).astype(np.int8),
    }


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, overlap

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    d = {k: torch.tensor(v[r]) for k, v in np.load(sys.argv[2]).items()}
    out, counters = {}, {}
    ops = {"sum": hvd.Sum, "avg": hvd.Average}
    for alg in overlap.ALGORITHMS:
        for oname, op in ops.items():
            for dt in ("float32", "bfloat16"):
                x = d["x"].to(getattr(torch, dt))
                out[f"m_{alg}_{oname}_{dt}"] = hvd.allreduce(
                    x, op=op, algorithm=alg, overlap_chunks=3).float()
        out[f"scaled_{alg}"] = hvd.allreduce(
            d["x"], op=hvd.Sum, prescale_factor=0.5, postscale_factor=3.0,
            algorithm=alg)
        out[f"int_{alg}"] = hvd.allreduce(d["xi"], op=hvd.Sum,
                                          algorithm=alg)
        for oname, op in (("min", hvd.Min), ("max", hvd.Max),
                          ("prod", hvd.Product), ("adasum", hvd.Adasum)):
            out[f"pass_{alg}_{oname}"] = hvd.allreduce(d["x"], op=op,
                                                       algorithm=alg)
    sub = hvd.add_process_set([0, 1])
    for alg in ("rs_ag", "chunked_rs_ag_int8", "chunked_rs_ag_fp8",
                "swing", "rs_ag_2d"):
        for oname, op in ops.items():
            out[f"sub_{alg}_{oname}"] = hvd.allreduce(
                d["x"], op=op, process_set=sub, algorithm=alg,
                overlap_chunks=2)
    big, small = hvd.grouped_allreduce([d["big"], d["small"]],
                                       op=hvd.Average,
                                       algorithm="chunked_rs_ag_int8")
    out["mixed_big"], out["mixed_small"] = big, small
    for name, kw, t in (("rs_ag", {"algorithm": "rs_ag"}, "c"),
                        ("rs_ag_int8", {"algorithm": "rs_ag_int8"}, "c"),
                        ("psum_i8", {"algorithm": "psum"}, "i8"),
                        ("bf16", {"algorithm": "rs_ag", "wire": "bf16"},
                         "c"),
                        ("swing", {"algorithm": "swing"}, "c"),
                        ("rs_ag_2d_fp8", {"algorithm": "rs_ag_2d_fp8"},
                         "c")):
        hvd.reset_metrics()
        hvd.allreduce(d[t], op=hvd.Sum, **kw)
        snap = metrics.snapshot()
        counters[name] = {
            f: [[s["labels"], s["value"]] for s in snap["counters"].get(f, [])]
            for f in ("allreduce_algorithm_total",
                      "allreduce_wire_bytes_total")}
        counters[name]["ratio"] = [
            [s["labels"], s["value"]]
            for s in snap["gauges"].get("allreduce_compression_ratio", [])]
    out["topology"] = torch.tensor(hvd.topology())
    np.savez(sys.argv[3] + f".rank{r}.npz",
             counters=np.array(json.dumps(counters)),
             **{k: v.numpy() for k, v in out.items()})
    hvd.shutdown()
""")


def _world(tmp_path_factory, n, topology=None):
    tmp = tmp_path_factory.mktemp(f"algorithms{n}")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs(n))
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("HOROVOD_TOPOLOGY", None)
    if topology:
        env["HOROVOD_TOPOLOGY"] = topology
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "--timeout", "280", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=320)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(n)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {2: _world(tmp_path_factory, 2),
            4: _world(tmp_path_factory, 4, topology="2x2")}


def _stack8(rows):
    rows = np.asarray(rows)
    pad = np.zeros((N - rows.shape[0],) + rows.shape[1:], rows.dtype)
    return jnp.asarray(np.concatenate([rows, pad]))


_REF: dict = {}


def _reference(key, rows, members, **kw):
    """The reference's eager allreduce of ``rows`` over the set
    ``members`` (row r = rank r); its rows as float64."""
    if key not in _REF:
        ps = jhvd.add_process_set(members)
        try:
            _REF[key] = np.asarray(jhvd.allreduce(
                _stack8(rows), process_set=ps, **kw)).astype(np.float64)
        finally:
            jhvd.remove_process_set(ps)
    return _REF[key]


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bfloat16" else \
        dict(rtol=2e-6, atol=1e-5)


def _qtol(alg, x, k):
    steps = 127 if "int8" in alg else 8
    return 3.0 * k * float(np.abs(np.asarray(x, np.float32)).max()) / steps


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["sum", "avg"])
@pytest.mark.parametrize("n", [2, 4])
def test_every_algorithm_matches_reference_psum(worlds, n, op, dt):
    x = _inputs(n)["x"]
    members = list(range(n))
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    rows = np.asarray(jnp.asarray(x, jdt))
    want = _reference(("psum", n, op, dt), rows, members, op=OPS[op],
                      algorithm="psum")
    k = n if op == "sum" else 1
    for alg in R.ALGORITHMS:
        for r in range(n):
            got = worlds[n][r][f"m_{alg}_{op}_{dt}"].astype(np.float64)
            if R.parse_algorithm(alg)[1] is None:
                np.testing.assert_allclose(got, want[r], err_msg=alg,
                                           **_tol(dt))
            else:
                bound = _qtol(alg, x, k) + (0.1 * k if dt == "bfloat16"
                                            else 0.0)
                assert np.abs(got - want[r]).max() < bound, alg


@pytest.mark.parametrize("n", [2, 4])
def test_swing_and_quantized_results_are_identical_on_every_rank(worlds, n):
    for alg in R.ALGORITHMS:
        for key in (f"m_{alg}_sum_float32", f"m_{alg}_avg_bfloat16"):
            for r in range(1, n):
                np.testing.assert_array_equal(worlds[n][r][key],
                                              worlds[n][0][key], err_msg=key)


@pytest.mark.parametrize("n", [2, 4])
def test_prescale_postscale_and_integers(worlds, n):
    d = _inputs(n)
    members = list(range(n))
    want = _reference(("scaled", n), d["x"], members, op=1,
                      prescale_factor=0.5, postscale_factor=3.0,
                      algorithm="psum")
    wi = d["xi"].sum(axis=0)
    for alg in R.ALGORITHMS:
        for r in range(n):
            got = worlds[n][r][f"scaled_{alg}"].astype(np.float64)
            if R.parse_algorithm(alg)[1] is None:
                np.testing.assert_allclose(got, want[r], rtol=2e-6,
                                           atol=1e-5, err_msg=alg)
            else:
                assert np.abs(got - want[r]).max() < \
                    3.0 * _qtol(alg, d["x"], n), alg
            # Integer tensors stay exact under every algorithm.
            np.testing.assert_array_equal(worlds[n][r][f"int_{alg}"], wi)


@pytest.mark.parametrize("op", ["min", "max", "prod", "adasum"])
def test_other_ops_pass_through_unchanged(worlds, op):
    for n in (2, 4):
        for r in range(n):
            base = worlds[n][r][f"pass_psum_{op}"]
            for alg in R.ALGORITHMS:
                np.testing.assert_array_equal(
                    worlds[n][r][f"pass_{alg}_{op}"], base, err_msg=alg)
    x = _inputs(2)["x"]
    want = _reference(("min", 2), x, [0, 1], op=jhvd.Min)
    np.testing.assert_allclose(worlds[2][0]["pass_rs_ag_min"], want[0])


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_subset_set_matches_reference_member_rows(worlds, op):
    """The set {0, 1} of the 4-rank world: ``swing`` resolves on the set's
    two ranks, the ``_2d`` form runs its 1-D base; members get the
    reference's member rows, the others their own tensor."""
    x = _inputs(4)["x"]
    want = _reference(("sub", op), x, [0, 1], op=OPS[op], algorithm="psum")
    for alg in ("rs_ag", "chunked_rs_ag_int8", "chunked_rs_ag_fp8", "swing",
                "rs_ag_2d"):
        for r in range(4):
            got = worlds[4][r][f"sub_{alg}_{op}"]
            if r >= 2:
                np.testing.assert_array_equal(got, x[r])
            elif R.parse_algorithm(alg)[1] is None:
                np.testing.assert_allclose(got, want[r], rtol=2e-6,
                                           atol=1e-5, err_msg=alg)
            else:
                k = 2 if op == "sum" else 1
                assert np.abs(got - want[r]).max() < _qtol(alg, x, k), alg


def test_mixed_magnitude_tensors_keep_their_own_scales(worlds):
    for n in (2, 4):
        np.testing.assert_allclose(worlds[n][0]["mixed_big"], 100.0,
                                   rtol=1e-2)
        np.testing.assert_allclose(worlds[n][0]["mixed_small"], 1e-3,
                                   rtol=2e-2)


def test_two_dimensional_topology_is_detected(worlds):
    assert tuple(worlds[4][0]["topology"]) == (2, 2)
    assert tuple(worlds[2][0]["topology"]) == (2,)


def _series(entries):
    return {tuple(sorted(lab.items())): v for lab, v in entries}


_COUNTER_CALLS = {"rs_ag": ("c", {"algorithm": "rs_ag"}),
                  "rs_ag_int8": ("c", {"algorithm": "rs_ag_int8"}),
                  "psum_i8": ("i8", {"algorithm": "psum"}),
                  "bf16": ("c", {"algorithm": "rs_ag", "wire": "bf16"})}


@pytest.mark.parametrize("name", sorted(_COUNTER_CALLS))
def test_counters_equal_the_reference_for_the_same_call(worlds, monkeypatch,
                                                        name):
    """The same call on the 2-rank world and on the reference's set {0, 1}:
    equal algorithm counts, per-leg wire bytes and compression ratios
    (these are independent of the world's size). The reference counts
    when it compiles, so its program cache starts empty here."""
    from horovod_tpu import collective as JC
    t, kw = _COUNTER_CALLS[name]
    monkeypatch.setattr(JC, "_EAGER_CACHE", {})
    jhvd.reset_metrics()
    ps = jhvd.add_process_set([0, 1])
    try:
        jhvd.allreduce(_stack8(_inputs(2)[t]), op=jhvd.Sum, process_set=ps,
                       **kw)
    finally:
        jhvd.remove_process_set(ps)
    snap = jhvd.metrics()
    got = json.loads(str(worlds[2][0]["counters"]))[name]
    for fam in ("allreduce_algorithm_total", "allreduce_wire_bytes_total"):
        assert _series(got[fam]) == _series(
            [(s["labels"], s["value"]) for s in snap["counters"][fam]]), fam
    assert _series(got["ratio"]) == pytest.approx(_series(
        [(s["labels"], s["value"])
         for s in snap["gauges"]["allreduce_compression_ratio"]]))


@pytest.mark.parametrize("n", [2, 4])
def test_world_dependent_counters_follow_the_set_size(worlds, n):
    """``swing`` and the ``_2d`` forms count at the port's own world (the
    reference counts at its 8 devices): the reference's formula at n."""
    got = json.loads(str(worlds[n][0]["counters"]))
    c = _inputs(n)["c"].shape[1]
    padded = -(-c // 256) * 256     # a quantized bucket: whole blocks
    swing = _series(got["swing"]["allreduce_wire_bytes_total"])
    want = R.wire_bytes_by_phase("swing", c, "fp32", n)
    assert {dict(k)["phase"]: v for k, v in swing.items()} == want
    two_d = _series(got["rs_ag_2d_fp8"]["allreduce_wire_bytes_total"])
    dims = (2, 2) if n == 4 else None
    alg = "rs_ag_2d_fp8" if n == 4 else "rs_ag_fp8"
    base = "rs_ag_2d" if n == 4 else "rs_ag"
    want = R.wire_bytes_by_phase(base, padded, "fp8", n, dims=dims)
    assert {dict(k)["phase"]: v for k, v in two_d.items()
            if dict(k)["algorithm"] == alg} == want

def test_config_gauges_and_the_algorithm_marker(monkeypatch, tmp_path):
    """``init`` sets the reference's config gauges; every bucket leaves an
    ``allreduce_algorithm`` marker (category ``overlap``) in the
    timeline."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    monkeypatch.setenv("HOROVOD_ALLREDUCE_ALGORITHM", "swing")
    monkeypatch.setenv("HOROVOD_OVERLAP_CHUNKS", "3")
    monkeypatch.setenv("HOROVOD_ALLREDUCE_WIRE", "bf16")
    path = tmp_path / "trace.json"
    hvd.init(device="cpu")
    try:
        snap = metrics.snapshot()["gauges"]
        algs = {g["labels"]["algorithm"]: g["value"]
                for g in snap["config_allreduce_algorithm"]}
        assert algs["swing"] == 1 and sum(algs.values()) == 1
        assert set(algs) == set(R.ALGORITHMS)
        wires = {g["labels"]["wire"]: g["value"]
                 for g in snap["config_allreduce_wire"]}
        assert wires == {"fp32": 0, "bf16": 1, "int8": 0, "fp8": 0}
        assert snap["config_overlap_chunks"][0]["value"] == 3
        dims = {g["labels"]["dim"]: g["value"]
                for g in snap["config_topology"]}
        assert dims == {"0": 1, "1": 0, "2": 0, "3": 0}
        hvd.start_timeline(str(path))
        hvd.grouped_allreduce(
            [torch.ones(4), torch.ones(3, dtype=torch.int32)], op=hvd.Sum,
            name="probe")
        hvd.stop_timeline()
    finally:
        hvd.shutdown()
        monkeypatch.undo()
        pconfig.refresh()
    marks = [e for e in json.loads(path.read_text())["traceEvents"]
             if e["name"] == "allreduce_algorithm"]
    assert len(marks) == 2 and all(e["cat"] == "overlap" for e in marks)
    assert {e["args"]["wire"] for e in marks} == {"bf16", "int32"}
    assert all(e["args"]["algorithm"] == "psum" for e in marks)
