"""horovod_tpu_torch.profiler == horovod_tpu.profiler, on the CPU.

The same inputs, made with numpy, go through each package's profiler: the
utilization split and the peaks, ``describe``, the registry's fingerprints
(statuses, blame, counters, snapshots, the alternating-cached case and
``reanchor``), ``ProfiledStep`` over the same function, and the cost: the
port's capture of one real call counts exactly XLA's ``cost_analysis()``
FLOPs on a product-and-tanh program. The flash kernels' FLOPs come from a
tally their wrappers feed (4·d, 6·d, 8·d a visible pair), counted from any
thread: the reference counts no Pallas FLOPs (ROADMAP.md section C). The
captures mirror ``tests/test_profiler.py`` on ``torch.profiler`` (a Chrome
trace, not xplane), and the wiring: the eager allreduce's registry entry,
``AutotunedStep``, ``build_info``, a re-init's re-anchor, a planted stall
under ``HOROVOD_PROFILE_ON_STALL=1``.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import metrics as RM
from horovod_tpu import profiler as R
from horovod_tpu_torch import config
from horovod_tpu_torch import metrics as PM
from horovod_tpu_torch import profiler as P

FA = __import__("importlib").import_module(
    "horovod_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HOROVOD_PEAK_TFLOPS", "HOROVOD_HBM_GBPS",
              "HOROVOD_PROFILER_COST", "HOROVOD_PROFILE_ON_STALL",
              "HOROVOD_PROFILE_DIR", "HOROVOD_PROFILE_SECONDS",
              "HOROVOD_PROFILE_MAX_CAPTURES"):
        monkeypatch.delenv(k, raising=False)
    config.refresh()
    monkeypatch.setattr(P, "_PROFILE_CAPTURES", 0)     # a budget a test
    for reg, met in ((P.registry, PM), (R.registry, RM)):
        reg.reset()
        met.reset_metrics()
    yield
    for reg, met in ((P.registry, PM), (R.registry, RM)):
        reg.reset()
        met.reset_metrics()
    config.refresh()


def _family(snap, group, name):
    return sorted((tuple(sorted(s["labels"].items())), s["value"])
                  for s in snap[group].get(name, []))


def _counter(name, **labels):
    for s in PM.snapshot()["counters"].get(name, []):
        if all(str(s["labels"].get(k)) == str(v) for k, v in labels.items()):
            return s["value"]
    return 0


def _gauge(name, **labels):
    for s in PM.snapshot()["gauges"].get(name, []):
        if all(str(s["labels"].get(k)) == str(v) for k, v in labels.items()):
            return s["value"]
    return None


@pytest.mark.parametrize("name", sorted(R.__all__))
def test_every_public_name_of_the_reference_is_ported(name):
    assert name in P.__all__ and hasattr(P, name)


def test_top_level_names():
    assert hvd.profiler is P and hvd.doctor is P.doctor
    assert hvd.profile is P.profile
    assert {"profiler", "doctor", "profile"} <= set(hvd.__all__)
    assert jhvd.doctor is R.doctor          # the reference's own names


# ---------------------------------------------------------------------------
# peaks and utilization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flops,dt,model,peak", [
    (2e12, 0.5, 1e12, 100.0), (2e12, 0.5, None, 100.0),
    (7.3e13, 0.183, 4.9e13, 989.0), (1e9, 0.0, None, 10.0),
    (3e12, 1.25, 2e12, None)])
def test_utilization_equals_the_reference(flops, dt, model, peak):
    assert P.utilization(flops, dt, model, peak=peak) == \
        R.utilization(flops, dt, model, peak=peak)


@pytest.mark.parametrize("name,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    ("NVIDIA H200", 989.0, 4800.0),
    ("NVIDIA H200 NVL", 989.0, 4800.0),
    ("NVIDIA H100 PCIe", None, None),
    ("NVIDIA A100-SXM4-80GB", None, None),
    ("TPU v5 lite", None, None),
    ("", None, None)])
def test_peaks_by_card_name(name, tflops, gbps):
    assert P.peak_tflops(name) == tflops
    assert P.hbm_gbps(name) == gbps


def test_cpu_has_no_peak_and_env_overrides(monkeypatch):
    assert P.peak_tflops() is None and P.hbm_gbps() is None
    assert P.utilization(2e12, 0.5)["mfu"] is None
    monkeypatch.setenv("HOROVOD_PEAK_TFLOPS", "50")
    monkeypatch.setenv("HOROVOD_HBM_GBPS", "123")
    assert P.peak_tflops() == R.peak_tflops() == 50.0
    assert P.hbm_gbps() == R.hbm_gbps() == 123.0
    assert P.peak_tflops("NVIDIA H100 80GB HBM3") == 50.0


# ---------------------------------------------------------------------------
# describe
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_ARRAYS = {
    "f32": _RNG.standard_normal((8, 3)).astype(np.float32),
    "i32": _RNG.integers(0, 9, (4,)).astype(np.int32),
    "f32_3d": _RNG.standard_normal((2, 1, 5)).astype(np.float32),
    "scalar0d": np.asarray(3.0, np.float32),
}


@pytest.mark.parametrize("key", sorted(_ARRAYS))
def test_describe_arrays_and_tensors_as_reference(key):
    a = _ARRAYS[key]
    want = R.describe(jnp.asarray(a))
    assert R.describe(a) == want
    assert P.describe(a) == want
    assert P.describe(torch.from_numpy(a.copy())) == want


@pytest.mark.parametrize("v", [3, 7.5, True, 2j, None, "tokens", b"x"])
def test_describe_scalars_as_reference(v):
    assert P.describe(v) == R.describe(v)


_TREES = {
    "tuple2": lambda f: (f(_ARRAYS["f32"]), f(_ARRAYS["i32"])),
    "list3": lambda f: [f(_ARRAYS["f32"]), f(_ARRAYS["i32"]),
                        f(_ARRAYS["f32_3d"])],
    "dict_sorted": lambda f: {"a": f(_ARRAYS["f32"]), "b": f(_ARRAYS["i32"])},
    "nested4": lambda f: ((f(_ARRAYS["f32"]), [f(_ARRAYS["i32"])]),
                          {"w": f(_ARRAYS["f32_3d"]),
                           "z": f(_ARRAYS["scalar0d"])}),
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_describe_small_trees_as_reference(name):
    make = _TREES[name]
    assert P.describe(make(lambda a: torch.from_numpy(a.copy()))) == \
        R.describe(make(jnp.asarray))


def test_large_trees_and_modules_digest_stably_and_shape_sensitively():
    def tree(n):
        return {f"w{i}": torch.zeros(n, 2) for i in range(6)}
    assert P.describe(tree(3)) == P.describe(tree(3))
    assert P.describe(tree(3)) != P.describe(tree(4))
    assert P.describe(tree(3)).startswith("tree[6 leaves]:")
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    assert P.describe(a) == P.describe(b)
    assert P.describe(a).startswith("module[2 params]:")
    assert P.describe(a) != P.describe(torch.nn.Linear(4, 5))
    assert P.describe(a) != P.describe(a.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

_SEQUENCES = {
    "blame": [({"x": "f32[2]", "k": "2"}, {}),
              ({"x": "f32[2]", "k": "2"}, {}),
              ({"x": "f32[4]", "k": "3"}, {})],
    "added_removed": [({"x": "a"}, {}), ({"y": "b"}, {})],
    "alternating": ([({"x": "f32[128]"}, {}), ({"x": "f32[64]"}, {})]
                    + [({"x": "f32[128]"}, {}), ({"x": "f32[64]"}, {})] * 3
                    + [({"x": "f32[32]"}, {})]),
    "expected": [({"t": "1"}, {"expected": True}),
                 ({"t": "2"}, {"expected": True}),
                 ({"t": "1"}, {"expected": True})],
    "reanchor": [({"x": "f32[2]"}, {}), ({"x": "f32[4]"}, {}), "reanchor",
                 ({"x": "f32[8]"}, {}), ({"x": "f32[2]"}, {})],
}


@pytest.mark.parametrize("name", sorted(_SEQUENCES))
def test_note_trace_sequences_as_reference(name):
    got = {}
    for side, reg, met in (("port", P.registry, PM), ("ref", R.registry, RM)):
        out = []
        for item in _SEQUENCES[name]:
            if item == "reanchor":
                reg.reanchor()
                continue
            sig, kw = item
            out.append(reg.note_trace("prog", sig, **kw))
        reg.count_trace("prog", chunks=4)
        snap = met.snapshot()
        got[side] = (out, reg.snapshot(), {
            fam: _family(snap, "counters", fam)
            for fam in ("program_compiles_total", "recompiles_total",
                        "expected_recompiles_total",
                        "recompile_blame_total")})
    assert got["port"] == got["ref"]


def test_observe_step_gauges_as_reference(monkeypatch):
    monkeypatch.setenv("HOROVOD_PEAK_TFLOPS", "1.0")
    monkeypatch.setenv("HOROVOD_HBM_GBPS", "1.0")
    snaps = {}
    for side, reg, met in (("port", P.registry, PM), ("ref", R.registry, RM)):
        rec = reg.program("p")
        rec.flops, rec.model_flops, rec.bytes_accessed = 1e9, 5e8, 1e6
        reg.observe_step("p", 0.001)
        reg.observe_step("p", 0.002)
        snap = met.snapshot()
        snaps[side] = (reg.snapshot(), {
            fam: _family(snap, "gauges", fam)
            for fam in ("program_hfu", "program_mfu",
                        "hbm_bandwidth_utilization")})
    assert snaps["port"] == snaps["ref"]
    assert _gauge("program_hfu", program="p") == pytest.approx(0.5)


def test_bytes_zero_writes_no_bandwidth_gauge(monkeypatch):
    """A cost capture has no bytes, so observe_step writes hfu / mfu and
    no ``hbm_bandwidth_utilization`` (as the reference does for 0)."""
    monkeypatch.setenv("HOROVOD_PEAK_TFLOPS", "1.0")
    monkeypatch.setenv("HOROVOD_HBM_GBPS", "1.0")
    P.record_cost("p", {"flops": 1e9, "peak_hbm_bytes": 10.0})
    P.observe_step("p", 0.001)
    assert _gauge("program_hfu", program="p") == pytest.approx(1.0)
    assert _gauge("hbm_bandwidth_utilization", program="p") is None


class _FakeMem:
    argument_size_in_bytes = 600.0
    output_size_in_bytes = 200.0
    temp_size_in_bytes = 200.0
    alias_size_in_bytes = 0.0


class _FakeCompiled:
    def cost_analysis(self):
        return {"flops": 1000.0, "bytes accessed": 400.0}

    def memory_analysis(self):
        return _FakeMem()


@pytest.mark.parametrize("deg", [1, 2, 4])
def test_mp_degree_divides_as_reference(deg):
    cost = {"flops": 1000.0, "bytes_accessed": 400.0,
            "peak_hbm_bytes": 1000.0}
    assert P.cost_from(cost) == R.cost_from(_FakeCompiled())
    a = P.record_cost("tp", cost, model_flops=800.0, mp_degree=deg)
    b = R.record_cost("tp", _FakeCompiled(), model_flops=800.0,
                      mp_degree=deg)
    assert a.snapshot() == b.snapshot()
    assert a.flops == 1000.0 / deg and a.peak_hbm_bytes == 1000.0 / deg
    assert _gauge("program_flops", program="tp") == 1000.0 / deg


# ---------------------------------------------------------------------------
# the cost capture
# ---------------------------------------------------------------------------

_X = _RNG.standard_normal((64, 128)).astype(np.float32)
_W1 = _RNG.standard_normal((128, 256)).astype(np.float32)
_W2 = _RNG.standard_normal((256, 32)).astype(np.float32)


def test_captured_flops_equal_xla_cost_analysis():
    def f(x, w1, w2):
        return jnp.tanh(x @ w1) @ w2
    xla = jax.jit(f).lower(_X, _W1, _W2).compile().cost_analysis()
    if isinstance(xla, (list, tuple)):
        xla = xla[0]
    t = [torch.from_numpy(a.copy()) for a in (_X, _W1, _W2)]
    with P.CostCapture() as cap:
        out = torch.tanh(t[0] @ t[1]) @ t[2]
    assert cap.flops == xla["flops"] == 5242880
    assert cap.cost() == {"flops": 5242880.0, "bytes_accessed": 0.0,
                          "peak_hbm_bytes": 0.0}
    np.testing.assert_allclose(out.numpy(), np.asarray(f(_X, _W1, _W2)),
                               rtol=1e-4, atol=1e-3)
    assert FA.flop_tally is None


class _FakeKernel(torch.autograd.Function):
    """Stands in for ``_FlashFn``: the forward and backward feed the tally
    as the wrappers do where a kernel launches."""

    @staticmethod
    def forward(ctx, x):
        if FA.flop_tally is not None:
            FA.flop_tally("flash_fwd", 100)
        return x * 2

    @staticmethod
    def backward(ctx, g):
        if FA.flop_tally is not None:
            FA.flop_tally("flash_bwd_dq", 1000)
            FA.flop_tally("flash_bwd_dkv", 10000)
        return g * 2


def test_kernel_tally_is_added_from_any_thread():
    x = torch.ones(4, 8, requires_grad=True)
    w = torch.ones(8, 8)
    seen = []

    def device_thread():
        # what autograd's device thread does with a CUDA backward
        seen.append(FA.flop_tally is not None)
        FA.flop_tally("flash_bwd_dkv", 5)

    with P.CostCapture() as cap:
        y = _FakeKernel.apply(x @ w)
        y.sum().backward()
        t = threading.Thread(target=device_thread)
        t.start()
        t.join()
    assert seen == [True]
    assert cap.kernel_flops == {"flash_fwd": 100, "flash_bwd_dq": 1000,
                                "flash_bwd_dkv": 10005}
    # 2 * 4 * 8 * 8 forward; the backward's dX product again (w needs none)
    assert cap.dense_flops == 2 * (2 * 4 * 8 * 8)
    assert cap.flops == cap.dense_flops + 11105
    assert FA.flop_tally is None
    _FakeKernel.apply(x).sum().backward()     # no capture: no tally
    assert cap.kernel_flops["flash_fwd"] == 100


def test_nested_captures_both_count():
    with P.CostCapture() as outer:
        with P.CostCapture() as inner:
            FA.flop_tally("flash_fwd", 7)
        FA.flop_tally("flash_fwd", 1)
    assert inner.kernel_flops == {"flash_fwd": 7}
    assert outer.kernel_flops == {"flash_fwd": 8}
    assert FA.flop_tally is None


def _brute_pairs(tq, tk, bh, h, causal, offset, bias, seg_q, seg_k):
    n = 0
    for r in range(bh):
        b = r // h
        for i in range(tq):
            for j in range(tk):
                if causal and j > i + offset:
                    continue
                if bias is not None and bias[b, j] <= -1e29:
                    continue
                if seg_q is not None and seg_q[b, i] != seg_k[b, j]:
                    continue
                n += 1
    return n


def _pair_inputs(tq, tk, bh, h, with_bias, with_seg):
    g = np.random.default_rng(3)
    b = bh // h
    bias = seg_q = seg_k = None
    if with_bias:
        bias = torch.tensor(g.standard_normal((b, tk)), dtype=torch.float32)
        bias[:, -3:] = -1e30
    if with_seg:
        seg_q = torch.tensor(np.sort(g.integers(0, 3, (b, tq)), axis=1),
                             dtype=torch.int32)
        # a ring hop's resident keys carry their own ids
        seg_k = seg_q if tq == tk else torch.tensor(
            np.sort(g.integers(1, 5, (b, tk)), axis=1), dtype=torch.int32)
    return bias, seg_q, seg_k


@pytest.mark.parametrize("case", [
    (16, 16, 4, 2, True, 0, False, False),
    (16, 16, 4, 2, True, -1, False, False),
    (12, 20, 2, 1, False, 0, False, False),
    (16, 16, 4, 2, False, 0, True, False),
    (16, 16, 4, 2, True, 0, False, True),
    (16, 16, 6, 3, True, -1, True, True),
    (12, 20, 4, 2, True, 5, True, True),
    (20, 12, 4, 2, True, -15, False, True),
    (16, 16, 4, 2, True, 40, True, False),
    (16, 16, 4, 2, True, -30, True, True)])
def test_visible_pairs_count_each_launch(case):
    tq, tk, bh, h, causal, offset, with_bias, with_seg = case
    bias, seg_q, seg_k = _pair_inputs(tq, tk, bh, h, with_bias, with_seg)
    assert FA.visible_pairs(tq, tk, bh, h, causal, offset, bias, seg_q,
                            seg_k) == _brute_pairs(tq, tk, bh, h, causal,
                                                   offset, bias, seg_q,
                                                   seg_k)


def test_visible_pairs_make_no_tensor_of_pairs():
    """A masked or packed count inside a cost capture must not raise the
    peak it reads: it builds nothing of (B, Tq, Tk), only rows of its
    (B, T) inputs (on the card, copies of them on the host)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    tq = tk = 64
    bias, seg_q, seg_k = _pair_inputs(tq, tk, 8, 2, True, True)
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            sizes.extend(x.numel() for x in tree_leaves(out)
                         if isinstance(x, torch.Tensor))
            return out

    with Sizes():
        n = FA.visible_pairs(tq, tk, 8, 2, True, 0, bias, seg_q, seg_k)
    assert n == _brute_pairs(tq, tk, 8, 2, True, 0, bias, seg_q, seg_k)
    assert sizes and max(sizes) <= 4 * (tq + tk + 1)


def test_tally_counts_flops_per_pair_by_kernel(monkeypatch):
    got = []
    monkeypatch.setattr(FA, "flop_tally", lambda k, f: got.append((k, f)))
    q = torch.zeros(4, 16, 64)
    for kern in FA.KERNELS:
        FA._tally(kern, q, q, None, None, None, 2, True, 0)
    pairs = 4 * 16 * 17 // 2
    assert got == [("flash_fwd", 4 * 64 * pairs),
                   ("flash_bwd_dq", 6 * 64 * pairs),
                   ("flash_bwd_dkv", 8 * 64 * pairs)]


# ---------------------------------------------------------------------------
# ProfiledStep
# ---------------------------------------------------------------------------

def test_profiled_step_blames_as_reference():
    calls = {"port": 0, "ref": 0}

    def port_fn(x, seq_len):
        calls["port"] += 1
        return x[:seq_len] * 2.0

    def ref_fn(x, seq_len):
        calls["ref"] += 1
        return x[:seq_len] * 2.0

    p = P.instrument(port_fn, name="train_step", static_argnums=(1,))
    r = R.instrument(ref_fn, name="train_step", static_argnums=(1,))
    x = np.arange(8.0, dtype=np.float32)
    for xs, n in ((x, 8), (x, 8), (x, 4), (x[:6], 4), (x, 8)):
        got = p(torch.from_numpy(xs.copy()), n)
        want = r(jnp.asarray(xs), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert p.record().last_blame == r.record().last_blame
        assert p.record().blame_detail == r.record().blame_detail
        assert p.record().recompiles == r.record().recompiles
    assert p.record().last_blame == ["x"]
    assert p.record().blame_detail["x"] == ("float32[8]", "float32[6]")
    assert calls["port"] == 5          # one execution a call, captures too
    snap = PM.snapshot()
    assert _family(snap, "counters", "recompile_blame_total") == _family(
        RM.snapshot(), "counters", "recompile_blame_total")


def test_kwargs_and_modules_are_named_in_the_blame():
    step = P.instrument(lambda model, batch, scale=1.0: model(batch) * scale,
                        name="kw")
    m = torch.nn.Linear(4, 2)
    step(m, torch.zeros(3, 4), scale=2.0)
    step(m, torch.zeros(3, 4), scale=3.0)          # a python scalar: steady
    assert step.record().recompiles == 0
    step(torch.nn.Linear(4, 2).double(), torch.zeros(3, 4).double())
    assert step.record().last_blame == ["batch", "model", "scale"]


def test_cost_captured_once_per_signature_and_not_timed(monkeypatch):
    monkeypatch.setenv("HOROVOD_PEAK_TFLOPS", "1.0")
    calls = []

    def f(a):
        calls.append(1)
        return a @ a

    step = P.instrument(f, name="p3", timed=True, model_flops=lambda a:
                        2.0 * a.shape[0] ** 3)
    step(torch.ones(8, 8))
    rec = step.record()
    assert rec.flops == 2 * 8 ** 3 and rec.model_flops == 2 * 8 ** 3
    assert rec.steps == 0              # the capture call is never timed
    assert step.last_capture.flops == rec.flops
    step(torch.ones(8, 8))
    step(torch.ones(8, 8))
    assert rec.steps == 2 and rec.flops == 2 * 8 ** 3
    step(torch.ones(16, 16))
    assert rec.flops == 2 * 16 ** 3 and rec.steps == 2
    assert len(calls) == 4
    assert _gauge("program_flops", program="p3") == 2 * 16 ** 3
    assert _gauge("program_mfu", program="p3") is not None


def test_capture_cost_env_off(monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILER_COST", "0")
    step = P.ProfiledStep(lambda x: x * 2, name="p6", timed=True)
    step(torch.ones(3))
    step(torch.ones(3))
    rec = P.registry.program("p6")
    assert rec.flops == 0 and rec.steps == 2 and rec.compiles == 1


def test_decorator_and_snapshot_shape():
    @P.instrument(name="p4", timed=True, donate_argnums=(0,))
    def f(x):
        return x + 1
    assert torch.equal(f(torch.ones(3)), torch.full((3,), 2.0))
    f(torch.ones(3))
    rec = P.registry.program("p4")
    assert rec.steps == 1 and rec.last_step_seconds > 0
    snap = P.registry.snapshot()
    assert snap["p4"]["compiles"] == 1 and "utilization" in snap["p4"]
    assert set(snap["p4"]) == set(R.ProgramRecord("x").snapshot()) | {
        "utilization"}


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def test_live_buffer_census_counts_a_kept_tensor():
    keep = torch.ones(1 << 16)            # noqa: F841 -- must stay live
    view = keep[::2]                      # noqa: F841 -- same storage
    census = P.live_buffer_census()
    assert census["cpu"]["bytes"] >= 4 * (1 << 16)
    assert _gauge("device_live_buffer_bytes", platform="cpu") == \
        census["cpu"]["bytes"]
    del view
    assert P.live_buffer_census()["cpu"]["bytes"] == census["cpu"]["bytes"]


def test_check_memory_pressure_cpu_is_none():
    assert P.check_memory_pressure() is None
    assert P.check_memory_pressure(threshold=0.0) is None
    assert _counter("memory_pressure_total") == 0


# ---------------------------------------------------------------------------
# captures
# ---------------------------------------------------------------------------

def _trace_events(logdir):
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert files == [f"trace.{os.getpid()}.json"], files
    with open(os.path.join(logdir, files[0])) as f:
        return json.load(f)["traceEvents"]


def test_profile_writes_a_chrome_trace(tmp_path):
    with P.profile(str(tmp_path / "cap")) as logdir:
        torch.ones(64).mul(2).sum()
    names = {e.get("name") for e in _trace_events(logdir)}
    assert "aten::mul" in names
    assert not P._PROFILE_ACTIVE


def test_profile_refuses_nesting(tmp_path):
    with P.profile(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="already active"):
            with P.profile(str(tmp_path / "b")):
                pass
    assert not P._PROFILE_ACTIVE


def test_profile_failed_start_releases_flag(tmp_path, monkeypatch):
    def boom(self):
        raise RuntimeError("profiler busy")
    monkeypatch.setattr(P._Session, "start", boom)
    with pytest.raises(RuntimeError, match="profiler busy"):
        with P.profile(str(tmp_path / "x")):
            pass
    assert not P._PROFILE_ACTIVE
    assert P.trigger_profile("fails", seconds=0.1) is None
    assert P.profile_capture_count() == 0          # not charged
    monkeypatch.undo()
    with P.profile(str(tmp_path / "y")) as logdir:
        torch.ones(2) + 1
    assert _trace_events(logdir)


def _wait_idle(deadline_s=20.0):
    """Train on: the training thread's polls stop a triggered capture."""
    deadline = time.monotonic() + deadline_s
    while P._PROFILE_ACTIVE and time.monotonic() < deadline:
        P.poll()
        time.sleep(0.02)
    assert not P._PROFILE_ACTIVE


def test_trigger_profile_bounded(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_PROFILE_MAX_CAPTURES", "2")
    config.refresh()
    before = P.profile_capture_count()
    d = P.trigger_profile("test_reason", seconds=0.2)
    assert d is not None and d.startswith(str(tmp_path))
    assert P.trigger_profile("again") is None          # one at a time
    _wait_idle()
    assert _trace_events(d) is not None
    d2 = P.trigger_profile("second", seconds=0.05)
    assert d2 is not None
    _wait_idle()
    assert P.trigger_profile("third", seconds=0.05) is None   # budget spent
    assert P.profile_capture_count() == before + 2
    assert _counter("profile_capture_total") == 2


def test_stall_capture_runs_on_the_training_thread(tmp_path, monkeypatch):
    """A trigger fired on another thread (the watchdog's) waits for the
    training thread's next poll: its session starts and stops there and
    records that thread's ops; polls on other threads do nothing."""
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    config.refresh()
    got = []
    fire = threading.Thread(target=lambda: got.append(
        P.trigger_profile("watchdog", seconds=0.3)))
    fire.start()
    fire.join()
    d = got[0]
    assert d is not None and P._PROFILE_ACTIVE
    assert P.trigger_profile("again") is None           # one at a time
    assert _counter("profile_capture_total") == 0       # not started yet
    other = threading.Thread(target=P.poll)
    other.start()
    other.join()
    assert P._TRIGGER.session is None
    x = torch.ones(256)
    while P._PROFILE_ACTIVE:
        P.poll()
        x = torch.tanh(x) + 0.5
        time.sleep(0.005)
    assert _counter("profile_capture_total") == 1
    ops = [e for e in _trace_events(d) if e.get("name") == "aten::tanh"]
    assert ops and {e["tid"] for e in ops} == {threading.get_native_id()}


def test_instrumented_steps_and_the_optimizer_poll(tmp_path, monkeypatch,
                                                  world):
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    config.refresh()
    step = P.instrument(lambda x: x * 2, name="polled")
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        [torch.nn.Parameter(torch.ones(2))], lr=0.1))
    for run in (lambda: step(torch.ones(2)), opt.step):
        fire = threading.Thread(target=P.trigger_profile,
                                args=("polled",), kwargs={"seconds": 0.0})
        fire.start()
        fire.join()
        run()                                           # starts it
        assert P._TRIGGER is not None and P._TRIGGER.session is not None
        run()                                           # its time is up
        assert not P._PROFILE_ACTIVE and P._TRIGGER is None


def test_manual_profile_preempts_background_trigger(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    config.refresh()
    d = P.trigger_profile("bg", seconds=30.0)
    assert d is not None
    t0 = time.monotonic()
    with P.profile(str(tmp_path / "manual")) as logdir:
        torch.ones(2) + 1
        assert P._PROFILE_ACTIVE and P._PROFILE_SOURCE == "manual"
    assert time.monotonic() - t0 < 20          # the 30 s trigger stopped
    assert not P._PROFILE_ACTIVE
    assert _trace_events(d) is not None and _trace_events(logdir)
    assert P._TRIGGER is None
    with P.profile(str(tmp_path / "again")):
        pass


def test_maybe_trigger_gated_on_knob(tmp_path, monkeypatch):
    assert P.maybe_trigger("off") is None
    assert P.profile_capture_count() == 0
    monkeypatch.setenv("HOROVOD_PROFILE_ON_STALL", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_PROFILE_SECONDS", "0.1")
    config.refresh()
    d = P.maybe_trigger("on")
    assert d is not None and os.path.basename(d).startswith("on.")
    _wait_idle()


def test_timeline_passthroughs_share_the_session(tmp_path):
    from horovod_tpu_torch import timeline
    timeline.start_profiler(str(tmp_path / "tl"))
    try:
        with pytest.raises(RuntimeError, match="already active"):
            timeline.start_profiler(str(tmp_path / "tl2"))
        with pytest.raises(RuntimeError, match="already active"):
            with P.profile(str(tmp_path / "p")):
                pass
        torch.ones(3) * 3
    finally:
        timeline.stop_profiler()
    assert _trace_events(str(tmp_path / "tl"))
    with pytest.raises(RuntimeError, match="no manual"):
        timeline.stop_profiler()


# ---------------------------------------------------------------------------
# wiring
# ---------------------------------------------------------------------------

@pytest.fixture
def world():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_eager_allreduce_registers_once_per_new_shape(world):
    hvd.allreduce(torch.ones(3), name="prof_wire")
    rec = P.registry.get("collective:allreduce")
    assert rec is not None and rec.traces == 1
    hvd.allreduce(torch.ones(3), name="prof_wire2")
    assert rec.traces == 1
    assert _counter("collective_compile_total", kind="allreduce") == 1
    hvd.allreduce(torch.ones(5), name="prof_wire3")
    assert rec.traces == 2
    assert rec.meta["last_bytes"] == 20
    assert _counter("program_compiles_total",
                    program="collective:allreduce") == 2
    hvd.broadcast(torch.ones(5), 0)
    assert P.registry.get("collective:broadcast").traces == 1


def test_reinit_reanchors_and_forgets_seen_signatures(world):
    P.note_trace("step", {"x": "f32[2]"})
    hvd.allreduce(torch.ones(3))
    hvd.shutdown()
    hvd.init(device="cpu")
    assert P.registry.get("step").signature is None
    assert P.note_trace("step", {"x": "f32[4]"})[0] == "compile"
    hvd.allreduce(torch.ones(3))
    assert P.registry.get("collective:allreduce").traces == 2


def test_note_lowering_once_per_geometry_until_init(world):
    from horovod_tpu_torch import overlap
    for _ in range(2):
        overlap._note_lowering("overlap:chunked_rs_ag", (64, 2, 4),
                               chunks=4, chunk_bytes=64, buffer_bytes=256)
    overlap._note_lowering("overlap:chunked_rs_ag", (128, 2, 4), chunks=4,
                           chunk_bytes=128, buffer_bytes=512)
    rec = P.registry.get("overlap:chunked_rs_ag")
    assert rec.traces == 2 and rec.meta["buffer_bytes"] == 512
    hvd.shutdown()
    hvd.init(device="cpu")
    overlap._note_lowering("overlap:chunked_rs_ag", (64, 2, 4), chunks=4)
    assert rec.traces == 3


def test_count_trace_once_per_key_until_reanchor():
    assert P.count_trace_once("collective:x", (1,), last_bytes=4)
    assert not P.count_trace_once("collective:x", (1,), last_bytes=8)
    assert P.count_trace_once("overlap:x", (1,))        # keyed by program
    rec = P.registry.get("collective:x")
    assert rec.traces == 1 and rec.meta == {"last_bytes": 4}
    P.registry.reanchor()
    assert P.count_trace_once("collective:x", (1,), last_bytes=8)
    assert rec.traces == 2 and rec.meta == {"last_bytes": 8}
    P.registry.reset()
    assert P.count_trace_once("collective:x", (1,))
    assert P.registry.get("collective:x").traces == 1


def test_autotuned_step_feeds_registry():
    from horovod_tpu_torch.autotune import BayesianAutotuner

    def make_step(threshold):
        def step(x):
            return x + threshold
        return step

    tuner = BayesianAutotuner(probes=1, samples_per_probe=1)
    astep = hvd.AutotunedStep(make_step, tuner=tuner)
    for _ in range(4):
        astep(torch.ones(2))
    rec = P.registry.get("autotuned_step")
    assert rec is not None and rec.expected_recompiles
    assert rec.steps >= 1
    assert set(rec.signature) == {"fusion_threshold"}


def test_build_info_carries_profile_knobs(monkeypatch):
    info = hvd.build_info()
    assert {"profile_on_stall", "profile_dir", "profiler_cost"} <= set(info)
    assert info["profiler_cost"] is None and info["profile_on_stall"] is \
        False
    monkeypatch.setenv("HOROVOD_PROFILER_COST", "0")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", "/x/y")
    for v, want in (("", 2), ("5", 5)):
        monkeypatch.setenv("HOROVOD_PROFILE_MAX_CAPTURES", v)
        cfg = config.refresh()
        assert cfg.profile_max_captures == want
    assert hvd.build_info()["profiler_cost"] is False
    assert hvd.build_info()["profile_dir"] == "/x/y"
    monkeypatch.setenv("HOROVOD_PROFILE_MAX_CAPTURES", "0")
    with pytest.raises(ValueError, match="HOROVOD_PROFILE_MAX_CAPTURES"):
        config.refresh()
    monkeypatch.delenv("HOROVOD_PROFILE_MAX_CAPTURES")


def test_planted_stall_fires_one_bounded_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_PROFILE_ON_STALL", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_PROFILE_SECONDS", "0.3")
    config.refresh()
    dog = PM.StallWatchdog(timeout_s=0.05)
    tokens = [PM.collective_begin("allreduce", name=f"stuck{i}", nbytes=4)
              for i in range(2)]
    try:
        time.sleep(0.1)
        fired = dog.check_once()          # two stalls: one capture
        assert len(fired) == 2
        assert P.profile_capture_count() == 1
        assert _counter("profile_capture_total") == 1
        dirs = os.listdir(tmp_path)
        assert len(dirs) == 1 and dirs[0].startswith("stall_allreduce_stuck")
        _wait_idle()
        assert _trace_events(str(tmp_path / dirs[0])) is not None
    finally:
        for t in tokens:
            PM.collective_end(t)


# ---------------------------------------------------------------------------
# a training thread that is not the main thread; the stop's hold
# ---------------------------------------------------------------------------

def _train_on_a_thread(opt, param, done, box):
    """A training loop on a thread of its own (as Ray actors and Lightning
    train): ``DistributedOptimizer.step`` each step, until ``done()``."""
    box["tid"] = threading.get_native_id()
    box["steps"] = 0
    deadline = time.monotonic() + 30.0
    while not done() and time.monotonic() < deadline:
        opt.zero_grad()
        torch.tanh(param).sum().backward()
        opt.step()
        box["steps"] += 1
        time.sleep(0.005)


def test_trigger_captures_a_training_thread_off_the_main_thread(
        tmp_path, monkeypatch, world):
    """A stall's trigger, fired from a third thread while a thread that is
    not the main thread trains, starts at that thread's next step: a
    capture directory is written holding that thread's ops, charged once,
    and a later trigger is not refused for a capture that never ran."""
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_PROFILE_ON_STALL", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_SECONDS", "0.3")
    config.refresh()
    param = torch.nn.Parameter(torch.ones(256))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([param], lr=1e-3))
    got, box = [], {}

    def done():
        return bool(got) and got[0] is not None and \
            not P._PROFILE_ACTIVE and box["steps"] > 3

    train = threading.Thread(target=_train_on_a_thread,
                             args=(opt, param, done, box))
    train.start()
    while box.get("steps", 0) < 2:
        time.sleep(0.005)
    fire = threading.Thread(target=lambda: got.append(
        P.maybe_trigger("off_main")))
    fire.start()
    fire.join()
    train.join()
    d = got[0]
    assert d is not None and not P._PROFILE_ACTIVE, \
        f"the capture never ran on the training thread: {d}"
    assert P.profile_capture_count() == 1
    assert _counter("profile_capture_total") == 1
    ops = [e for e in _trace_events(d) if e.get("name") == "aten::tanh"]
    assert ops and {e["tid"] for e in ops} == {box["tid"]}
    assert P.trigger_profile("later", seconds=0.05) is not None
    _wait_idle()


def test_the_stops_hold_raises_no_second_stall_capture_or_bundle(
        tmp_path, monkeypatch, world):
    """A triggered capture's stop holds the training thread (3.1-3.3 s on
    the H100, PERF.md). Stretched to four times a tight watchdog's timeout
    while the watchdog keeps scanning, the hold raises no second stall
    report, no second capture and no second postmortem bundle: the planted
    stall gives exactly one of each, as the reference (whose stop runs on
    a thread of its own) gives."""
    from horovod_tpu_torch import blackbox
    timeout, box_dir = 0.2, tmp_path / "blackbox"
    monkeypatch.setenv("HOROVOD_PROFILE_DIR", str(tmp_path / "profile"))
    monkeypatch.setenv("HOROVOD_PROFILE_ON_STALL", "1")
    monkeypatch.setenv("HOROVOD_PROFILE_SECONDS", "0.3")
    monkeypatch.setenv("HOROVOD_BLACKBOX", "1")
    monkeypatch.setenv("HOROVOD_BLACKBOX_DIR", str(box_dir))
    config.refresh()
    blackbox.reset()
    holds = []
    stop = P._Session.stop

    def held_stop(self):
        t0 = time.monotonic()
        stop(self)
        time.sleep(4 * timeout)
        holds.append(time.monotonic() - t0)

    monkeypatch.setattr(P._Session, "stop", held_stop)
    param = torch.nn.Parameter(torch.ones(256))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([param], lr=1e-3))
    reports, box = [], {}
    after = []

    def done():
        # ten more steps (each with its eager allreduce) after the hold
        if holds and not after:
            after.append(box["steps"])
        return bool(after) and box["steps"] >= after[0] + 10

    dog = PM.StallWatchdog(timeout_s=timeout, poll_s=0.02,
                           on_stall=lambda r: reports.append(r["tensor"]))
    token = PM.collective_begin("allreduce", name="held/stuck", nbytes=4)
    dog.start()
    try:
        train = threading.Thread(target=_train_on_a_thread,
                                 args=(opt, param, done, box))
        train.start()
        train.join()
    finally:
        PM.collective_end(token)
        dog.stop()
    try:
        assert holds and holds[0] >= 4 * timeout
        assert reports == ["held/stuck"]
        assert _counter("stall_events_total") == 1
        assert P.profile_capture_count() == 1
        assert _counter("profile_capture_total") == 1
        bundles = blackbox.find_bundles(str(box_dir))
        assert len(bundles) == 1
        with open(os.path.join(bundles[0], "manifest.json")) as f:
            assert json.load(f)["trigger"] == "stall"
        assert _counter("blackbox_dumps_total", trigger="stall") == 1
    finally:
        blackbox.reset()
