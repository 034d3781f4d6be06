"""Pipelines in horovod_tpu_torch (``parallel/pipeline.py``,
``models/gpt2_pipeline.py``) == the reference's GPipe and 1F1B under
``hvd.spmd`` on the 8-device CPU mesh (``tests/test_pipeline.py``'s
``TestPipeline``, ``TestGPT2Pipeline`` and ``Test1F1B``).

One spawned gloo world of eight ranks, one stage a rank (N 8), runs every
case; the reference runs beside it. The inputs are the reference tests'
own: the MLP's weights and microbatches from its ``rng`` fixture's seed,
the tiny GPT-2's tokens from seed 7 and its weights the reference's init,
carried over with ``gpt2_params_from_jax``.

* The MLP pipeline (stage s: relu(x W_s + b_s)), M 4: ``pipeline_apply``'s
  outputs on every rank and ``pipeline_loss``'s gradients equal the
  reference's (rtol 1e-4, atol 1e-5); 1F1B at M 12 = 4(S - 1): the loss
  (rtol 1e-5), every stage's gradients and stage 0's microbatch
  gradients.
* The stash: at M = 4(S - 1), mb 4, d 128, the peak of the live bytes
  that autograd saves for the backward (weights excluded: their saved
  references are not copies), counted with
  ``torch.autograd.graph.saved_tensors_hooks``, is below GPipe's on every
  stage under 1F1B, and stage s holds at most min(2(S - 1 - s) + 1, M)
  microbatches in flight.
* GPT-2 (8 layers, d 32, fp32) staged over the 8 ranks: GPipe at M 4 and
  1F1B at M 12, the loss (rtol 1e-5, atol 1e-6) and every rank's block
  and ``rest`` gradients (rtol 2e-3, atol 1e-5; 2e-5 under 1F1B) against
  the reference's ``gpt2_pp_loss_and_grad`` and
  ``gpt2_pp_1f1b_loss_and_grad``; the 1F1B head's gradients nonzero on
  the last stage only and the microbatches' on stage 0 only.
* Two planted faults leave the bars: a loss that seeds the backward on
  every stage (a differentiable allreduce of it: 8 times the gradients),
  and ``rest``'s gradients averaged over the line instead of summed.
"""

import functools
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
from jax.sharding import PartitionSpec as JP

import horovod_tpu as jhvd
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import gpt2_pipeline as jgp
from horovod_tpu.parallel import pipeline as jpipe

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import gpt2_pipeline as gp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, MB, D = 8, 4, 2, 16
M1 = 12                        # the reference's 1F1B MLP and GPT-2 M
MS, MBS, DS = 4 * (N - 1), 4, 128   # the stash test's M, mb, d
MLP_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=1e-5)
GRAD_TOL_1F1B = dict(rtol=2e-3, atol=2e-5)


def _mlp(m, d=D, mb=MB, scale=0.3):
    """The reference tests' MLP inputs, drawn as their ``rng`` fixture
    draws them (seed 42): W (N, d, d), b (N, d), x (m, mb, d)."""
    rng = np.random.default_rng(42)
    W = rng.standard_normal((N, d, d)).astype(np.float32) * scale
    b = rng.standard_normal((N, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    return W, b, x


def _tokens(m):
    return np.random.default_rng(7).integers(0, 128, (m, MB, 16)) \
        .astype(np.int32)


def _gpt2_cfg():
    return jgpt2.GPT2Config(vocab_size=128, max_seq_len=32, num_layers=N,
                            num_heads=2, d_model=32, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jparams():
    """The reference's init of the tiny GPT-2 (``PRNGKey(0)``)."""
    model = jgpt2.GPT2(_gpt2_cfg())
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(_tokens(M).reshape(-1, 16)))
    return jax.tree_util.tree_map(np.asarray, params["params"])


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    from horovod_tpu_torch.models.gpt2 import GPT2Config
    from horovod_tpu_torch.parallel import pipeline as pl

    base = sys.argv[2]
    hvd.init(device="cpu")
    r, S = hvd.rank(), hvd.size()
    out, info = {}, {}
    data = dict(np.load(base + ".inputs.npz"))
    T = lambda k: torch.tensor(data[k])

    # The transport: a Line is the global set's Ring with its ends open.
    from horovod_tpu_torch.ops.ring_attention import Ring
    line, ring = pl.Line(), Ring.of()
    info["line"] = [line.prev, line.next, isinstance(line, Ring),
                    pl.Line.of(line) is line, Ring.of(ring) is ring,
                    ring.prev, ring.next]

    def stage_fn(p, h):
        return torch.relu(h @ p[0] + p[1])

    def mse(o):
        return (o ** 2).mean()

    # The MLP: pipeline_apply, pipeline_loss's gradients, 1F1B.
    W, b, x = T("W"), T("b"), T("x")
    calls = []

    def counted(p, h):
        calls.append(1)
        return stage_fn(p, h)

    out["apply"] = pl.pipeline_apply(counted, (W[r], b[r]), x).numpy()
    info["apply_calls"] = len(calls)
    with torch.no_grad():
        out["apply_no_grad"] = pl.pipeline_apply(stage_fn, (W[r], b[r]),
                                                 x).numpy()
    Wl, bl = W[r].clone().requires_grad_(), b[r].clone().requires_grad_()
    loss = pl.pipeline_loss(stage_fn, (Wl, bl), x, mse)
    loss.backward()
    info["mlp_loss"] = loss.item()
    out["mlp_gW"], out["mlp_gb"] = Wl.grad.numpy(), bl.grad.numpy()
    W, b, x = T("W12"), T("b12"), T("x12")
    calls.clear()
    core = pl.pipeline_1f1b(counted, lambda lp, y, m: mse(y))
    loss, (g, _, gx) = core((W[r], b[r]), {}, x)
    info["1f1b_calls"] = len(calls)
    info["mlp1f1b_loss"], info["mlp1f1b_in_flight"] = loss.item(), \\
        core.peak_in_flight
    out["mlp1f1b_gW"], out["mlp1f1b_gb"], out["mlp1f1b_gx"] = (
        g[0].numpy(), g[1].numpy(), gx.numpy())

    # The stash: live bytes saved for the backward, weights excluded.
    class Held:
        def __init__(self, t, meter):
            self.t, self.meter = t, meter
            self.n = t.numel() * t.element_size()
            meter.live += self.n
            meter.peak = max(meter.peak, meter.live)

        def __del__(self):
            self.meter.live -= self.n

    class Meter:
        def __init__(self, weights):
            self.live = self.peak = 0
            self.skip = {w.untyped_storage().data_ptr() for w in weights}

        def pack(self, t):
            if t.untyped_storage().data_ptr() in self.skip:
                return t
            return Held(t, self)

        def unpack(self, h):
            return h.t if isinstance(h, Held) else h

    W, b, x = T("Ws"), T("bs"), T("xs")
    for name in ("gpipe", "1f1b"):
        meter = Meter([W, b])
        with torch.autograd.graph.saved_tensors_hooks(meter.pack,
                                                      meter.unpack):
            if name == "gpipe":
                Wl = W[r].clone().requires_grad_()
                meter.skip.add(Wl.untyped_storage().data_ptr())
                pl.pipeline_loss(stage_fn, (Wl, b[r]), x, mse).backward()
                g = Wl.grad
            else:
                core = pl.pipeline_1f1b(stage_fn, lambda lp, y, m: mse(y))
                g = core((W[r], b[r]), {}, x)[1][0][0]
                info["stash_in_flight"] = core.peak_in_flight
        info[f"stash_{name}_peak"] = meter.peak
        info[f"stash_{name}_live_after"] = meter.live
        out[f"stash_{name}_gW"] = g.numpy()

    # GPT-2 staged over the eight ranks: GPipe at M 4, 1F1B at M 12.
    cfg = GPT2Config(vocab_size=128, max_seq_len=32, num_layers=8,
                     num_heads=2, d_model=32, dtype=torch.float32)
    params = {k[len("p:"):]: torch.tensor(v) for k, v in data.items()
              if k.startswith("p:")}
    blocks, rest = gp.stack_block_params(params, S)
    local = {k: v[r:r + 1] for k, v in blocks.items()}

    def save(tag, loss, gb, gr):
        info[f"{tag}_loss"] = float(loss)
        for k, v in gb.items():
            out[f"{tag}:blocks:{k}"] = v.numpy()
        for k, v in gr.items():
            out[f"{tag}:rest:{k}"] = v.numpy()

    save("gpipe", *gp.gpt2_pp_loss_and_grad(cfg)(local, rest, T("tok4")))
    step = gp.gpt2_pp_1f1b_loss_and_grad(cfg)
    save("1f1b", *step(local, rest, T("tok12")))
    info["gpt2_1f1b_in_flight"] = step.core.peak_in_flight

    # The 1F1B core's contract: the head's gradients on the last stage,
    # the microbatches' on stage 0.
    tok = T("tok12")
    core = pl.pipeline_1f1b(gp._stage_fn(cfg), lambda lp, y, m:
                            gp._head_loss(cfg, lp, y, tok[m]))
    x = gp._first_stage_input(cfg, rest, tok, core.line).detach()
    _, (_, g_head, g_x) = core(gp._local(local), rest, x)
    info["head_grad_nonzero"] = any(bool(g.abs().sum() > 0)
                                    for g in g_head.values())
    info["mb_grad_nonzero"] = bool(g_x.abs().sum() > 0)

    # Planted: the loss seeds the backward on every stage.
    from torch.distributed.nn.functional import all_reduce
    graft = pl._graft_last_stage_loss
    pl._graft_last_stage_loss = lambda local, line: all_reduce(
        local, group=line.group)
    save("seeded", *gp.gpt2_pp_loss_and_grad(cfg)(local, rest, T("tok4")))
    pl._graft_last_stage_loss = graft

    # Planted: rest's gradients averaged over the line.
    class AveragingLine(pl.Line):
        def psum(self, x):
            return super().psum(x) / self.n

    save("averaged", *gp.gpt2_pp_loss_and_grad(cfg, AveragingLine())(
        local, rest, T("tok4")))

    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


def _stage_fn(params, x):
    W, b = params
    return jax.nn.relu(x @ W + b)


def _spmd(body, out_specs):
    return jhvd.spmd(body, in_specs=(JP("hvd"), JP("hvd"), JP()),
                     out_specs=out_specs)


def _port_stack(jblocks, jrest):
    """The reference's (S, K, ...) block tree and rest in the port's
    stacked layout (names, (out, in) weights)."""
    flat = {}
    for path, a in convert.flatten_tree(jblocks).items():
        a = np.asarray(a)
        k_ = a.shape[1]
        for s in range(a.shape[0]):
            for k in range(k_):
                flat[f"h{s * k_ + k}/{path}"] = a[s, k]
    flat.update(convert.flatten_tree(jrest))
    return gp.stack_block_params(convert.gpt2_params_from_jax(flat), N)


def _reference():
    """The reference's results of every case: {name: value}."""
    ref = {}
    W, b, x = (jnp.asarray(a) for a in _mlp(M))
    ref["apply"] = np.asarray(_spmd(
        lambda W, b, x: jpipe.pipeline_apply(_stage_fn, (W[0], b[0]), x,
                                             axis_name="hvd"),
        JP())(W, b, x))

    def body(W, b, x):
        def loss(Wl, bl):
            return jpipe.pipeline_loss(_stage_fn, (Wl, bl), x,
                                       lambda out: jnp.mean(out ** 2),
                                       axis_name="hvd")
        l, (gW, gb) = jax.value_and_grad(loss, argnums=(0, 1))(W[0], b[0])
        return l, gW[None], gb[None]

    ref["mlp"] = [np.asarray(a) for a in _spmd(
        body, (JP(), JP("hvd"), JP("hvd")))(W, b, x)]

    W, b, x = (jnp.asarray(a) for a in _mlp(M1))
    core = jpipe.pipeline_1f1b(_stage_fn, lambda lp, y, m: jnp.mean(y ** 2),
                               "hvd")

    def body(W, b, x):
        loss, (g, _, gx) = core((W[0], b[0]), {}, x)
        return loss, g[0][None], g[1][None], gx

    ref["mlp_1f1b"] = [np.asarray(a) for a in _spmd(
        body, (JP(), JP("hvd"), JP("hvd"), JP()))(W, b, x)]

    cfg = _gpt2_cfg()
    blocks, rest = jgp.stack_block_params(_jparams(), N)
    for tag, step, m in (
            ("gpipe", jgp.gpt2_pp_loss_and_grad(cfg, axis_name="hvd"), M),
            ("1f1b", jgp.gpt2_pp_1f1b_loss_and_grad(cfg, axis_name="hvd"),
             M1)):
        fn = jhvd.spmd(step, in_specs=(JP("hvd"), JP(), JP()),
                       out_specs=(JP(), JP("hvd"), JP()))
        loss, g_blocks, g_rest = fn(blocks, rest, jnp.asarray(_tokens(m)))
        ref[tag] = (float(loss),) + _port_stack(g_blocks, g_rest)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight-rank world (started first, run beside the reference) and
    the reference: (ranks [(arrays, info)], reference)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {}
    for tag, (m, mb, d, scale) in (("", (M, MB, D, 0.3)),
                                   ("12", (M1, MB, D, 0.3)),
                                   ("s", (MS, MBS, DS, 0.1))):
        inputs["W" + tag], inputs["b" + tag], inputs["x" + tag] = _mlp(
            m, d, mb, scale)
    inputs["tok4"], inputs["tok12"] = _tokens(M), _tokens(M1)
    for k, v in convert.gpt2_params_from_jax(_jparams()).items():
        inputs["p:" + k] = v.numpy()
    np.savez(tmp / "w.inputs.npz", **inputs)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(N),
         "--timeout", "200", str(script), REPO, str(tmp / "w")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reference = _reference()
    _, err = proc.communicate(timeout=260)
    assert proc.returncode == 0, err[-4000:]
    ranks = [(dict(np.load(tmp / f"w.rank{r}.npz")),
              json.load(open(tmp / f"w.rank{r}.json"))) for r in range(N)]
    return ranks, reference


def _sequential(W, b, x):
    for s in range(N):
        x = np.maximum(x @ W[s] + b[s], 0.0)
    return x


def test_pipeline_apply_matches_reference_on_every_stage(runs):
    ranks, ref = runs
    W, b, x = _mlp(M)
    np.testing.assert_allclose(ref["apply"], _sequential(W, b, x),
                               **MLP_TOL)
    for arrs, _ in ranks:
        np.testing.assert_allclose(arrs["apply"], ref["apply"], **MLP_TOL)


def test_line_is_a_ring_with_open_ends(runs):
    """Stage r's neighbours are r - 1 and r + 1, None past the ends, where
    the global set's ring wraps; ``of`` takes either as it is."""
    ranks, _ = runs
    for r, (_, info) in enumerate(ranks):
        prev, nxt, is_ring, line_of, ring_of, rprev, rnext = info["line"]
        assert (prev, nxt) == (r - 1 if r > 0 else None,
                               r + 1 if r < N - 1 else None)
        assert (rprev, rnext) == ((r - 1) % N, (r + 1) % N)
        assert is_ring and line_of and ring_of


def test_idle_ticks_run_no_stage(runs):
    """Each stage runs ``stage_fn`` once a microbatch, not once a tick (the
    reference's SPMD program runs it on zeros in the M + S - 1 - M idle
    ticks), with and without a graph."""
    ranks, _ = runs
    for arrs, info in ranks:
        assert info["apply_calls"] == M and info["1f1b_calls"] == M1
        np.testing.assert_array_equal(arrs["apply_no_grad"], arrs["apply"])


def test_backward_through_pipeline_matches_reference(runs):
    ranks, ref = runs
    loss, gW, gb = ref["mlp"]
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info["mlp_loss"], loss, **LOSS_TOL)
        np.testing.assert_allclose(arrs["mlp_gW"], gW[r], **MLP_TOL)
        np.testing.assert_allclose(arrs["mlp_gb"], gb[r], **MLP_TOL)


def test_1f1b_matches_reference(runs):
    ranks, ref = runs
    loss, gW, gb, gx = ref["mlp_1f1b"]
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info["mlp1f1b_loss"], loss, rtol=1e-5)
        assert info["mlp1f1b_in_flight"] == min(2 * (N - 1 - r) + 1, M1)
        np.testing.assert_allclose(arrs["mlp1f1b_gW"], gW[r], **MLP_TOL)
        np.testing.assert_allclose(arrs["mlp1f1b_gb"], gb[r], **MLP_TOL)
        # The microbatches' cotangents are stage 0's, zeros elsewhere.
        if r == 0:
            np.testing.assert_allclose(arrs["mlp1f1b_gx"], gx, **MLP_TOL)
        else:
            assert not arrs["mlp1f1b_gx"].any()


@pytest.mark.parametrize("stage", range(N))
def test_stash_below_gpipe_and_bounded(runs, stage):
    ranks, _ = runs
    arrs, info = ranks[stage]
    bound = min(2 * (N - 1 - stage) + 1, MS)
    assert info["stash_in_flight"] == bound
    assert 0 < info["stash_1f1b_peak"] < info["stash_gpipe_peak"], info
    assert info["stash_1f1b_live_after"] == info["stash_gpipe_live_after"] \
        == 0
    np.testing.assert_allclose(arrs["stash_1f1b_gW"], arrs["stash_gpipe_gW"],
                               **MLP_TOL)


def _check_gpt2(ranks, tag, want, grad_tol):
    loss, blocks, rest = want
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info[f"{tag}_loss"], loss, **LOSS_TOL)
        for k, v in blocks.items():
            np.testing.assert_allclose(arrs[f"{tag}:blocks:{k}"],
                                       v[r:r + 1].numpy(),
                                       err_msg=f"rank {r} {k}", **grad_tol)
        for k, v in rest.items():
            np.testing.assert_allclose(arrs[f"{tag}:rest:{k}"], v.numpy(),
                                       err_msg=f"rank {r} {k}", **grad_tol)


def test_gpt2_gpipe_matches_reference(runs):
    ranks, ref = runs
    _check_gpt2(ranks, "gpipe", ref["gpipe"], GRAD_TOL)


def test_gpt2_1f1b_matches_reference(runs):
    ranks, ref = runs
    _check_gpt2(ranks, "1f1b", ref["1f1b"], GRAD_TOL_1F1B)


def test_gpt2_1f1b_stash_and_gradient_contract(runs):
    ranks, _ = runs
    for s, (_, info) in enumerate(ranks):
        assert info["gpt2_1f1b_in_flight"] == min(2 * (N - 1 - s) + 1, M1)
        assert info["head_grad_nonzero"] == (s == N - 1)
        assert info["mb_grad_nonzero"] == (s == 0)


def test_planted_loss_seeded_on_every_stage_fails(runs):
    ranks, ref = runs
    _, blocks, _ = ref["gpipe"]
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info["seeded_loss"], ref["gpipe"][0],
                                   **LOSS_TOL)
        for k, v in blocks.items():
            got, want = arrs[f"seeded:blocks:{k}"], v[r:r + 1].numpy()
            if np.abs(want).max() > 1e-3:
                # Every stage's unit cotangent reaches the last stage.
                np.testing.assert_allclose(got, N * want, rtol=1e-3,
                                           atol=1e-5)
                assert not np.allclose(got, want, **GRAD_TOL), k


def test_planted_averaged_rest_fails(runs):
    ranks, ref = runs
    _, blocks, rest = ref["gpipe"]
    for r, (arrs, _) in enumerate(ranks):
        for k, v in blocks.items():
            np.testing.assert_allclose(arrs[f"averaged:blocks:{k}"],
                                       v[r:r + 1].numpy(), **GRAD_TOL)
        for k, v in rest.items():
            got = arrs[f"averaged:rest:{k}"]
            np.testing.assert_allclose(got * N, v.numpy(), **GRAD_TOL)
            assert not np.allclose(got, v.numpy(), **GRAD_TOL), k


def test_stacking_is_lossless_and_refuses_as_reference():
    params = convert.gpt2_params_from_jax(_jparams())
    blocks, rest = gp.stack_block_params(params, 4)
    assert set(rest) == {"wte", "wpe", "ln_f.weight", "ln_f.bias"}
    for name, v in blocks.items():
        assert v.shape[:2] == (4, 2)
        for i in range(N):
            assert torch.equal(v[i // 2, i % 2], params[f"h.{i}.{name}"])
    # The reference's stack, transposed, is the port's.
    jblocks, _ = jgp.stack_block_params(_jparams(), 4)
    want = convert.gpt2_params_from_jax(
        {f"h0/{k}": np.asarray(v)[1, 0]
         for k, v in convert.flatten_tree(jblocks).items()})
    for k, v in want.items():
        assert torch.equal(blocks[k[len("h.0."):]][1, 0], v), k
    with pytest.raises(ValueError) as port:
        gp.stack_block_params(params, 3)
    with pytest.raises(ValueError) as ref:
        jgp.stack_block_params(_jparams(), 3)
    assert str(port.value) == str(ref.value)


def test_line_refuses_hops_off_its_ends_and_shape_changes():
    from horovod_tpu_torch.parallel.pipeline import Line, _apply_stage
    line = Line.__new__(Line)
    line.n, line.rank, line.prev, line.next = 2, 1, 0, None
    assert Line.of(line) is line
    x = torch.zeros(2)
    for kw in ({"fwd": x}, {"recv_bwd": x}):
        with pytest.raises(ValueError, match="last stage"):
            line.exchange(**kw)
    line.rank, line.prev, line.next = 0, None, 1
    for kw in ({"bwd": x}, {"recv_fwd": x}):
        with pytest.raises(ValueError, match="stage 0"):
            line.exchange(**kw)
    with pytest.raises(ValueError, match="shape and dtype"):
        _apply_stage(lambda p, h: h[:1], None, x)
    with pytest.raises(ValueError, match="shape and dtype"):
        _apply_stage(lambda p, h: h.double(), None, x)
