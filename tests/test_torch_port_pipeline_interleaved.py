"""The interleaved pipelines of horovod_tpu_torch (``parallel/schedule_sim.py``,
``pipeline_loss_interleaved``, ``pipeline_interleaved_1f1b``,
``chunkable_loss`` and GPT-2's interleaved steps in
``models/gpt2_pipeline.py``) == the reference's (``tests/test_pipeline.py``'s
``TestInterleavedPipeline``, ``TestGPT2InterleavedPipeline``,
``TestInterleaved1F1B``, ``TestInterleavedChunking``, the interleaved pp x
tp cases and the dryrun's interleaved steps, ``__graft_entry__.py:199-245``).

* The schedule tables of ``build_interleaved_1f1b`` are the reference's bit
  for bit at S in {1, 2, 3, 4, 8}, R in {1, 2, 3}, M in {S, 2S, 3S}, and
  so are its errors; a simulator whose wrap hop keeps the round instead of
  raising it fails its own verification.
* One spawned gloo world of eight ranks, one stage a rank, runs beside the
  reference, with the reference tests' inputs (their ``rng`` fixture's
  seed 42, R = 2, the GPT-2 tokens' seeds and ``PRNGKey`` inits, carried
  over with ``gpt2_params_from_jax``): the MLP under
  ``pipeline_loss_interleaved`` at M = S and chunked at M = 2S (loss rtol
  1e-5, gradients rtol 1e-3, atol 1e-5), with a ``chunkable_loss``-marked
  opaque loss; ``pipeline_interleaved_1f1b`` at M = S and 2S, the
  microbatches' gradients included (rtol 2e-3, atol 1e-5); GPT-2 (16
  layers = R x 8 stages, d 32, fp32) interleaved GPipe, chunked and
  interleaved 1F1B and the dryrun's two steps, every rank's block and
  ``rest`` gradients (loss rtol 1e-5, atol 1e-6; gradients rtol 2e-3, atol
  2e-5); pp 4 x tp 2 interleaved GPipe and 1F1B on a port ``Mesh``; S = 2
  on four two-rank lines and S = 1 on eight one-rank lines, against the
  reference on two and one devices. The refusals (a unary loss or one
  whose second positional is not ``mb_start`` at M > S, leaves without
  the rounds axis, M % S) are the reference's.
* Each rank's ``peak_in_flight`` is its row's live peak in the tables, and
  the live bytes saved for the backward stay below interleaved GPipe's at
  M = 2S (``saved_tensors_hooks``, weights excluded).
* Planted faults leave the bars: the wrap edge delivering the previous
  microbatch's activation, and one rank of each two-rank line posting its
  backward hop before its forward one.
"""

import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import horovod_tpu as jhvd
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import gpt2_pipeline as jgp
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu.parallel import schedule_sim as jss
from horovod_tpu.utils.compat import shard_map as jshard_map

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models import gpt2_pipeline as gp
from horovod_tpu_torch.parallel import pipeline as pl
from horovod_tpu_torch.parallel import schedule_sim as ss
from horovod_tpu_torch.parallel.mesh import Mesh
from horovod_tpu_torch.parallel.sharding import _local_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, R, MB, D = 8, 2, 2, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MLP_TOL = dict(rtol=1e-3, atol=1e-5)
TOL_1F1B = dict(rtol=2e-3, atol=1e-5)
GPT2_TOL = dict(rtol=2e-3, atol=2e-5)
TP_TOL = dict(rtol=2e-3, atol=1e-5)

# The MLP cases: (layers, d, microbatches, mb) drawn as the reference
# tests draw them from their rng fixture (seed 42): W, b, x in that order.
MLP = {"A": (R * N, D, N, MB),          # TestInterleavedPipeline, M = S
       "B": (R * N, D, 2 * N, MB),      # TestInterleavedChunking, M = 2S
       "D1": (R * N, 8, N, MB),         # TestInterleaved1F1B, groups 1
       "D2": (R * N, 8, 2 * N, MB),     # groups 2
       "E": (R * N, 32, 2 * N, 4),      # test_memory_below_interleaved_gpipe
       "S2": (R * 2, 8, 4, MB),         # S = 2: M = 2S on a two-rank line
       "S1": (R * 1, 8, 2, MB)}         # S = 1: M = 2 on a one-rank line
# The GPT-2 cases: (layers, heads, init key, tokens seed, tokens shape).
GPT2 = {"gpipe": (R * N, 2, 0, 11, (N, 1, 16)),
        "chunked": (R * N, 2, 0, 11, (2 * N, 1, 16)),
        "1f1b": (R * N, 2, 0, 29, (N, 1, 16)),
        "dry_gpipe": (R * N, 2, 3, 4, (N, 1, 16)),
        "dry_1f1b": (R * N, 2, 3, 4, (N, 1, 16)),
        "tp_gpipe": (4 * R, 4, 0, 19, (4, 1, 16)),
        "tp_1f1b": (4 * R, 4, 0, 31, (4, 1, 16))}


def _mlp(tag):
    layers, d, m, mb = MLP[tag]
    rng = np.random.default_rng(42)
    W = rng.standard_normal((layers, d, d)).astype(np.float32) * 0.3
    b = rng.standard_normal((layers, d)).astype(np.float32) * 0.1
    x = rng.standard_normal((m, mb, d)).astype(np.float32)
    return W, b, x


def _by_device(a, S):
    """A (R·S, ...) stack of virtual stages as (S, R, ...): device d holds
    virtual stages r·S + d."""
    return np.stack([a[np.arange(R) * S + d] for d in range(S)])


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 128, shape) \
        .astype(np.int32)


def _cfg(layers, heads):
    return jgpt2.GPT2Config(vocab_size=128, max_seq_len=32,
                            num_layers=layers, num_heads=heads, d_model=32,
                            dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jparams(layers, heads, key):
    model = jgpt2.GPT2(_cfg(layers, heads))
    params = jax.jit(model.init)(jax.random.PRNGKey(key),
                                 jnp.zeros((1, 16), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, params["params"])


# ---------------------------------------------------------------------------
# The schedule tables, in this process
# ---------------------------------------------------------------------------

TABLES = ("f_round", "f_mb", "b_round", "b_mb", "send_round", "send_mb",
          "bsend_round", "bsend_mb", "recv_round", "recv_mb", "brecv_round",
          "brecv_mb", "f_slot", "b_slot", "fy_slot", "by_slot")


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rounds", [1, 2, 3])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_tables_equal_reference(S, rounds, groups):
    M = groups * S
    got, want = ss.build_interleaved_1f1b(S, rounds, M), \
        jss.build_interleaved_1f1b(S, rounds, M)
    for k in ("S", "R", "M", "T", "n_slots", "n_y_slots"):
        assert getattr(got, k) == getattr(want, k), k
    for k in TABLES:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert got.stash_slots() == want.stash_slots() == max(got.live_peaks())


@pytest.mark.parametrize("args", [(4, 2, 6), (4, 0, 4), (4, 2, 8, 5)],
                         ids=["m_not_multiple_of_s", "no_rounds",
                              "does_not_converge"])
def test_table_errors_as_reference(args):
    with pytest.raises((ValueError, RuntimeError)) as port:
        ss.build_interleaved_1f1b(*args)
    with pytest.raises((ValueError, RuntimeError)) as ref:
        jss.build_interleaved_1f1b(*args)
    assert type(port.value) is type(ref.value)
    assert str(port.value) == str(ref.value)


def test_wrap_hop_keeping_its_round_fails_verification():
    """A planted simulator whose S - 1 -> 0 hop keeps the round: no table
    it would give reaches a rank."""
    src = inspect.getsource(ss)
    hop = "nr = r if d < S - 1 else r + 1"
    assert src.count(hop) == 1
    bad = types.ModuleType("planted_schedule_sim")
    sys.modules[bad.__name__] = bad     # the dataclass looks its module up
    try:
        exec(compile(src.replace(hop, "nr = r"), "planted", "exec"),
             bad.__dict__)
    finally:
        del sys.modules[bad.__name__]
    for S, rounds, M in ((2, 2, 4), (4, 2, 8), (8, 2, 8)):
        with pytest.raises(RuntimeError):
            bad.build_interleaved_1f1b(S, rounds, M)
        ss.build_interleaved_1f1b(S, rounds, M)


# ---------------------------------------------------------------------------
# Refusals, in this process
# ---------------------------------------------------------------------------

def _fake_ring(n=4, rank=0, wrap=True):
    line = pl.Line.__new__(pl.Line)
    line.n, line.rank, line.wrap = n, rank, wrap
    line.prev, line.next = (rank - 1) % n, (rank + 1) % n
    return line


def _ref_refusal(loss_fn):
    W = np.zeros((N, R, D, D), np.float32)
    b = np.zeros((N, R, D), np.float32)
    x = np.zeros((2 * N, MB, D), np.float32)

    def body(Wd, bd, xx):
        return jpipe.pipeline_loss_interleaved(
            lambda p, h: jax.nn.relu(h @ p[0] + p[1]), (Wd[0], bd[0]), xx,
            loss_fn, axis_name="hvd")

    fn = jhvd.spmd(body, in_specs=(JP("hvd"), JP("hvd"), JP()),
                   out_specs=JP())
    with pytest.raises(ValueError) as err:
        fn(W, b, x)
    return str(err.value)


@pytest.mark.parametrize("loss", ["unary", "weights"])
def test_loss_refusals_as_reference(loss):
    """More microbatches than stages need the two-argument loss; a second
    positional not named ``mb_start`` does not opt in."""
    jloss = (lambda out: jnp.mean(out ** 2)) if loss == "unary" \
        else (lambda out, weights: jnp.mean(weights * out ** 2))
    tloss = (lambda out: (out ** 2).mean()) if loss == "unary" \
        else (lambda out, weights: (weights * out ** 2).mean())
    Wd, bd = torch.zeros(R, D, D), torch.zeros(R, D)
    x = torch.zeros(5, MB, D)
    with pytest.raises(ValueError, match="microbatches") as err:
        pl.pipeline_loss_interleaved(lambda p, h: h, (Wd, bd), x, tloss,
                                     _fake_ring())
    assert "chunkable_loss" in str(err.value) and "mb_start" in str(err.value)
    want = _ref_refusal(jloss).replace("S=8", "S=4").replace("M=16", "M=5")
    assert str(err.value) == want.replace("horovod_tpu.parallel",
                                          "horovod_tpu_torch.parallel")


def test_chunkable_loss_marks_a_partial_and_wraps_a_builtin():
    def loss(outputs, start, scale):
        return scale * outputs.sum() + start

    for mod in (pl, jpipe):
        part = functools.partial(loss, scale=2.0)
        assert not mod._loss_takes_start(part)
        assert mod.chunkable_loss(part) is part
        assert mod._loss_takes_start(part) and part._hvd_mb_start
        wrapped = mod.chunkable_loss(divmod)
        assert wrapped is not divmod and mod._loss_takes_start(wrapped)
        assert wrapped(7, 3) == (2, 1)
        assert wrapped.__doc__ == divmod.__doc__
        assert not hasattr(divmod, "_hvd_mb_start")


def test_interleaved_1f1b_refuses_leaves_without_rounds():
    core = pl.pipeline_interleaved_1f1b(lambda p, h: h, lambda lp, y, m: y,
                                        _fake_ring(), rounds=R)
    with pytest.raises(ValueError, match="rounds"):
        core((torch.zeros(R + 1, D),), {}, torch.zeros(4, MB, D))
    with pytest.raises(ValueError, match="M % S"):
        core((torch.zeros(R, D),), {}, torch.zeros(5, MB, D))


def test_line_wraps_only_when_asked_and_one_stage_hands_over():
    open_line = _fake_ring(wrap=False)
    with pytest.raises(ValueError, match="wrapped"):
        pl.Line.of(open_line, wrap=True)
    ring = _fake_ring()
    assert pl.Line.of(ring, wrap=True) is ring
    with pytest.raises(ValueError, match="wrapped"):
        pl.Line.of(ring)
    one = _fake_ring(n=1)
    x, g = torch.ones(2), torch.zeros(2)
    a, c = one.exchange(fwd=x, bwd=g, recv_fwd=x, recv_bwd=g)
    assert a is x and c is g
    with pytest.raises(ValueError, match="itself"):
        one.exchange(fwd=x)
    # The posting order: sends, then receives, forward before backward.
    posts = _fake_ring(n=2)._posts(x, g, x, g)
    assert [(op.__name__, way) for op, _, _, way in posts] == [
        ("isend", "fwd"), ("isend", "bwd"), ("irecv", "fwd"),
        ("irecv", "bwd")]


def test_interleaved_layouts_are_the_references():
    params = _jparams(16, 2, 0)
    blocks, rest = gp.stack_block_params_interleaved(
        convert.gpt2_params_from_jax(params), 4, 2)
    jblocks, _ = jgp.stack_block_params_interleaved(params, 4, 2)
    flat = convert.flatten_tree(jblocks)
    for d in range(4):
        for r in range(2):
            for k in range(2):
                want = convert.gpt2_params_from_jax(
                    {f"h0/{p}": np.asarray(a)[d, r, k]
                     for p, a in flat.items()})
                for name, v in want.items():
                    assert torch.equal(blocks[name[len("h.0."):]][d, r, k],
                                       v), (d, r, k, name)
    assert set(rest) == {"wte", "wpe", "ln_f.weight", "ln_f.bias"}
    with pytest.raises(ValueError) as port:
        gp.stack_block_params_interleaved(
            convert.gpt2_params_from_jax(params), 3, 2)
    with pytest.raises(ValueError) as ref:
        jgp.stack_block_params_interleaved(params, 3, 2)
    assert str(port.value) == str(ref.value)
    # The head-major layout and its specs: the rounds axis whole.
    tb, _ = gp.make_pp_tp_params_interleaved(
        convert.gpt2_params_from_jax(_jparams(8, 4, 0)), 4, 2, 4)
    assert tuple(tb["attn.qkv.weight"].shape) == (4, 2, 1, 3, 4, 8, 32)
    assert tuple(tb["attn.out.weight"].shape) == (4, 2, 1, 32, 4, 8)
    rules = gp.block_specs_tp(extra_dims=1)
    assert tuple(rules.spec_for("attn.qkv.weight")) == (
        "pp", None, None, None, "tp")
    assert tuple(rules.spec_for("mlp.fc.weight")) == ("pp", None, None, "tp")
    assert tuple(gp.block_specs_tp().spec_for("mlp.fc.weight")) == (
        "pp", None, "tp")


# ---------------------------------------------------------------------------
# The eight-rank world and the reference beside it
# ---------------------------------------------------------------------------

_WORKER = textwrap.dedent('''
    import functools, json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt2_pipeline as gp
    from horovod_tpu_torch.models.gpt2 import GPT2Config
    from horovod_tpu_torch.parallel import make_mesh, shard_pytree
    from horovod_tpu_torch.parallel import pipeline as pl

    base, R = sys.argv[2], 2
    hvd.init(device="cpu")
    r, N = hvd.rank(), hvd.size()
    out, info = {}, {}
    data = dict(np.load(base + ".inputs.npz"))
    T = lambda k: torch.tensor(data[k])
    calls = []

    def sfn(p, h):
        calls.append(1)
        return torch.relu(h @ p[0] + p[1])

    def mse(o):
        return (o ** 2).mean()

    def mse_start(o, mb_start):
        return (o ** 2).mean()

    def mine(tag, S, d):
        """This rank's (R, ...) rounds of case tag: virtual stages r*S + d."""
        W, b, x = T(tag + ":W"), T(tag + ":b"), T(tag + ":x")
        idx = [q * S + d for q in range(R)]
        return W[idx].clone(), b[idx].clone(), x

    def gpipe(tag, loss, line=None, S=N, d=r):
        W, b, x = mine(tag, S, d)
        W.requires_grad_(), b.requires_grad_()
        calls.clear()
        l = pl.pipeline_loss_interleaved(sfn, (W, b), x, loss, line)
        l.backward()
        info[tag + "_loss"], info[tag + "_calls"] = l.item(), len(calls)
        out[tag + "_gW"], out[tag + "_gb"] = W.grad.numpy(), b.grad.numpy()

    def f1b(tag, line=None, S=N, d=r, save=True):
        W, b, x = mine(tag, S, d)
        core = pl.pipeline_interleaved_1f1b(
            sfn, lambda lp, y, m: mse(y), line, rounds=R)
        l, (g, gl, gx) = core((W, b), torch.zeros(()), x)
        if save:
            info[tag + "_loss"] = l.item()
            info[tag + "_in_flight"] = [core.peak_in_flight,
                                        core.schedule.live_peaks()[d]]
            out[tag + "_gW"], out[tag + "_gb"] = g[0].numpy(), g[1].numpy()
            out[tag + "_gx"], out[tag + "_gl"] = gx.numpy(), gl.numpy()
        return l, g

    # (ii) The MLP: interleaved GPipe at M = S, chunked at M = 2S, and a
    # marked opaque loss on the chunked inputs.
    gpipe("A", mse)
    gpipe("B", mse_start)

    class OpaqueLoss:
        def __call__(self, *args):
            outs, mb_start = args
            return (outs ** 2).mean()

    W, b, x = mine("B", N, r)
    info["B_marked_loss"] = pl.pipeline_loss_interleaved(
        sfn, (W, b), x, pl.chunkable_loss(OpaqueLoss())).item()

    # (iv) Interleaved 1F1B, one and two microbatch groups.
    f1b("D1")
    f1b("D2")

    # (viii) The stash: live bytes saved for the backward, weights excluded.
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

    W, b, x = mine("E", N, r)
    for name in ("gpipe", "1f1b"):
        Wl = W.clone().requires_grad_()
        meter = Meter([Wl, b])
        with torch.autograd.graph.saved_tensors_hooks(meter.pack,
                                                      meter.unpack):
            if name == "gpipe":
                pl.pipeline_loss_interleaved(sfn, (Wl, b), x,
                                             mse_start).backward()
                g = Wl.grad
            else:
                core = pl.pipeline_interleaved_1f1b(
                    sfn, lambda lp, y, m: mse(y), rounds=R)
                g = core((Wl, b), {}, x)[1][0][0]
                info["E_in_flight"] = [core.peak_in_flight,
                                       core.schedule.live_peaks()[r]]
        info[f"E_{name}_peak"], info[f"E_{name}_live_after"] = \\
            meter.peak, meter.live
        out[f"E_{name}_gW"] = g.numpy()

    # (v) GPT-2 over the eight ranks, and the dryrun's two steps.
    def cfg_of(layers, heads):
        return GPT2Config(vocab_size=128, max_seq_len=32, num_layers=layers,
                          num_heads=heads, d_model=32, dtype=torch.float32)

    def params_of(tag):
        return {k[len(tag) + 1:]: torch.tensor(v) for k, v in data.items()
                if k.startswith(tag + ":")}

    def save(tag, loss, gb, gr):
        info[tag + "_loss"] = float(loss)
        for k, v in gb.items():
            out[f"{tag}:blocks:{k}"] = v.numpy()
        for k, v in gr.items():
            out[f"{tag}:rest:{k}"] = v.numpy()

    cfg = cfg_of(2 * N, 2)
    for tag in ("gpipe", "chunked", "1f1b", "dry_gpipe", "dry_1f1b"):
        blocks, rest = gp.stack_block_params_interleaved(
            params_of("p" + tag), N, R)
        local = {k: v[r:r + 1] for k, v in blocks.items()}
        tok = T("tok:" + tag).long()
        if tag.endswith("1f1b"):
            step = gp.gpt2_pp_interleaved_1f1b_loss_and_grad(cfg, R)
        else:
            step = gp.gpt2_pp_loss_and_grad_interleaved(cfg)
        save(tag, *step(local, rest, tok))
        if tag == "1f1b":
            info["gpt2_in_flight"] = [step.core.peak_in_flight,
                                      step.core.schedule.live_peaks()[r]]

    # (vi) pp 4 x tp 2 on a port mesh.
    mesh = make_mesh({"pp": 4, "tp": 2})
    pp_set, tp_set = mesh.process_set("pp"), mesh.process_set("tp")
    cfg = cfg_of(4 * R, 4)
    for tag in ("tp_gpipe", "tp_1f1b"):
        blocks, rest = gp.make_pp_tp_params_interleaved(
            params_of("p" + tag), 4, R, 4)
        local = shard_pytree(blocks, mesh, gp.block_specs_tp(extra_dims=1))
        if tag == "tp_gpipe":
            step = gp.gpt2_pp_tp_loss_and_grad_interleaved(cfg, pp_set,
                                                           tp_set)
        else:
            step = gp.gpt2_pp_tp_interleaved_1f1b_loss_and_grad(
                cfg, R, pp_set, tp_set)
        save(tag, *step(local, rest, T("tok:" + tag).long()))

    # (vii) S = 2 on four two-rank lines, S = 1 on eight one-rank lines.
    mesh2 = make_mesh({"x": 4, "pp": 2})
    line2, d2 = mesh2.process_set("pp"), mesh2.coords(r)["pp"]
    gpipe("S2", mse_start, line2, 2, d2)
    l, g = f1b("S2", line2, 2, d2, save=False)
    info["S2_1f1b_loss"] = l.item()
    out["S2_1f1b_gW"], out["S2_1f1b_gb"] = g[0].numpy(), g[1].numpy()
    mesh1 = make_mesh({"x": 8, "pp": 1})
    line1 = mesh1.process_set("pp")
    gpipe("S1", mse_start, line1, 1, 0)
    l, g = f1b("S1", line1, 1, 0, save=False)
    info["S1_1f1b_loss"] = l.item()
    out["S1_1f1b_gW"], out["S1_1f1b_gb"] = g[0].numpy(), g[1].numpy()

    # (ix) Planted: the wrap edge delivers the previous microbatch.
    class StaleWrap(pl.Line):
        held = None

        def _run(self, posts):
            got_f, got_b = super()._run(posts)
            if self.rank == 0 and got_f is not None:
                got_f, self.held = (got_f if self.held is None
                                    else self.held), got_f
            return got_f, got_b

    W, b, x = mine("A", N, r)
    W.requires_grad_(), b.requires_grad_()
    l = pl.pipeline_loss_interleaved(sfn, (W, b), x, mse,
                                     StaleWrap(wrap=True))
    l.backward()
    info["stale_loss"] = l.item()
    out["stale_gW"], out["stale_gb"] = W.grad.numpy(), b.grad.numpy()

    # Planted: stage 1 of each two-rank line posts backward before forward.
    class Swapped(pl.Line):
        def _posts(self, *args):
            return sorted(super()._posts(*args),
                          key=lambda p: (p[0] is not pl.dist.isend,
                                         p[3] == "fwd"))

    line = Swapped(mesh2.process_set("pp"), wrap=True) if d2 == 1 else line2
    l, g = f1b("S2", line, 2, d2, save=False)
    info["swapped_loss"] = l.item()
    out["swapped_gW"], out["swapped_gb"] = g[0].numpy(), g[1].numpy()

    np.savez(base + f".rank{r}.npz", **out)
    with open(base + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


def _sfn(p, h):
    return jax.nn.relu(h @ p[0] + p[1])


def _mlp_reference(tag, S, mesh_axis, run):
    """The reference's (loss, gW, gb[, gx]) of MLP case ``tag`` over S
    devices: ``run`` is "gpipe" (a unary loss at M <= S, else the
    two-argument one) or "1f1b"."""
    W, b, x = _mlp(tag)
    Wd, bd = _by_device(W, S), _by_device(b, S)
    M = x.shape[0]
    if run == "gpipe":
        loss_fn = ((lambda out: jnp.mean(out ** 2)) if M <= S
                   else (lambda out, mb_start: jnp.mean(out ** 2)))

        def body(Wd, bd, xs):
            def loss(Wl, bl):
                return jpipe.pipeline_loss_interleaved(
                    _sfn, (Wl, bl), xs, loss_fn, axis_name=mesh_axis)
            l, (gW, gb) = jax.value_and_grad(loss, argnums=(0, 1))(
                Wd[0], bd[0])
            return l, gW[None], gb[None]
        outs = (JP(), JP(mesh_axis), JP(mesh_axis))
    else:
        core = jpipe.pipeline_interleaved_1f1b(
            _sfn, lambda lp, y, m: jnp.mean(y ** 2), mesh_axis, rounds=R)

        def body(Wd, bd, xs):
            loss, (gs, _, gx) = core((Wd[0], bd[0]), jnp.zeros(()), xs)
            return loss, gs[0][None], gs[1][None], gx
        outs = (JP(), JP(mesh_axis), JP(mesh_axis), JP())
    ins = (JP(mesh_axis), JP(mesh_axis), JP())
    if mesh_axis == "hvd":
        fn = jhvd.spmd(body, in_specs=ins, out_specs=outs)
    else:
        mesh = JMesh(np.array(jax.devices()[:S]), (mesh_axis,))
        fn = jax.jit(jshard_map(body, mesh=mesh, in_specs=ins,
                                out_specs=outs, check_vma=False))
    return [np.asarray(a) for a in fn(Wd, bd, x)]


def _port_state(jblocks, jrest, lead):
    """A reference block tree (plain layout) of ``lead`` = (S, R, K) and
    rest, as the port's whole state dict (layer (r·S + d)·K + k)."""
    S, Rr, K = lead
    flat = {}
    for path, a in convert.flatten_tree(jblocks).items():
        a = np.asarray(a)
        for d in range(S):
            for r in range(Rr):
                for k in range(K):
                    flat[f"h{(r * S + d) * K + k}/{path}"] = a[d, r, k]
    flat.update(convert.flatten_tree(
        jax.tree_util.tree_map(np.asarray, jrest)))
    return convert.gpt2_params_from_jax(flat)


def _plain(jblocks):
    """The reference's head-major block tree back in its plain layout."""
    b = jax.tree_util.tree_map(np.asarray, jblocks)
    qkv, out = b["attn"]["qkv"], b["attn"]["out"]
    lead = qkv["kernel"].shape[:3]
    d = qkv["kernel"].shape[3]
    b["attn"] = {"qkv": {"kernel": qkv["kernel"].reshape(lead + (d, 3 * d)),
                         "bias": qkv["bias"].reshape(lead + (3 * d,))},
                 "out": {"kernel": out["kernel"].reshape(lead + (d, d)),
                         "bias": out["bias"]}}
    return b


def _gpt2_reference():
    """The reference's (loss, port-layout block grads, rest grads) of every
    GPT-2 case; one jitted step per schedule and shape."""
    ref, fns = {}, {}
    specs = dict(in_specs=(JP("hvd"), JP(), JP()),
                 out_specs=(JP(), JP("hvd"), JP()))
    for tag in ("gpipe", "chunked", "1f1b", "dry_gpipe", "dry_1f1b"):
        layers, heads, key, seed, shape = GPT2[tag]
        cfg = _cfg(layers, heads)
        params = _jparams(layers, heads, key)
        blocks, rest = jgp.stack_block_params_interleaved(params, N, R)
        kind = "1f1b" if tag.endswith("1f1b") else "gpipe"
        if (kind, shape) not in fns:
            step = (jgp.gpt2_pp_interleaved_1f1b_loss_and_grad(
                cfg, rounds=R, axis_name="hvd") if kind == "1f1b" else
                jgp.gpt2_pp_loss_and_grad_interleaved(cfg, axis_name="hvd"))
            fns[(kind, shape)] = jhvd.spmd(step, **specs)
        loss, g_blocks, g_rest = fns[(kind, shape)](
            blocks, rest, jnp.asarray(_tokens(seed, shape)))
        K = layers // (N * R)
        ref[tag] = (float(loss),) + gp.stack_block_params_interleaved(
            _port_state(g_blocks, g_rest, (N, R, K)), N, R)
    mesh = jmake_mesh({"pp": 4, "tp": 2}, devices=jax.devices()[:N])
    tspecs = jgp.block_specs_tp("pp", "tp", extra_dims=1)
    for tag in ("tp_gpipe", "tp_1f1b"):
        layers, heads, key, seed, shape = GPT2[tag]
        cfg = _cfg(layers, heads)
        params = _jparams(layers, heads, key)
        blocks, rest = jgp.make_pp_tp_params_interleaved(params, 4, R, heads)
        step = (jgp.gpt2_pp_tp_loss_and_grad_interleaved(cfg, "pp", "tp")
                if tag == "tp_gpipe" else
                jgp.gpt2_pp_tp_interleaved_1f1b_loss_and_grad(
                    cfg, rounds=R, pp_axis="pp", tp_axis="tp"))
        fn = jax.jit(jshard_map(step, mesh=mesh,
                                in_specs=(tspecs, JP(), JP()),
                                out_specs=(JP(), tspecs, JP()),
                                check_vma=False))
        loss, g_blocks, g_rest = fn(blocks, rest,
                                    jnp.asarray(_tokens(seed, shape)))
        K = layers // (4 * R)
        state = _port_state(_plain(g_blocks), g_rest, (4, R, K))
        ref[tag] = (float(loss),) + gp.make_pp_tp_params_interleaved(
            state, 4, R, heads)
    return ref


def _reference():
    ref = {"A": _mlp_reference("A", N, "hvd", "gpipe"),
           "B": _mlp_reference("B", N, "hvd", "gpipe"),
           "D1": _mlp_reference("D1", N, "hvd", "1f1b"),
           "D2": _mlp_reference("D2", N, "hvd", "1f1b"),
           "S2": _mlp_reference("S2", 2, "pp", "gpipe"),
           "S2_1f1b": _mlp_reference("S2", 2, "pp", "1f1b"),
           "S1": _mlp_reference("S1", 1, "pp", "gpipe"),
           "S1_1f1b": _mlp_reference("S1", 1, "pp", "1f1b")}
    ref.update(_gpt2_reference())
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The eight-rank world (started first, run beside the reference) and
    the reference: (ranks [(arrays, info)], reference)."""
    tmp = tmp_path_factory.mktemp("pipeline_interleaved")
    inputs = {}
    for tag in MLP:
        inputs[tag + ":W"], inputs[tag + ":b"], inputs[tag + ":x"] = \
            _mlp(tag)
    for tag, (layers, heads, key, seed, shape) in GPT2.items():
        inputs["tok:" + tag] = _tokens(seed, shape)
        for k, v in convert.gpt2_params_from_jax(
                _jparams(layers, heads, key)).items():
            inputs[f"p{tag}:{k}"] = v.numpy()
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


def _worst(got, want, tol):
    """The largest error over the tolerance's allowance, over arrays."""
    return max(float(np.abs(g - w).max()
                     / (tol["atol"] + tol["rtol"] * np.abs(w).max()))
               for g, w in zip(got, want))


@pytest.mark.parametrize("tag", ["A", "B"])
def test_mlp_interleaved_gpipe_matches_reference(runs, tag):
    ranks, ref = runs
    loss, gW, gb = ref[tag]
    M = MLP[tag][2]
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info[tag + "_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(arrs[tag + "_gW"], gW[r], **MLP_TOL)
        np.testing.assert_allclose(arrs[tag + "_gb"], gb[r], **MLP_TOL)
        # No idle tick computes: R·M stage calls a rank.
        assert info[tag + "_calls"] == R * M


def test_marked_opaque_loss_chunks_as_reference(runs):
    ranks, ref = runs
    for _, info in ranks:
        np.testing.assert_allclose(info["B_marked_loss"], ref["B"][0],
                                   rtol=1e-5)
        assert info["B_marked_loss"] == info["B_loss"]


@pytest.mark.parametrize("tag", ["D1", "D2"])
def test_interleaved_1f1b_matches_reference(runs, tag):
    ranks, ref = runs
    loss, gW, gb, gx = ref[tag]
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info[tag + "_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(arrs[tag + "_gW"], gW[r], **TOL_1F1B)
        np.testing.assert_allclose(arrs[tag + "_gb"], gb[r], **TOL_1F1B)
        if r == 0:
            np.testing.assert_allclose(arrs[tag + "_gx"], gx, **TOL_1F1B)
        else:
            assert not arrs[tag + "_gx"].any()
        assert not arrs[tag + "_gl"].any()
        peak, bound = info[tag + "_in_flight"]
        assert peak == bound


@pytest.mark.parametrize("stage", range(N))
def test_stash_below_interleaved_gpipe_and_at_the_tables_peak(runs, stage):
    arrs, info = runs[0][stage]
    peak, bound = info["E_in_flight"]
    assert peak == bound == ss.build_interleaved_1f1b(
        N, R, MLP["E"][2]).live_peaks()[stage]
    assert 0 < info["E_1f1b_peak"] < info["E_gpipe_peak"], info
    assert info["E_1f1b_live_after"] == info["E_gpipe_live_after"] == 0
    np.testing.assert_allclose(arrs["E_1f1b_gW"], arrs["E_gpipe_gW"],
                               **MLP_TOL)


def _check_gpt2(ranks, tag, want, tol, mesh=None, rules=None):
    loss, blocks, rest = want
    for r, (arrs, info) in enumerate(ranks):
        np.testing.assert_allclose(info[tag + "_loss"], loss, **LOSS_TOL)
        for k, v in blocks.items():
            part = (v[r:r + 1] if mesh is None else _local_block(
                v, rules.spec_for(k), mesh, mesh.coords(r)))
            np.testing.assert_allclose(arrs[f"{tag}:blocks:{k}"],
                                       part.numpy(),
                                       err_msg=f"rank {r} {k}", **tol)
        for k, v in rest.items():
            got = arrs[f"{tag}:rest:{k}"]
            np.testing.assert_allclose(got, v.numpy(),
                                       err_msg=f"rank {r} {k}", **tol)
            assert np.array_equal(got, ranks[0][0][f"{tag}:rest:{k}"]), k


@pytest.mark.parametrize("tag", ["gpipe", "chunked", "1f1b", "dry_gpipe",
                                 "dry_1f1b"])
def test_gpt2_interleaved_matches_reference(runs, tag):
    ranks, ref = runs
    _check_gpt2(ranks, tag, ref[tag], GPT2_TOL)


def test_gpt2_interleaved_1f1b_in_flight(runs):
    for _, info in runs[0]:
        peak, bound = info["gpt2_in_flight"]
        assert peak == bound


@pytest.mark.parametrize("tag", ["tp_gpipe", "tp_1f1b"])
def test_pp_tp_interleaved_matches_reference(runs, tag):
    ranks, ref = runs
    mesh = Mesh(np.arange(N).reshape(4, 2), ("pp", "tp"))
    _check_gpt2(ranks, tag, ref[tag], TP_TOL if tag == "tp_gpipe"
                else GPT2_TOL, mesh, gp.block_specs_tp(extra_dims=1))


@pytest.mark.parametrize("tag", ["S2", "S2_1f1b", "S1", "S1_1f1b"])
def test_short_rings_match_reference(runs, tag):
    """S = 2 (a rank's forward and backward hops share its one peer) on
    four two-rank lines, S = 1 (every hop handed over on the rank) on
    eight one-rank lines."""
    ranks, ref = runs
    loss, gW, gb = ref[tag][:3]
    S = 2 if tag.startswith("S2") else 1
    tol = MLP_TOL if tag in ("S2", "S1") else TOL_1F1B
    for r, (arrs, info) in enumerate(ranks):
        d = r % S
        np.testing.assert_allclose(info[tag + "_loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(arrs[tag + "_gW"], gW[d], **tol)
        np.testing.assert_allclose(arrs[tag + "_gb"], gb[d], **tol)


def test_planted_stale_wrap_hop_fails(runs):
    ranks, ref = runs
    loss, gW, gb = ref["A"]
    assert not np.isclose(ranks[0][1]["stale_loss"], loss, rtol=1e-5)
    worst = max(_worst([arrs["stale_gW"], arrs["stale_gb"]],
                       [gW[r], gb[r]], MLP_TOL)
                for r, (arrs, _) in enumerate(ranks))
    assert worst > 10, worst


def test_planted_swapped_posting_order_fails(runs):
    ranks, ref = runs
    loss, gW, gb = ref["S2_1f1b"][:3]
    worst = max(_worst([arrs["swapped_gW"], arrs["swapped_gb"]],
                       [gW[r % 2], gb[r % 2]], TOL_1F1B)
                for r, (arrs, _) in enumerate(ranks))
    assert worst > 10, worst
    for _, info in ranks:
        assert np.isfinite(info["swapped_loss"])
