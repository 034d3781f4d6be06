"""horovod_tpu_torch's FSDP / ZeRO-3 (``parallel/fsdp.py``) and conjugate
operators (``parallel/conjugate.py``) == horovod_tpu's: the port of
``tests/test_fsdp.py`` on a spawned four-rank gloo world
(``HOROVOD_MESH=dp2xmp2``) against the reference on devices 0-3 of its CPU
mesh.

* ``fsdp_apply``'s forward on each rank's rows equals the unsharded block
  and the reference's (rtol = atol = 1e-5, the reference test's);
* the gradient of rank r's row equals the reference's ``g[r*c:(r+1)*c]``,
  the data-parallel mean, and is zero on the padding (rtol 1e-4, atol
  1e-5);
* ``fsdp_scan_blocks`` over three stacked layers equals the blocks run in
  sequence and the reference's scan, forward and rows' gradient;
* five ``fsdp_adamw(1e-2)`` steps on an MLP block: rank r's parameter,
  mu and nu rows equal the reference's global rows' r-th chunk and its
  step the reference's (rtol 1e-4, atol 1e-5), and the losses the
  reference's (rtol 1e-4);
* FSDP over dp x tensor parallelism over mp (dp 2 x tp 2), each mp rank
  holding its Megatron column / row split of a two-matmul block, with g
  (``psum_fwd_identity_bwd``) over the mp set, equals the single-device
  loss (rtol 1e-5) and each fiber's gradients (rtol 2e-4, atol 1e-6);
  the same block with ``torch.distributed.nn.functional.all_reduce`` as
  its g (differentiable: its backward sums the cotangent again) must fail
  that gradient check;
* f and g alone equal the reference's custom-VJP pair under
  ``shard_map`` (value and input gradient, exactly);
* three steps of a tiny GPT-2 (two layers, d 64, fp32, weights of the
  reference's init converted) with its blocks FSDP-sharded equal the
  reference's ``examples/fsdp_gpt2.py`` step on the same tokens (losses
  rtol 1e-5; the final rows, in the port's layout, rtol 1e-4 and atol
  1e-4, a tenth of the learning rate: see ``GPT_ROWS``) and plain data
  parallelism (the port's model, gradients averaged, Adam on the blocks:
  losses rtol 1e-5, blocks as the rows);
* segment ids go into a block as an input without a gradient; the block's
  output, its input's gradient and the row's gradient equal the plain
  block's (rtol 1e-5, atol 1e-6);
* memory: while ``fsdp_scan_blocks`` runs the forward of six layers, at
  most one gathered block is alive (weak references to a copy of every
  gather, which only FSDP holds);
  a planted forward that keeps its gathered block in ``ctx`` leaves six;
* a full-model template with per-layer rows, a block that returns an
  MoE aux loss and a shard of the wrong width raise.
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
from horovod_tpu.optimizer_sharded import _unflatten as junflatten
from horovod_tpu.parallel import conjugate as jconj
from horovod_tpu.parallel import fsdp as jfsdp
from horovod_tpu.parallel import make_mesh as jmake_mesh
from horovod_tpu.utils.compat import shard_map as _shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, DP, TP, F = 4, 16, 2, 2, 16
LAYERS, STEPS, GPT_STEPS = 3, 5, 3
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
# GPT-2 rows after three AdamW(1e-3) steps: Adam's early updates are ~lr
# times the sign of the gradient, so an element whose gradient is rounding
# noise moves by a share of lr that depends on the order of the sums; a
# tenth of lr bounds it.
GPT_ROWS = dict(rtol=1e-4, atol=1e-4)


def _mlp(g):
    return {"w1": (g.standard_normal((D, 2 * D)) * 0.3).astype(np.float32),
            "b1": (g.standard_normal(2 * D) * 0.1).astype(np.float32),
            "w2": (g.standard_normal((2 * D, D)) * 0.3).astype(np.float32),
            "b2": (g.standard_normal(D) * 0.1).astype(np.float32)}


def _inputs():
    g = np.random.default_rng(21)
    d = {}
    for name, p in [("p", _mlp(g))] + [(f"l{i}", _mlp(g))
                                       for i in range(LAYERS)]:
        for k, v in p.items():
            d[f"{name}:{k}"] = v
    d["x"] = g.standard_normal((N, 4, D)).astype(np.float32)
    d["x2"] = g.standard_normal((N, 2, D)).astype(np.float32)
    d["X"] = g.standard_normal((N, 8, D)).astype(np.float32)
    d["Y"] = g.standard_normal((N, 8, D)).astype(np.float32)
    d["W1"] = (g.standard_normal((D, F)) * 0.3).astype(np.float32)
    d["W2"] = (g.standard_normal((F, D)) * 0.3).astype(np.float32)
    d["xt"] = g.standard_normal((DP, 4, D)).astype(np.float32)
    d["cx"] = g.standard_normal((N, 3, 5)).astype(np.float32)
    d["cw"] = g.standard_normal((N, 3, 5)).astype(np.float32)
    d["tokens"] = g.integers(0, 256, (N, 4, 32)).astype(np.int32)
    return d


def _params(d, name):
    return {k: d[f"{name}:{k}"] for k in ("w1", "b1", "w2", "b2")}


def _block(p, x):
    return x + jax.nn.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _gpt_cfg():
    from horovod_tpu.models.gpt2 import GPT2Config
    return GPT2Config(vocab_size=256, max_seq_len=64, num_layers=2,
                      num_heads=4, d_model=64, dtype=jnp.float32)


def _gpt_params():
    from horovod_tpu.models.gpt2 import GPT2
    return GPT2(_gpt_cfg()).init(jax.random.PRNGKey(0),
                                 jnp.ones((4, 32), jnp.int32))["params"]


_WORKER = textwrap.dedent('''
    import json, sys, weakref
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, Block, \\
        loss_fn
    from horovod_tpu_torch.parallel import conjugate, fsdp

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    d = dict(np.load(sys.argv[2] + ".in.npz"))
    gpt = dict(np.load(sys.argv[2] + ".gpt.npz"))
    T = lambda a: torch.from_numpy(np.asarray(a))
    out, info = {}, {}

    def params(name):
        return {k: T(d[f"{name}:{k}"]) for k in ("w1", "b1", "w2", "b2")}

    def block(p, x):
        return x + torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def mean_all(v):
        return hvd.allreduce(v.detach().reshape(1), op=hvd.Average).item()

    # forward and the row's gradient
    p = params("p")
    row = fsdp.fsdp_shard_params(p).requires_grad_()
    y = fsdp.fsdp_apply(block, p, row, T(d["x"][r]))
    (y ** 2).mean().backward()
    out["fwd"], out["grad"] = y.detach().numpy(), row.grad.numpy()

    # the scan
    layers = [params(f"l{i}") for i in range(3)]
    stacked = {k: torch.stack([l[k] for l in layers]) for k in layers[0]}
    rows = fsdp.stack_layer_shards(stacked).requires_grad_()
    y = fsdp.fsdp_scan_blocks(block, layers[0], rows, T(d["x2"][r]))
    (y ** 2).mean().backward()
    out["scan"], out["scan_grad"] = y.detach().numpy(), rows.grad.numpy()

    # five fsdp_adamw steps
    opt = fsdp.fsdp_adamw(1e-2)
    shard = fsdp.fsdp_shard_params(p)
    st = opt.init(shard)
    info["init_shapes"] = [list(st.step.shape), list(st.mu.shape)]
    losses = []
    for s in range(5):
        s_ = shard.clone().requires_grad_()
        pred = fsdp.fsdp_apply(block, p, s_, T(d["X"][r]))
        l = ((pred - T(d["Y"][r])) ** 2).mean()
        l.backward()
        upd, st = opt.update(s_.grad, st, shard)
        shard = shard + upd
        losses.append(mean_all(l))
    info["train_losses"] = losses
    out["train_shard"], out["train_mu"] = shard.numpy(), st.mu.numpy()
    out["train_nu"], out["train_step"] = st.nu.numpy(), st.step.numpy()

    # conjugate f and g over the mp set
    mesh = hvd.mesh2d()
    dp_set, mp_set = mesh.process_set("dp"), mesh.process_set("mp")
    for name, op in (("f", conjugate.identity_fwd_psum_bwd(mp_set)),
                     ("g", conjugate.psum_fwd_identity_bwd(mp_set))):
        x = T(d["cx"][r]).requires_grad_()
        yv = op(x)
        (yv * T(d["cw"][r])).sum().backward()
        out["conj_" + name], out["conj_" + name + "_grad"] = (
            yv.detach().numpy(), x.grad.numpy())

    # FSDP over dp x tensor parallelism over mp
    F, TP = 16, 2
    i, j = hvd.mp_rank(), hvd.dp_rank()
    W1, W2 = T(d["W1"]), T(d["W2"])
    fiber = {"w1": W1[:, i * F // TP:(i + 1) * F // TP].contiguous(),
             "w2": W2[i * F // TP:(i + 1) * F // TP, :].contiguous()}
    from torch.distributed.nn.functional import all_reduce as diff_allreduce
    planted_g = lambda v: diff_allreduce(v, group=mp_set.group)
    for name, g_tp in (("tp", conjugate.psum_fwd_identity_bwd(mp_set)),
                       ("tp_planted", planted_g)):
        def tp_block(p, h, g_tp=g_tp):
            return h + g_tp(torch.relu(h @ p["w1"]) @ p["w2"])
        s_ = fsdp.fsdp_shard_params(fiber, process_set=dp_set)
        s_.requires_grad_()
        yv = fsdp.fsdp_apply(tp_block, fiber, s_, T(d["xt"][j]),
                             process_set=dp_set)
        l = (yv ** 2).mean()
        l.backward()
        from horovod_tpu_torch import collective as C
        info[name + "_loss"] = C._in_step_allreduce(
            l.detach().reshape(1), C.Average, dp_set).item()
        out[name + "_grad"] = s_.grad.numpy()

    # the tiny GPT-2: FSDP blocks against plain data parallelism
    cfg = GPT2Config(vocab_size=256, max_seq_len=64, num_layers=2,
                     num_heads=4, d_model=64, dtype=torch.float32)
    state = convert.gpt2_params_from_jax(gpt)
    tok = T(d["tokens"][r]).long()

    def fresh():
        m = GPT2(cfg)
        m.load_state_dict(state)
        return m
    m = fresh()
    blocks = [dict(b.named_parameters()) for b in m.h]
    template = {k: v.detach() for k, v in blocks[0].items()}
    stacked = {k: torch.stack([b[k].detach() for b in blocks])
               for k in template}
    rows = fsdp.stack_layer_shards(stacked)
    with torch.device("meta"):
        meta_block = Block(cfg)
    fn = fsdp.module_block_fn(meta_block)
    opt = fsdp.fsdp_adamw(1e-3)
    st = opt.init(rows)
    losses = []
    for s in range(3):
        rows_ = rows.clone().requires_grad_()
        t = tok.shape[1]
        h = m.wte[tok] + m.wpe[torch.arange(t)]
        h = fsdp.fsdp_scan_blocks(fn, template, rows_, h)
        h = m.ln_f(h)
        l = loss_fn(torch.einsum("btd,vd->btv", h.float(), m.wte), tok)
        g_rows, = torch.autograd.grad(l, [rows_])
        upd, st = opt.update(g_rows, st, rows)
        rows = rows + upd
        losses.append(mean_all(l))
    info["gpt_fsdp_losses"] = losses
    out["gpt_rows"] = rows.numpy()

    m = fresh()
    bp = [p for b in m.h for p in b.parameters()]
    adam = torch.optim.Adam(bp, lr=1e-3)
    losses = []
    for s in range(3):
        l = loss_fn(m(tok), tok)
        grads = list(torch.autograd.grad(l, bp))
        hvd.allreduce_gradients(grads)
        for p_, g_ in zip(bp, grads):
            p_.grad = g_
        adam.step()
        losses.append(mean_all(l))
    info["gpt_dp_losses"] = losses
    for li, b in enumerate(m.h):
        out[f"gpt_dp_row{li}"] = torch.cat(
            [v.detach().reshape(-1) for _, v in sorted(
                b.named_parameters())]).numpy()

    # segment ids ride without a gradient
    b0 = fresh().h[0]
    seg = torch.tensor([[0] * 16 + [1] * 16] * 4)
    h0 = T(d["tokens"][r]).float()[..., None].repeat(1, 1, 64) * 0.01
    shard = fsdp.fsdp_shard_params(template).requires_grad_()
    h_in = h0.clone().requires_grad_()
    y = fsdp.fsdp_apply(fn, template, shard, (h_in, seg))
    (y ** 2).mean().backward()
    out["seg_y"], out["seg_gx"] = y.detach().numpy(), h_in.grad.numpy()
    out["seg_grow"] = shard.grad.numpy()
    h_ref = h0.clone().requires_grad_()
    y_ref, _ = b0(h_ref, seg)
    (y_ref ** 2).mean().backward()
    g_ref = [p_.grad for _, p_ in sorted(b0.named_parameters())]
    hvd.allreduce_gradients(g_ref)
    out["seg_y_ref"], out["seg_gx_ref"] = (y_ref.detach().numpy(),
                                           h_ref.grad.numpy())
    flat = torch.cat([g_.reshape(-1) for g_ in g_ref])
    c = shard.shape[0]
    flat = torch.nn.functional.pad(flat, (0, n * c - flat.numel()))
    out["seg_grow_ref"] = flat[r * c:(r + 1) * c].numpy()

    # memory: gathered blocks alive during a six-layer forward
    def alive_during_forward():
        refs, most = [], [0]
        real = fsdp._gather

        def tracked(*a, **kw):
            # A copy the collective never saw: gloo's worker threads may
            # hold the gathered buffer itself a moment after the wait.
            full = real(*a, **kw).clone()
            refs.append(weakref.ref(full))
            most[0] = max(most[0], sum(x() is not None for x in refs))
            return full
        fsdp._gather = tracked
        try:
            layers6 = [params(f"l{k % 3}") for k in range(6)]
            st6 = {k: torch.stack([l[k] for l in layers6])
                   for k in layers6[0]}
            rows6 = fsdp.stack_layer_shards(st6).requires_grad_()
            y6 = fsdp.fsdp_scan_blocks(block, layers6[0], rows6,
                                       T(d["x2"][r]))
            held = sum(x() is not None for x in refs)
            (y6 ** 2).mean().backward()
        finally:
            fsdp._gather = real
        return most[0], held
    info["alive"] = alive_during_forward()

    real_call = fsdp._FsdpCall

    class Planted(real_call):
        @staticmethod
        def forward(ctx, meta, shard, *xs):
            block_fn, template, length, ps, wire, spec = meta
            full = fsdp._gather(shard, ps, wire)
            y = fsdp._run_block(block_fn,
                                fsdp._unflatten(full[:length], template),
                                fsdp._join_inputs(spec, xs))
            ctx.meta, ctx.full = meta, full
            ctx.save_for_backward(shard, *xs)
            return y
    fsdp._FsdpCall = Planted
    try:
        info["alive_planted"] = alive_during_forward()
    finally:
        fsdp._FsdpCall = real_call

    # errors
    def error(fn_):
        try:
            fn_()
        except (ValueError, TypeError) as e:
            return type(e).__name__ + ": " + str(e)
        return None
    full_template = {f"l{k}": params(f"l{k}") for k in range(3)}
    stacked_mlp = {k: torch.stack([l[k] for l in layers]) for k in layers[0]}
    info["err_full_template"] = error(lambda: fsdp.fsdp_scan_blocks(
        block, full_template, fsdp.stack_layer_shards(stacked_mlp),
        T(d["x2"][r])))
    info["err_width"] = error(lambda: fsdp.fsdp_apply(
        block, p, torch.zeros(7), T(d["x"][r])))

    class Moe(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(16, 16))
        def forward(self, x):
            return x @ self.w, (x ** 2).mean()
    moe = Moe()
    info["err_aux"] = error(lambda: fsdp.fsdp_apply(
        fsdp.module_block_fn(moe), dict(moe.named_parameters()),
        fsdp.fsdp_shard_params(dict(moe.named_parameters())),
        T(d["x"][r])))
    np.savez(sys.argv[2] + f".rank{r}.npz", **out)
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    np.savez(tmp / "out.in.npz", **_inputs())
    from horovod_tpu_torch.models.convert import flatten_tree
    np.savez(tmp / "out.gpt.npz", **{k: np.asarray(v) for k, v in
                                     flatten_tree(_gpt_params()).items()})
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_MESH="dp2xmp2")
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(N),
         "--timeout", "240", str(script), REPO, str(tmp / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    return [(dict(np.load(tmp / f"out.rank{r}.npz")),
             json.load(open(tmp / f"out.rank{r}.json"))) for r in range(N)]


@pytest.fixture(scope="module")
def reference():
    """The reference's FSDP results over devices 0-3."""
    d = _inputs()
    out = {}
    jhvd.init(devices=jax.devices()[:N])
    try:
        p = {k: jnp.asarray(v) for k, v in _params(d, "p").items()}
        shards = jfsdp.fsdp_shard_params(p)
        spmd = lambda f, i, o: jhvd.spmd(f, in_specs=i, out_specs=o)
        out["fwd"] = np.asarray(spmd(
            lambda s, xs: jfsdp.fsdp_apply(_block, p, s, xs[0])[None],
            (P("hvd"), P("hvd")), P("hvd"))(shards, jnp.asarray(d["x"])))

        def gbody(s, xs):
            return jax.grad(lambda s: jnp.mean(
                jfsdp.fsdp_apply(_block, p, s, xs[0]) ** 2))(s)
        out["grad"] = np.asarray(spmd(gbody, (P("hvd"), P("hvd")),
                                      P("hvd"))(shards, jnp.asarray(d["x"])))
        layers = [{k: jnp.asarray(v) for k, v in _params(d, f"l{i}").items()}
                  for i in range(LAYERS)]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *layers)
        rows = jfsdp.stack_layer_shards(stacked)

        def sbody(r, xs):
            def loss(r):
                y = jfsdp.fsdp_scan_blocks(_block, layers[0], r, xs[0])
                return jnp.mean(y ** 2), y
            (_, y), g = jax.value_and_grad(loss, has_aux=True)(r)
            return y[None], g
        y, g = spmd(sbody, (P(None, "hvd"), P("hvd")),
                    (P("hvd"), P(None, "hvd")))(rows, jnp.asarray(d["x2"]))
        out["scan"], out["scan_grad"] = np.asarray(y), np.asarray(g)

        opt = jfsdp.fsdp_adamw(1e-2)
        st = opt.init(shards)

        def tstep(shard, mu, nu, stepc, Xs, ys):
            def loss(s):
                return jnp.mean((jfsdp.fsdp_apply(_block, p, s, Xs[0])
                                 - ys[0]) ** 2)
            l, g = jax.value_and_grad(loss)(shard)
            upd, st2 = opt.update(g, JState(stepc, mu, nu), shard)
            return (shard + upd, st2.mu, st2.nu, st2.step,
                    jax.lax.pmean(l, "hvd"))
        fn = spmd(tstep, (P("hvd"),) * 6, (P("hvd"),) * 4 + (P(),))
        shard, mu, nu, stepc = shards, st.mu, st.nu, st.step
        losses = []
        for _ in range(STEPS):
            shard, mu, nu, stepc, l = fn(shard, mu, nu, stepc,
                                         jnp.asarray(d["X"]),
                                         jnp.asarray(d["Y"]))
            losses.append(float(l))
        out["train"] = (np.asarray(shard), np.asarray(mu), np.asarray(nu),
                        np.asarray(stepc), losses)
        out["gpt"] = _reference_gpt(d)
    finally:
        jhvd.init()
    out["conj"] = _reference_conjugate(d)
    return out


def _reference_gpt(d):
    """``examples/fsdp_gpt2.py``'s step, three times, on the tokens."""
    import flax.linen as nn
    from horovod_tpu.models.gpt2 import Block, loss_fn
    cfg = _gpt_cfg()
    params = _gpt_params()
    keys = sorted((k for k in params if k.startswith("h")),
                  key=lambda k: int(k[1:]))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[params[k] for k in keys])
    rest = {k: v for k, v in params.items() if not k.startswith("h")}
    rows = jfsdp.stack_layer_shards(stacked)
    template = params[keys[0]]
    block = Block(cfg)
    ln_f = nn.LayerNorm(dtype=jnp.float32)
    opt = jfsdp.fsdp_adamw(1e-3)
    state = opt.init(rows.reshape(-1))

    def step(rows, mu, nu, stepc, rest, toks):
        def loss(rows):
            t = toks.shape[-1]
            h = (rest["wte"][toks[0]].astype(cfg.dtype)
                 + rest["wpe"][jnp.arange(t)].astype(cfg.dtype))
            h = jfsdp.fsdp_scan_blocks(
                lambda p, hh: block.apply({"params": p}, hh), template,
                rows, h)
            h = ln_f.apply({"params": rest["ln_f"]}, h)
            logits = jnp.einsum("btd,vd->btv", h.astype(jnp.float32),
                                rest["wte"])
            return loss_fn(logits, toks[0])
        l, g_rows = jax.value_and_grad(loss)(rows)
        L = g_rows.shape[0]
        upd, st2 = opt.update(g_rows.reshape(-1), JState(stepc, mu, nu),
                              rows.reshape(-1))
        return (rows + upd.reshape(L, -1), st2.mu, st2.nu, st2.step,
                jax.lax.pmean(l, "hvd"))

    fn = jhvd.spmd(step, in_specs=(P(None, "hvd"), P("hvd"), P("hvd"),
                                   P("hvd"), P(), P("hvd")),
                   out_specs=(P(None, "hvd"), P("hvd"), P("hvd"),
                              P("hvd"), P()))
    mu, nu, stepc = state.mu, state.nu, state.step
    losses = []
    toks = jnp.asarray(d["tokens"])
    for _ in range(GPT_STEPS):
        rows, mu, nu, stepc, l = fn(rows, mu, nu, stepc, rest, toks)
        losses.append(float(l))
    length = jfsdp.flat_size(template)
    layers = [junflatten(jnp.asarray(rows)[i, :length], template)
              for i in range(len(keys))]
    return losses, layers


def _reference_conjugate(d):
    mesh = jmake_mesh({"dp": DP, "tp": TP}, devices=jax.devices()[:N])
    out = {}
    for name, op in (("f", jconj.identity_fwd_psum_bwd("tp")),
                     ("g", jconj.psum_fwd_identity_bwd("tp"))):
        def body(x, w, op=op):
            y, vjp = jax.vjp(op, x[0])
            return y[None], vjp(w[0])[0][None]
        fn = jax.jit(_shard_map(body, mesh=mesh,
                                in_specs=(P(("dp", "tp")), P(("dp", "tp"))),
                                out_specs=(P(("dp", "tp")), P(("dp", "tp"))),
                                check_vma=False))
        y, g = fn(jnp.asarray(d["cx"]), jnp.asarray(d["cw"]))
        out[name] = (np.asarray(y), np.asarray(g))
    return out


def _c(length, n=N):
    return -(-length // n)


def test_forward_equals_unsharded_and_reference(world, reference):
    d = _inputs()
    p = {k: jnp.asarray(v) for k, v in _params(d, "p").items()}
    for r, (res, _) in enumerate(world):
        np.testing.assert_allclose(res["fwd"], np.asarray(
            _block(p, jnp.asarray(d["x"][r]))), **FWD)
        np.testing.assert_allclose(res["fwd"], reference["fwd"][r], **FWD)


def test_row_gradient_is_the_dp_mean_resharded(world, reference):
    g = reference["grad"].ravel()
    length = 4 * D * D + 3 * D
    c = _c(length)
    assert g.shape == (N * c,)
    for r, (res, _) in enumerate(world):
        assert res["grad"].shape == (c,)
        np.testing.assert_allclose(res["grad"], g[r * c:(r + 1) * c], **GRAD)
    got = np.concatenate([res["grad"] for res, _ in world])
    np.testing.assert_allclose(got[length:], 0.0, atol=1e-7)


def test_scan_equals_sequential_and_reference(world, reference):
    d = _inputs()
    layers = [{k: jnp.asarray(v) for k, v in _params(d, f"l{i}").items()}
              for i in range(LAYERS)]
    c = reference["scan_grad"].shape[1] // N
    for r, (res, _) in enumerate(world):
        want = jnp.asarray(d["x2"][r])
        for p in layers:
            want = _block(p, want)
        np.testing.assert_allclose(res["scan"], np.asarray(want), **GRAD)
        np.testing.assert_allclose(res["scan"], reference["scan"][r],
                                   **GRAD)
        assert res["scan_grad"].shape == (LAYERS, c)
        np.testing.assert_allclose(
            res["scan_grad"], reference["scan_grad"][:, r * c:(r + 1) * c],
            **GRAD)


def test_fsdp_adamw_rows_equal_reference_global_rows(world, reference):
    shard, mu, nu, step, losses = reference["train"]
    c = shard.shape[0] // N
    for r, (res, info) in enumerate(world):
        assert info["init_shapes"] == [[1], [c]]
        np.testing.assert_array_equal(res["train_step"], step[r:r + 1])
        for key, want in (("train_shard", shard), ("train_mu", mu),
                          ("train_nu", nu)):
            np.testing.assert_allclose(res[key], want[r * c:(r + 1) * c],
                                       err_msg=key, **GRAD)
        np.testing.assert_allclose(info["train_losses"], losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def _tp_reference(d):
    x = jnp.asarray(d["xt"])

    def ref_loss(W1f, W2f):
        per = [jnp.mean((x[i] + jax.nn.relu(x[i] @ W1f) @ W2f) ** 2)
               for i in range(DP)]
        return sum(per) / DP
    return jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(d["W1"]), jnp.asarray(d["W2"]))


def _fiber_rows(d, rW1, rW2, key, world):
    """(got, want) rows of each rank: rank (dp j, mp i) holds row j of
    fiber i's padded flat gradient (w1 columns then w2 rows)."""
    out = []
    for r, (res, _) in enumerate(world):
        i, j = r % TP, r // TP
        want = np.concatenate(
            [np.asarray(rW1)[:, i * F // TP:(i + 1) * F // TP].ravel(),
             np.asarray(rW2)[i * F // TP:(i + 1) * F // TP, :].ravel()])
        c = _c(want.size, DP)
        want = np.pad(want, (0, DP * c - want.size))[j * c:(j + 1) * c]
        out.append((res[key], want))
    return out


def test_fsdp_composes_with_tensor_parallelism(world):
    d = _inputs()
    rl, (rW1, rW2) = _tp_reference(d)
    for res, info in world:
        np.testing.assert_allclose(info["tp_loss"], float(rl), rtol=1e-5)
    for got, want in _fiber_rows(d, rW1, rW2, "tp_grad", world):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def test_differentiable_allreduce_as_g_fails_the_gradient_check(world):
    """The torch form of the reference's bare-psum bug: the loss is right,
    the gradients are off by the tp size."""
    d = _inputs()
    rl, (rW1, rW2) = _tp_reference(d)
    wrong = 0
    for res, info in world:
        np.testing.assert_allclose(info["tp_planted_loss"], float(rl),
                                   rtol=1e-5)
    for got, want in _fiber_rows(d, rW1, rW2, "tp_planted_grad", world):
        wrong += not np.allclose(got, want, rtol=2e-4, atol=1e-6)
    assert wrong == N


@pytest.mark.parametrize("name", ["f", "g"])
def test_conjugate_operators_equal_reference(world, reference, name):
    y, g = reference["conj"][name]
    for r, (res, _) in enumerate(world):
        np.testing.assert_array_equal(res["conj_" + name], y[r])
        np.testing.assert_array_equal(res["conj_" + name + "_grad"], g[r])


def _port_layout(layer):
    """A reference block's params -> the port's flat row (sorted port
    names, (out, in) weights)."""
    from horovod_tpu_torch.models.convert import gpt2_params_from_jax
    conv = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, layer))
    return np.concatenate([conv[k].numpy().ravel() for k in sorted(conv)])


def test_tiny_gpt2_blocks_equal_reference_example_and_plain_dp(world,
                                                               reference):
    losses, layers = reference["gpt"]
    want = np.stack([_port_layout(l) for l in layers])
    length = want.shape[1]
    got = np.concatenate([res["gpt_rows"] for res, _ in world], axis=1)
    assert got.shape[1] == N * _c(length)
    np.testing.assert_allclose(got[:, :length], want, **GPT_ROWS)
    for res, info in world:
        np.testing.assert_allclose(info["gpt_fsdp_losses"], losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(info["gpt_dp_losses"],
                                   info["gpt_fsdp_losses"], rtol=1e-5)
        dp_rows = np.stack([res[f"gpt_dp_row{i}"] for i in range(2)])
        np.testing.assert_allclose(got[:, :length], dp_rows, **GPT_ROWS)
    assert losses[-1] < losses[0]


def test_segment_ids_ride_without_a_gradient(world):
    tol = dict(rtol=1e-5, atol=1e-6)
    for res, _ in world:
        np.testing.assert_allclose(res["seg_y"], res["seg_y_ref"], **tol)
        np.testing.assert_allclose(res["seg_gx"], res["seg_gx_ref"], **tol)
        np.testing.assert_allclose(res["seg_grow"], res["seg_grow_ref"],
                                   **tol)


def test_one_gathered_block_alive_at_a_time(world):
    for _, info in world:
        most, held = info["alive"]
        assert most == 1 and held == 0, info["alive"]


def test_keeping_the_gathered_block_in_ctx_is_caught(world):
    for _, info in world:
        most, held = info["alive_planted"]
        # Six held at the end of the forward, one more in the backward.
        assert held == 6 and most == 7, info["alive_planted"]


def test_template_and_block_errors(world):
    for _, info in world:
        assert "ONE layer" in info["err_full_template"]
        assert info["err_width"].startswith("ValueError: shard width 7")
        assert "MoE under FSDP" in info["err_aux"]
