"""horovod_tpu_torch ResNet and batch norm == horovod_tpu's, on the CPU.

Tiny ResNets (stages [1, 1, 1, 1], 8 filters, 32x32 images, both block
types, both stems) are initialised by the JAX package, their BN scales and
biases moved off 1 and 0 so that every branch carries gradient, and loaded
into the port with ``resnet_params_from_jax``. The same numpy images go
through both, fp32, in train mode (batch statistics, running statistics
updated) and in eval mode. The optimizer steps run on a one-process port
world and on a two-rank gloo world (half the batch each, launched by the
port's runner); local BN gives each rank its own half's statistics, so the
JAX reference runs the halves separately and averages their gradients.
Cross-replica BN over the two ranks is held against the JAX package's BN
over the whole batch.

Tolerances: fp32 on both sides, summed in other orders (``LOGIT_TOL``,
``GRAD_TOL`` as tests/test_torch_port_gpt2.py states them); bf16 cases as
stated beside them.
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as jhvd
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.ops import batch_norm as jbn

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet as presnet
from horovod_tpu_torch.models.convert import resnet_params_from_jax
from horovod_tpu_torch.ops import batch_norm as pbn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides; the two frameworks sum in different orders.
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
# BN's input gradient is dy minus its projections on 1 and on x-hat, a
# difference of sums over the batch, and each of the 12-17 BNs divides by a
# batch standard deviation. Where the gradient cancels, or a later layer
# amplifies, the sums' fp32 noise (1e-7 of their size) is up to 3e-3 of a
# small element (measured: a conv weight gradient of 1e-3 in a tensor whose
# largest element is 0.43), so logits and gradients through BN hold
# LOGIT_TOL / GRAD_TOL plus BN_SCALE of the tensor's largest element
# (measured: up to 2.9e-5 of it).
BN_SCALE = 1e-4
# Parameters after two SGD(0.1, momentum 0.9) steps: the gradients'
# differences above carry into them at up to 1.6e-6 (measured), inside the
# 2e-5 tests/test_torch_port_gpt2.py holds AdamW's step to; the running
# statistics at LOGIT_TOL.
STEP_TOL = dict(rtol=0, atol=2e-5)
B, HW, CLASSES = 8, 32, 10
BLOCKS = {"basic": (jresnet.BasicBlock, presnet.BasicBlock),
          "bottleneck": (jresnet.BottleneckBlock, presnet.BottleneckBlock)}
VARIANTS = [(b, s) for b in ("basic", "bottleneck") for s in ("conv", "s2d")]


def _images(seed=0, n=B):
    g = np.random.default_rng(seed)
    x = g.standard_normal((n, HW, HW, 3)).astype(np.float32)
    y = g.integers(0, CLASSES, n).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2).contiguous()


def _jax_model(block, stem, dtype=jnp.float32, **kw):
    return jresnet.ResNet(stage_sizes=[1, 1, 1, 1],
                          block_cls=BLOCKS[block][0], num_classes=CLASSES,
                          num_filters=8, dtype=dtype, stem=stem, **kw)


def _port_model(block, stem, variables, dtype=torch.float32, **kw):
    m = presnet.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=BLOCKS[block][1],
                       num_classes=CLASSES, num_filters=8, dtype=dtype,
                       stem=stem, generator=torch.Generator().manual_seed(5),
                       **kw)
    m.load_state_dict(resnet_params_from_jax(variables["params"],
                                             variables["batch_stats"]),
                      strict=True)
    return m


@functools.lru_cache(maxsize=None)
def _variables(block, stem, kernel_scale=10.0):
    """JAX init, then every BN scale and bias drawn near 1 and 0 (the zero
    scale of each block's last BN would otherwise cut its branch's
    gradient) and every conv kernel scaled by 10 (``kernel_scale``; eval
    mode, where the running statistics do not follow the kernels, takes
    1). A BN follows each conv,
    so the forward barely changes, but the kernels' gradients, which scale
    as 1 / |kernel|, shrink tenfold: at lr 0.1 an SGD step then moves a
    kernel by a few percent, not by six times its size, and two steps stay
    where fp32 noise is not amplified from step to step."""
    x, _ = _images()
    init = jax.jit(lambda xx: _jax_model(block, stem).init(
        jax.random.PRNGKey(0), xx, train=True))
    v = jax.tree_util.tree_map(np.asarray, init(jnp.asarray(x)))
    g = np.random.default_rng(11)

    def perturb(path, leaf):
        name = path[-1].key
        if name == "kernel" and leaf.ndim == 4:
            return leaf * kernel_scale
        if name == "scale":
            return (1.0 + 0.2 * g.standard_normal(leaf.shape)).astype(
                np.float32)
        if name == "bias" and len(path) > 1 and "Dense" not in path[-2].key:
            return (0.1 * g.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    return {"params": params, "batch_stats": v["batch_stats"]}


def _ce(logits, labels):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(block, stem, dtype=jnp.float32, bn_stats_dtype=None):
    """jit(value_and_grad) of the mean cross entropy with respect to the
    params and the images; aux = (logits, updated batch_stats)."""
    model = _jax_model(block, stem, dtype, bn_stats_dtype=bn_stats_dtype)

    def loss(params, images, stats, labels):
        logits, upd = model.apply({"params": params, "batch_stats": stats},
                                  images, train=True,
                                  mutable=["batch_stats"])
        return _ce(logits, labels), (logits, upd["batch_stats"])
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


def _jax_train(block, stem, variables, x, y):
    (loss, (logits, stats)), (gp, gx) = _jax_grad_fn(block, stem)(
        variables["params"], jnp.asarray(x), variables["batch_stats"],
        jnp.asarray(y))
    return (float(loss), np.asarray(logits),
            jax.tree_util.tree_map(np.asarray, stats),
            jax.tree_util.tree_map(np.asarray, gp), np.asarray(gx))


def _assert_state_close(got, want, tol):
    assert set(got) >= set(want)
    for name in sorted(want):
        np.testing.assert_allclose(np.asarray(got[name]),
                                   np.asarray(want[name]), err_msg=name,
                                   **tol)


def _assert_bn_close(got, want, tol=GRAD_TOL):
    """``tol``, plus BN_SCALE of each tensor's largest element."""
    assert set(got) >= set(want)
    for name in sorted(want):
        w = np.asarray(want[name])
        np.testing.assert_allclose(
            np.asarray(got[name]), w, err_msg=name, rtol=tol["rtol"],
            atol=max(tol["atol"], BN_SCALE * np.abs(w).max()))


# --------------------------------------------------------- building blocks

@pytest.mark.parametrize("n,k,s", [(32, 3, 2), (31, 3, 2), (8, 1, 2),
                                   (7, 7, 2), (14, 3, 1), (5, 4, 1)])
def test_same_padding_matches_flax(n, k, s):
    import flax.linen as nn
    x = jnp.ones((1, n, n, 1))
    conv = nn.Conv(1, (k, k), (s, s), use_bias=False)
    v = conv.init(jax.random.PRNGKey(0), x)
    want = conv.apply(v, x)
    lo, hi = presnet.same_padding(n, k, s)
    kern = np.asarray(v["params"]["kernel"])
    got = presnet.Conv(1, 1, k, s)
    with torch.no_grad():
        got.weight.copy_(torch.tensor(kern.transpose(3, 2, 0, 1)))
    out = got(torch.ones(1, 1, n, n))
    assert out.shape[-1] == want.shape[1] == -(-n // s)
    np.testing.assert_allclose(out[0, 0].detach().numpy(),
                               np.asarray(want)[0, :, :, 0], **LOGIT_TOL)
    assert lo + hi == max((-(-n // s) - 1) * s + k - n, 0)


def test_strided_conv_pads_low_zero_high_one():
    # 3x3/2 on an even input: flax SAME pads (0, 1), torch's padding=1
    # would pad (1, 1) and shift every output.
    assert presnet.same_padding(8, 3, 2) == (0, 1)
    assert presnet.same_padding(56, 3, 2) == (0, 1)
    assert presnet.same_padding(56, 3, 1) == (1, 1)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    want = np.asarray(jbn.space_to_depth(jnp.asarray(x), 2))
    got = pbn.space_to_depth(_nchw(x), 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="divisible"):
        pbn.space_to_depth(torch.zeros(1, 3, 5, 4), 2)


def test_convert_stem_weights_matches_jax_and_keeps_the_logits():
    w7 = np.random.default_rng(2).standard_normal((7, 7, 3, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(presnet.convert_stem_weights(w7),
                                  jresnet.convert_stem_weights(w7))
    v = _variables("bottleneck", "conv")
    conv = _port_model("bottleneck", "conv", v).eval()
    s2d = presnet.ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=presnet.BottleneckBlock,
                         num_classes=CLASSES, num_filters=8,
                         dtype=torch.float32, stem="s2d")
    sd = conv.state_dict()
    w = sd["conv_init.weight"].permute(2, 3, 1, 0).numpy()
    sd["conv_init.weight"] = torch.tensor(
        presnet.convert_stem_weights(w).transpose(3, 2, 0, 1).copy())
    s2d.load_state_dict(sd, strict=True)
    s2d.eval()
    x = _nchw(_images(3)[0])
    np.testing.assert_allclose(s2d(x).detach().numpy(),
                               conv(x).detach().numpy(), **LOGIT_TOL)


def _bn_case(stats_dtype, dtype, seed=4):
    g = np.random.default_rng(seed)
    x = (g.standard_normal((4, 5, 5, 6)) * 2.0 + 0.5).astype(np.float32)
    w = g.standard_normal((4, 5, 5, 6)).astype(np.float32)
    scale = (1 + 0.3 * g.standard_normal(6)).astype(np.float32)
    bias = (0.2 * g.standard_normal(6)).astype(np.float32)
    jm = jbn.TunableBatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
                              stats_dtype=stats_dtype)
    jx = jnp.asarray(x, dtype)
    v = jm.init(jax.random.PRNGKey(0), jx)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def f(p, xx):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                            xx, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * w), (out, upd)
    (_, (out, upd)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jx)
    return x, w, scale, bias, out, upd["batch_stats"], gp, gx


def _port_bn(x, w, scale, bias, stats_dtype, dtype):
    m = pbn.TunableBatchNorm(6, momentum=0.9, eps=1e-5, dtype=dtype,
                             stats_dtype=stats_dtype)
    with torch.no_grad():
        m.weight.copy_(torch.tensor(scale))
        m.bias.copy_(torch.tensor(bias))
    xt = _nchw(x).to(dtype).requires_grad_(True)
    out = m(xt)
    (out.float() * _nchw(w)).sum().backward()
    return m, xt, out


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def test_tunable_bn_fp32_matches_jax():
    x, w, scale, bias, out, stats, gp, gx = _bn_case(jnp.float32,
                                                     jnp.float32)
    m, xt, got = _port_bn(x, w, scale, bias, torch.float32, torch.float32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), **LOGIT_TOL)
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(m.weight.grad.numpy(), gp["scale"],
                               **GRAD_TOL)
    np.testing.assert_allclose(m.bias.grad.numpy(), gp["bias"], **GRAD_TOL)


def test_running_var_is_flax_biased_variance():
    """From var = 1, one step on a 2x8x8x4 batch gives 0.9 + 0.1 x the
    biased batch variance (flax), not the unbiased one (torch)."""
    x = np.random.default_rng(5).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    m = pbn.TunableBatchNorm(4)
    m(torch.tensor(x))
    biased = x.transpose(1, 0, 2, 3).reshape(4, -1).var(axis=1)
    np.testing.assert_allclose(m.running_var.numpy(), 0.9 + 0.1 * biased,
                               rtol=1e-5)
    assert not np.allclose(m.running_var.numpy(),
                           0.9 + 0.1 * biased * 128 / 127, rtol=1e-5)


# bf16 statistics: both sides round x, x^2, the moments and every step of
# the normalization to bf16, but XLA may keep fp32 between fused steps
# (excess precision) where torch rounds each op. Outputs agree to 3 bf16
# ulps of the largest element (2^-8 each); input gradients, which add the
# cotangents of E[x], E[x^2] and the normalized value, each rounded, to 8
# ulps (measured: 1.2 % of the largest); the fp32 running statistics to
# 1 %. The scale and bias gradients are sums over the batch that XLA
# accumulates in bf16 and torch in fp32: they agree to 2^-4 of the largest
# (measured: 1.4 %, -11.69 against -12.06 where the largest is 26).
BF16_OUT_TOL = 3 * 2 ** -8
BF16_DX_TOL = 8 * 2 ** -8
BF16_SUM_TOL = dict(rtol=1e-2, atol=1e-2)
BF16_PARAM_GRAD_TOL = 2 ** -4


def test_tunable_bn_bf16_stats_matches_jax():
    x, w, scale, bias, out, stats, gp, gx = _bn_case(jnp.bfloat16,
                                                     jnp.bfloat16)
    m, xt, got = _port_bn(x, w, scale, bias, torch.bfloat16, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    want = np.asarray(out.astype(jnp.float32))
    assert np.abs(_nhwc(got) - want).max() <= BF16_OUT_TOL * np.abs(
        want).max()
    gxw = np.asarray(gx.astype(jnp.float32))
    assert np.abs(_nhwc(xt.grad) - gxw).max() <= BF16_DX_TOL * np.abs(
        gxw).max()
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"],
                               **BF16_SUM_TOL)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"],
                               **BF16_SUM_TOL)
    for got, want in ((m.weight.grad, gp["scale"]), (m.bias.grad,
                                                     gp["bias"])):
        want = np.asarray(want, np.float32)
        assert np.abs(got.numpy() - want).max() <= \
            BF16_PARAM_GRAD_TOL * np.abs(want).max()


# -------------------------------------------------------------- the models

@pytest.mark.parametrize("block,stem", VARIANTS)
def test_converted_state_dict_loads_strict(block, stem):
    v = _variables(block, stem)
    sd = resnet_params_from_jax(v["params"], v["batch_stats"])
    m = _port_model(block, stem, v)
    assert set(sd) == set(m.state_dict())
    kern = v["params"]["conv_init"]["kernel"]
    np.testing.assert_array_equal(sd["conv_init.weight"].numpy(),
                                  kern.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  v["params"]["Dense_0"]["kernel"].T)


@pytest.mark.parametrize("block,stem", VARIANTS)
def test_train_step_matches_jax(block, stem):
    """Logits, loss, every gradient, the input gradient and the updated
    running statistics, in train mode."""
    v = _variables(block, stem)
    x, y = _images(6)
    loss, logits, stats, gp, gx = _jax_train(block, stem, v, x, y)
    m = _port_model(block, stem, v)
    xt = _nchw(x).requires_grad_(True)
    out = m(xt)
    pl = F.cross_entropy(out, torch.tensor(y).long())
    pl.backward()
    _assert_bn_close({"logits": out.detach().numpy()}, {"logits": logits},
                     LOGIT_TOL)
    np.testing.assert_allclose(pl.item(), loss, rtol=1e-5)
    want = resnet_params_from_jax(gp, {})
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    _assert_bn_close(got, want)
    _assert_bn_close({"x": _nhwc(xt.grad)}, {"x": gx})
    _assert_state_close(m.state_dict(),
                        resnet_params_from_jax({}, stats), LOGIT_TOL)


@pytest.mark.parametrize("block,stem", VARIANTS)
def test_eval_logits_match_jax(block, stem):
    v = _variables(block, stem, kernel_scale=1.0)
    # Running statistics away from (0, 1), so that eval mode uses them.
    g = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(
        lambda a: (a + 0.3 * np.abs(g.standard_normal(a.shape))).astype(
            np.float32), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    x, _ = _images(8)
    want = _jax_model(block, stem).apply(v, jnp.asarray(x), train=False)
    m = _port_model(block, stem, v).eval()
    np.testing.assert_allclose(m(_nchw(x)).detach().numpy(),
                               np.asarray(want), **LOGIT_TOL)
    _assert_state_close(m.state_dict(), resnet_params_from_jax({}, stats),
                        dict(rtol=0, atol=0))


# bf16 compute: both sides cast each conv's input and weight to bf16 and
# round every BN output and activation the same way; with fp32 statistics
# the logits agree to one bf16 ulp of the largest (measured: 4.8e-7 of
# 3.5). bf16 statistics are a bandwidth experiment whose error the
# reference accepts: its logits move 0.32 from the fp32-statistics model
# (exact: the fp32 model), the port's 0.24, and the two are 0.25 apart
# (measured). The port's must be no further from exact than 1.25x the
# reference's, and within 2x of it from the reference.
BF16_LOGIT_TOL = 2 ** -8


def _as_tunable(tree):
    """The same variables under TunableBatchNorm's flax names."""
    if not isinstance(tree, dict):
        return tree
    return {("Tunable" + k if k.startswith("BatchNorm_") else k):
            _as_tunable(v) for k, v in tree.items()}


@pytest.mark.parametrize("stats", ["fp32", "bf16"])
def test_bf16_model_matches_jax(stats):
    v = _variables("bottleneck", "conv")
    x, _ = _images(9)

    def jax_logits(dtype, bn_stats_dtype=None):
        # Eager, so that each bf16 op rounds as written: under jit XLA keeps
        # fp32 between fused ops (excess precision), which moved these
        # logits by up to 7 % (measured).
        vv = v if bn_stats_dtype is None else _as_tunable(v)
        out, _ = _jax_model("bottleneck", "conv", dtype,
                            bn_stats_dtype=bn_stats_dtype).apply(
            vv, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return np.asarray(out)
    m = _port_model("bottleneck", "conv", v, torch.bfloat16,
                    bn_stats_dtype=torch.bfloat16 if stats == "bf16"
                    else None)
    got = m(_nchw(x))
    assert got.dtype == torch.float32
    assert m.bn_init.running_mean.dtype == torch.float32
    got = got.detach().numpy()
    if stats == "fp32":
        want = jax_logits(jnp.bfloat16)
        assert np.abs(got - want).max() <= BF16_LOGIT_TOL * np.abs(
            want).max()
        return
    want = jax_logits(jnp.bfloat16, jnp.bfloat16)
    exact = jax_logits(jnp.float32)
    ref_err = np.abs(want - exact).max()
    assert np.abs(got - exact).max() <= 1.25 * ref_err
    assert np.abs(got - want).max() <= 2 * ref_err


def test_resnet50_shapes_and_presets():
    with torch.device("meta"):          # shapes only, no 20 s CPU init
        m = presnet.ResNet50(num_classes=7, dtype=torch.float32)
    n = sum(p.numel() for p in m.parameters())
    assert n == 23_522_375      # ResNet-50 (v1.5) with a 7-class head
    assert len(m.blocks) == 16
    assert presnet.ResNet18(num_classes=10).blocks[2].conv0.stride == 2
    with pytest.raises(ValueError, match="stem"):
        presnet.ResNet18(stem="other")


# ------------------------------------------- SGD-momentum optimizer steps

SGD_STEPS = 2


def _jax_sgd_steps(v, halves):
    """The bench's hvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    for SGD_STEPS steps; each step averages the gradients of ``halves``
    (each half its own local BN), each half keeps its own running
    statistics."""
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = opt.init(params)
    stats = [v["batch_stats"]] * len(halves)
    for _ in range(SGD_STEPS):
        grads = []
        for i, (x, y) in enumerate(halves):
            (_, (_, st)), (gp, _) = _jax_grad_fn("bottleneck", "conv")(
                params, jnp.asarray(x), stats[i], jnp.asarray(y))
            stats[i] = st
            grads.append(gp)
        g = jax.tree_util.tree_map(lambda *a: sum(a) / len(a), *grads)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    np_ = functools.partial(jax.tree_util.tree_map, np.asarray)
    return [resnet_params_from_jax(np_(params), np_(s)) for s in stats]


def _assert_step_close(got, want):
    _assert_state_close(got, {k: v for k, v in want.items()
                              if "running" not in k}, STEP_TOL)
    _assert_state_close(got, {k: v for k, v in want.items()
                              if "running" in k}, LOGIT_TOL)


@pytest.fixture(scope="module")
def sgd_data():
    # 16 images, 8 a rank: BN over 4 images of 1x1 maps (the last stage)
    # is so ill-conditioned that fp32 noise decides the second step.
    return _images(10, 16)


def test_sgd_momentum_step_single_process_matches_jax(sgd_data):
    v = _variables("bottleneck", "conv")
    x, y = sgd_data
    want = _jax_sgd_steps(v, [(x, y)])[0]
    hvd.init(device="cpu")
    try:
        m = _port_model("bottleneck", "conv", v)
        hvd.broadcast_parameters(m.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            m.parameters(), lr=0.1, momentum=0.9))
        for _ in range(SGD_STEPS):
            opt.zero_grad()
            F.cross_entropy(m(_nchw(x)), torch.tensor(y).long()).backward()
            opt.step()
        got = {k: t.numpy() for k, t in m.state_dict().items()}
    finally:
        hvd.shutdown()
    _assert_step_close(got, want)


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import torch.nn.functional as F
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    data = np.load(sys.argv[2])
    out = {}
    blocks = {"basic": resnet.BasicBlock,
              "bottleneck": resnet.BottleneckBlock}

    def model(block, stem, seed, **kw):
        return resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                             block_cls=blocks[block], num_classes=10,
                             num_filters=8, dtype=torch.float32, stem=stem,
                             generator=torch.Generator().manual_seed(seed),
                             **kw)

    def state(tag):
        return {k[len(tag) + 1:]: torch.tensor(data[k]) for k in data.files
                if k.startswith(tag + ":")}

    def half(a):
        h = a.shape[0] // n
        return a[r * h:(r + 1) * h]

    # Two SGD-momentum steps with local BN, half the batch each. Rank 1
    # starts from other weights and other running statistics: the
    # broadcast of the state_dict must carry both.
    m = model("bottleneck", "conv", 100 + r)
    if r == 0:
        m.load_state_dict(state("sgd"))
    else:
        for b in m.buffers():
            b.fill_(7.0)
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    ref = state("sgd")
    out["broadcast_ok"] = torch.tensor(all(
        torch.equal(t, ref[k]) for k, t in m.state_dict().items()))
    opt = hvd.DistributedOptimizer(torch.optim.SGD(
        m.parameters(), lr=0.1, momentum=0.9))
    x = torch.tensor(half(data["sgd_x"])).permute(0, 3, 1, 2)
    y = torch.tensor(half(data["sgd_y"])).long()
    for _ in range(2):
        opt.zero_grad()
        F.cross_entropy(m(x), y).backward()
        opt.step()
    for k, t in m.state_dict().items():
        out["sgd:" + k] = t

    # Cross-replica BN over both ranks: each rank's half, the loss summed
    # over its half and divided by the whole batch, so that the ranks'
    # losses add up to the mean over the whole batch.
    for tag in ("basic-s2d", "bottleneck-conv"):
        block, stem = tag.split("-")
        m = model(block, stem, 0, bn_cross_replica=hvd.global_process_set())
        m.load_state_dict(state(tag))
        xall = data["cr_x"]
        x = torch.tensor(half(xall)).permute(0, 3, 1, 2).contiguous()
        x.requires_grad_(True)
        logits = m(x)
        loss = F.cross_entropy(logits, torch.tensor(half(data["cr_y"])).long(),
                               reduction="sum") / xall.shape[0]
        loss.backward()
        out[tag + ":logits"] = logits.detach()
        out[tag + ":dx"] = x.grad.permute(0, 2, 3, 1)
        grads = hvd.grouped_allreduce([p.grad for p in m.parameters()],
                                      op=hvd.Sum)
        for (k, _), g in zip(m.named_parameters(), grads):
            out[tag + ":grad:" + k] = g
        for k, t in m.state_dict().items():
            if "running" in k:
                out[tag + ":" + k] = t

    # hvd.SyncBatchNorm (torch semantics) over both ranks == torch's
    # BatchNorm2d over the whole batch.
    xall = torch.tensor(data["sbn_x"])
    sbn = hvd.SyncBatchNorm(3, momentum=0.1)
    xs = half(xall).clone().requires_grad_(True)
    ys = sbn(xs)
    (ys * half(torch.tensor(data["sbn_w"]))).sum().backward()
    out["sbn:y"] = ys.detach()
    out["sbn:dx"] = xs.grad
    out["sbn:running_mean"] = sbn.running_mean
    out["sbn:running_var"] = sbn.running_var
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.detach().float().numpy() for k, v in out.items()})
    hvd.shutdown()
""")

CR_TAGS = ("basic-s2d", "bottleneck-conv")


def _cr_data():
    x, y = _images(12)
    g = np.random.default_rng(13)
    sbn_x = (g.standard_normal((8, 3, 5, 5)) * 1.5 + 0.3).astype(np.float32)
    sbn_w = g.standard_normal((8, 3, 5, 5)).astype(np.float32)
    return x, y, sbn_x, sbn_w


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, sgd_data):
    tmp = tmp_path_factory.mktemp("resnet")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    cr_x, cr_y, sbn_x, sbn_w = _cr_data()
    arrays = {"sgd_x": sgd_data[0], "sgd_y": sgd_data[1], "cr_x": cr_x,
              "cr_y": cr_y, "sbn_x": sbn_x, "sbn_w": sbn_w}
    for tag in ("sgd",) + CR_TAGS:
        block, stem = ("bottleneck", "conv") if tag == "sgd" \
            else tag.split("-")
        v = _variables(block, stem)
        for k, t in resnet_params_from_jax(v["params"],
                                           v["batch_stats"]).items():
            arrays[f"{tag}:{k}"] = t.numpy()
    data = tmp / "data.npz"
    np.savez(data, **arrays)
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(2)]


def _rank(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def test_sgd_momentum_step_two_gloo_ranks_matches_jax(two_ranks, sgd_data):
    x, y = sgd_data
    h = x.shape[0] // 2
    want = _jax_sgd_steps(_variables("bottleneck", "conv"),
                          [(x[:h], y[:h]), (x[h:], y[h:])])
    for r in range(2):
        assert two_ranks[r]["broadcast_ok"] == 1.0
        got = _rank(two_ranks[r], "sgd:")
        # Same parameters on both ranks; each rank's own running stats.
        _assert_step_close(got, want[r])
    for k in _rank(two_ranks[0], "sgd:"):
        if "running" not in k:
            np.testing.assert_array_equal(two_ranks[0]["sgd:" + k],
                                          two_ranks[1]["sgd:" + k])


@pytest.mark.parametrize("tag", CR_TAGS)
def test_cross_replica_bn_two_ranks_matches_whole_batch(two_ranks, tag):
    block, stem = tag.split("-")
    v = _variables(block, stem)
    x, y, _, _ = _cr_data()
    _, logits, stats, gp, gx = _jax_train(block, stem, v, x, y)
    h = x.shape[0] // 2
    for r in range(2):
        res = _rank(two_ranks[r], tag + ":")
        _assert_bn_close({"logits": res["logits"]},
                         {"logits": logits[r * h:(r + 1) * h]}, LOGIT_TOL)
        _assert_bn_close({"x": res["dx"]}, {"x": gx[r * h:(r + 1) * h]})
        _assert_state_close(res, resnet_params_from_jax({}, stats),
                            LOGIT_TOL)
        _assert_bn_close(_rank(res, "grad:"),
                            resnet_params_from_jax(gp, {}))


def test_sync_batch_norm_two_ranks_matches_whole_batch(two_ranks):
    _, _, sbn_x, sbn_w = _cr_data()
    x = torch.tensor(sbn_x, requires_grad=True)
    bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    yb = bn(x)
    (yb * torch.tensor(sbn_w)).sum().backward()
    for r in range(2):
        res = _rank(two_ranks[r], "sbn:")
        rows = slice(4 * r, 4 * r + 4)
        np.testing.assert_allclose(res["y"], yb[rows].detach().numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(res["dx"], x.grad[rows].numpy(),
                                   **GRAD_TOL)
        np.testing.assert_allclose(res["running_mean"],
                                   bn.running_mean.numpy(), **LOGIT_TOL)
        np.testing.assert_allclose(res["running_var"],
                                   bn.running_var.numpy(), **LOGIT_TOL)


def test_sync_batch_norm_matches_reference_single_process():
    """The JAX package's torch SyncBatchNorm in one process reduces eight
    identical copies of its batch (the 8-device world); the port's on a
    one-process world sees the eight copies stacked. Outputs, running
    statistics and weight gradients agree; each copy's input gradient is
    1/8 of the reference's, whose loss is the mean over one copy."""
    from horovod_tpu.torch.sync_batch_norm import SyncBatchNorm as JSBN
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 3, 5, 5, generator=g)
    ref, port = JSBN(3, momentum=0.1), hvd.SyncBatchNorm(3, momentum=0.1)
    with torch.no_grad():
        for m in (ref, port):
            m.weight.copy_(torch.tensor([1.5, 0.5, 2.0]))
            m.bias.copy_(torch.tensor([0.1, -0.2, 0.0]))
    xa = x.clone().requires_grad_(True)
    ya = ref(xa)
    ya.square().mean().backward()
    hvd.init(device="cpu")
    try:
        x8 = x.repeat(8, 1, 1, 1).requires_grad_(True)
        y8 = port(x8)
        y8.square().mean().backward()
    finally:
        hvd.shutdown()
    for i in range(8):
        torch.testing.assert_close(y8[4 * i:4 * i + 4], ya, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(x8.grad[4 * i:4 * i + 4] * 8, xa.grad,
                                   rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(port.weight.grad, ref.weight.grad, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(port.bias.grad, ref.bias.grad, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(port.running_mean, ref.running_mean,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(port.running_var, ref.running_var,
                               rtol=1e-5, atol=1e-6)
    port.eval()
    torch.testing.assert_close(port(x), ref.eval()(x), rtol=1e-5, atol=1e-6)


def test_fused_allreduce_writes_channels_last_grads():
    """A channels_last model's conv gradients are not contiguous: the
    fused allreduce packs them in logical order and must write them back
    so (ROADMAP.md section C). One SGD step of a channels_last tiny ResNet
    equals the same step of the contiguous one."""
    from horovod_tpu_torch import fusion
    t = torch.randn(2, 3, 4, 5).to(memory_format=torch.channels_last)
    u = torch.randn(7)
    buckets, unpack = fusion.fuse([t, u], 64)
    dst = [torch.zeros_like(t), torch.zeros_like(u)]
    assert not dst[0].is_contiguous()
    unpack([b.clone() for b in buckets], out=dst)
    assert torch.equal(dst[0], t) and torch.equal(dst[1], u)
    v = _variables("basic", "conv")
    x, y = _images(14)
    hvd.init(device="cpu")
    try:
        out = []
        for fmt in (torch.contiguous_format, torch.channels_last):
            m = _port_model("basic", "conv", v).to(memory_format=fmt)
            opt = hvd.DistributedOptimizer(torch.optim.SGD(
                m.parameters(), lr=0.1, momentum=0.9),
                fusion_threshold_bytes=4096)
            F.cross_entropy(m(_nchw(x).to(memory_format=fmt)),
                            torch.tensor(y).long()).backward()
            opt.step()
            out.append({k: p.detach().clone()
                        for k, p in m.named_parameters()})
    finally:
        hvd.shutdown()
    _assert_state_close(out[1], out[0], LOGIT_TOL)
