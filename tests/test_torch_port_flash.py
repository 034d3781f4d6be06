"""horovod_tpu_torch flash attention == horovod_tpu flash attention.

The same numpy inputs go through the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode on the CPU, as its own tests run them) and
through the port's ``flash_attention`` (its plain PyTorch versions, which
the port takes for CPU tensors). Tolerances are the reference's own
(tests/test_flash_attention.py): 1e-4 on the output, rtol 1e-3 / atol 1e-4
on the gradients, all in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.attention import multihead_attention as jax_mha
from horovod_tpu.ops.attention import packed_positions as jax_packed
from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import attention as patt
from horovod_tpu_torch.ops import flash_attention as pfa

FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)

# name -> (B, Tq, Tk, H, D, causal, offset, bias, seg, (block_q, block_k))
CASES = {
    "full": (2, 32, 32, 2, 8, False, 0, False, False, (8, 8)),
    "causal": (2, 32, 32, 2, 8, True, 0, False, False, (8, 8)),
    "ragged_cross": (1, 20, 28, 2, 8, False, 0, False, False, (8, 8)),
    "ragged_causal": (2, 21, 21, 2, 16, True, 0, False, False, (8, 16)),
    "key_bias": (2, 24, 24, 2, 8, False, 0, True, False, (8, 8)),
    "key_bias_causal_ragged": (2, 19, 19, 1, 8, True, 0, True, False,
                               (8, 8)),
    "segments": (2, 24, 24, 2, 8, True, 0, False, True, (8, 8)),
    "offset_minus1": (1, 16, 16, 2, 8, True, -1, False, False, (8, 8)),
    "everything": (2, 19, 19, 2, 8, True, -1, True, True, (8, 8)),
}


def _inputs(case, seed=0):
    b, tq, tk, h, d, causal, offset, bias, seg, _ = CASES[case]
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, tq, h, d)).astype(np.float32)
    k = g.standard_normal((b, tk, h, d)).astype(np.float32)
    v = g.standard_normal((b, tk, h, d)).astype(np.float32)
    tgt = g.standard_normal((b, tq, h, d)).astype(np.float32)
    kb = sg = None
    if bias:
        kb = g.standard_normal((b, tk)).astype(np.float32)
        kb[:, -3:] = -1e30                      # padded keys
        kb[-1, :] = -1e30                       # every key of a row masked
    if seg:
        sg = np.sort(g.integers(0, 3, (b, tq)), axis=1).astype(np.int32)
    return q, k, v, tgt, kb, sg


def _jax_run(case, q, k, v, tgt, kb, sg):
    _, _, _, _, _, causal, offset, _, _, (bq, bk) = CASES[case]

    def loss(q, k, v, kb):
        o = jax_flash(q, k, v, causal=causal, key_bias=kb,
                      segment_ids=None if sg is None else jnp.asarray(sg),
                      block_q=bq, block_k=bk, block_q_bwd=bq,
                      block_k_bwd=bk, causal_offset=offset)
        return jnp.sum(o * tgt), o

    args = [jnp.asarray(x) for x in (q, k, v)]
    args.append(None if kb is None else jnp.asarray(kb))
    argnums = (0, 1, 2) if kb is None else (0, 1, 2, 3)
    (_, o), grads = jax.value_and_grad(loss, argnums=argnums,
                                       has_aux=True)(*args)
    return np.asarray(o), [np.asarray(x) for x in grads]


def _port_run(case, q, k, v, tgt, kb, sg, blocks=None):
    _, _, _, _, _, causal, offset, _, _, (bq, bk) = CASES[case]
    bq, bk = blocks or (bq, bk)
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    if kb is not None:
        ts.append(torch.tensor(kb, requires_grad=True))
    o = pfa.flash_attention(
        ts[0], ts[1], ts[2], causal=causal,
        key_bias=ts[3] if kb is not None else None,
        segment_ids=None if sg is None else torch.tensor(sg),
        block_q=bq, block_k=bk, causal_offset=offset)
    (o * torch.tensor(tgt)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    q, k, v, tgt, kb, sg = _inputs(case)
    o_j, _ = _jax_run(case, q, k, v, tgt, kb, sg)
    o_p, _ = _port_run(case, q, k, v, tgt, kb, sg)
    np.testing.assert_allclose(o_p, o_j, **FWD_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    q, k, v, tgt, kb, sg = _inputs(case, seed=1)
    _, g_j = _jax_run(case, q, k, v, tgt, kb, sg)
    _, g_p = _port_run(case, q, k, v, tgt, kb, sg)
    assert len(g_p) == len(g_j)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), g_p, g_j):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)


def test_fully_masked_rows_give_zero_output_and_lse():
    q, k, v, tgt, kb, sg = _inputs("key_bias")
    o_p, _ = _port_run("key_bias", q, k, v, tgt, kb, sg)
    o_j, _ = _jax_run("key_bias", q, k, v, tgt, kb, sg)
    # Batch row 1 has every key masked: O is exactly 0 on both.
    assert np.all(o_p[-1] == 0.0) and np.all(o_j[-1] == 0.0)
    h = q.shape[2]
    pack = lambda x: torch.tensor(x).permute(0, 2, 1, 3).reshape(
        -1, x.shape[1], x.shape[3]).contiguous()
    _, lse = pfa.flash_fwd(pack(q), pack(k), pack(v), torch.tensor(kb),
                           None, h, q.shape[-1] ** -0.5, False)
    assert torch.all(lse[h:] == -1e30)


def test_strict_causal_first_row_is_masked():
    q, k, v, tgt, kb, sg = _inputs("offset_minus1")
    o_p, _ = _port_run("offset_minus1", q, k, v, tgt, kb, sg)
    assert np.all(o_p[:, 0] == 0.0)


@pytest.mark.parametrize("case", ["causal", "everything", "ragged_cross"])
def test_plain_result_does_not_depend_on_tiles(case):
    q, k, v, tgt, kb, sg = _inputs(case, seed=2)
    o_a, g_a = _port_run(case, q, k, v, tgt, kb, sg, blocks=(4, 16))
    o_b, g_b = _port_run(case, q, k, v, tgt, kb, sg, blocks=(64, 64))
    np.testing.assert_allclose(o_a, o_b, **FWD_TOL)
    for a, b in zip(g_a, g_b):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_bias_without_grad_skips_dbias():
    q, k, v, tgt, kb, _ = _inputs("key_bias")
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = pfa.flash_attention(*ts, key_bias=torch.tensor(kb))
    o.sum().backward()
    assert all(t.grad is not None for t in ts)


def test_cpu_calls_count_no_kernel_launch():
    pfa.reset_launches()
    q, k, v, tgt, kb, sg = _inputs("causal")
    _port_run("causal", q, k, v, tgt, kb, sg)
    assert pfa.launches == {name: 0 for name in pfa.KERNELS}


_ERRORS = [
    # (q shape, k shape, kwargs for a framework module, message)
    ((1, 8, 2, 8), (1, 16, 2, 8), lambda b: {"causal": True},
     "causal flash attention needs t_q == t_kv"),
    ((1, 8, 2, 8), (1, 8, 2, 8),
     lambda b: {"key_bias": b.zeros((1, 7), dtype=b.float32)},
     "key_bias must be"),
    ((1, 8, 2, 8), (1, 16, 2, 8),
     lambda b: {"segment_ids": b.zeros((1, 8), dtype=b.int32)},
     "segment_ids require self-attention shapes"),
    ((1, 8, 2, 8), (1, 8, 2, 8),
     lambda b: {"segment_ids": b.zeros((2, 8), dtype=b.int32)},
     "segment_ids must be"),
]


@pytest.mark.parametrize("qs,ks,kw,msg", _ERRORS)
def test_argument_errors_match_reference(qs, ks, kw, msg):
    with pytest.raises(ValueError, match=msg):
        jax_flash(jnp.zeros(qs), jnp.zeros(ks), jnp.zeros(ks), **kw(jnp))
    with pytest.raises(ValueError, match=msg):
        pfa.flash_attention(torch.zeros(qs), torch.zeros(ks),
                            torch.zeros(ks), **kw(torch))


# ------------------------------------------------------ attention dispatch

@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("masks", ["none", "key_mask", "segments"])
def test_multihead_attention_matches_jax(impl, masks):
    g = np.random.default_rng(5)
    b, t, h, d = 2, 16, 2, 8
    q, k, v = (g.standard_normal((b, t, h, d)).astype(np.float32)
               for _ in range(3))
    kw_np = {}
    if masks == "key_mask":
        km = np.ones((b, t), bool)
        km[0, -5:] = False
        km[1, :] = False                      # a row with no visible key
        kw_np["key_mask"] = km
    if masks == "segments":
        kw_np["segment_ids"] = np.sort(
            g.integers(0, 3, (b, t)), axis=1).astype(np.int32)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   impl=impl, causal=True,
                   **{n: jnp.asarray(x) for n, x in kw_np.items()})
    got = patt.multihead_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), impl=impl,
        causal=True, **{n: torch.tensor(x) for n, x in kw_np.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_flash_refuses_2d_bias_and_unknown_impl():
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError, match="per-head 2-D attention bias"):
        patt.multihead_attention(q, q, q, impl="flash", causal=False,
                                 bias=torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="unknown attention impl"):
        patt.multihead_attention(q, q, q, impl="Flash", causal=False)


def test_packed_positions_match_jax():
    seg = np.array([[0, 0, 0, 1, 1, 2, 2, 2], [5, 5, 5, 5, 5, 5, 6, 6]],
                   np.int32)
    np.testing.assert_array_equal(
        patt.packed_positions(torch.tensor(seg)).numpy(),
        np.asarray(jax_packed(jnp.asarray(seg))))


# The kernels themselves (CUDA only) are checked against these plain versions
# on the card by tests/test_torch_port_card.py, which imports no JAX.
