"""The precision rule of the bf16 tensor-core flash kernels, pinned on the CPU.

The tensor cores multiply bf16 operands. Q, K, V and dO are bf16 already, but
P (forward and dV) and dS (dQ and dK) are fp32. The kernels feed each of them
as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), and sum both products
in fp32. This test emulates both choices in plain PyTorch, fp32 products of
the bf16 operands, and holds each against the plain version of the kernels with
``chip_smoke``'s own check (``_stats`` at ``BF16_TOL``, the bound the kernels
meet on the card): rounding P and dS to bf16 once must fail it on O, dQ, dK
and dV, and the hi/lo split must pass it. A later change that rounds once to
save the second product breaks this test.

Shape: BH 4 (B 1, H 4), T 256, d 64, causal, bf16 inputs from a numpy seed.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as pfa

B, H, T, D = 1, 4, 256, 64


def _inputs(seed=0):
    g = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(g.standard_normal((B * H, T, D)),
                                dtype=torch.float32).to(torch.bfloat16)
                   for _ in range(4))
    return q, k, v, do


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _product(a, b, split):
    """a @ b with fp32 ``a`` fed to the tensor cores as bf16: hi + lo parts
    when ``split``, else one rounding. ``b`` is bf16-exact already."""
    hi = _bf16(a)
    out = hi @ b
    if split:
        out = out + _bf16(a - hi) @ b
    return out


def _emulate(q, k, v, do, lse, delta, scale, split):
    """O, dK, dV and dQ as the kernels compute them, with P and dS rounded as
    ``split`` says; every other step in fp32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = (qf @ kf.transpose(1, 2)) * scale
    causal = torch.ones(T, T, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(causal, torch.exp(s - m), torch.zeros_like(s))
    o = _product(p, vf, split) / p.sum(dim=-1, keepdim=True)
    # Backward: P from the saved lse, dS = P (dP - delta).
    p = torch.where(causal, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    dv = _product(p.transpose(1, 2), dof, split)
    dk = _product(ds.transpose(1, 2), qf, split) * scale
    dq = _product(ds, kf, split) * scale
    return [x.to(torch.bfloat16) for x in (o, dk, dv, dq)]


@pytest.fixture(scope="module")
def outputs():
    q, k, v, do = _inputs()
    scale = D ** -0.5
    o, lse = pfa.flash_fwd_plain(q, k, v, None, None, H, scale, True)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv, _ = pfa.flash_bwd_dkv_plain(q, k, v, None, None, do, lse, delta,
                                        H, scale, True)
    dq = pfa.flash_bwd_dq_plain(q, k, v, None, None, do, lse, delta, H,
                                scale, True)
    plain = (o, dk, dv, dq)
    got = {split: _emulate(q, k, v, do, lse, delta, scale, split)
           for split in (False, True)}
    return plain, got


@pytest.mark.parametrize("index,name", [(0, "O"), (1, "dK"), (2, "dV"),
                                        (3, "dQ")])
def test_one_bf16_rounding_fails_the_kernel_check(outputs, index, name):
    plain, got = outputs
    err, worst, rel, ok = chip_smoke._stats(got[False][index], plain[index],
                                            chip_smoke.BF16_TOL)
    assert not ok, (f"{name}: one bf16 rounding of P/dS passed the check "
                    f"(max err/bound {worst:.3f}, rms {rel:.2e})")
    assert worst > 2.0, f"{name}: max err/bound only {worst:.3f}"


@pytest.mark.parametrize("index,name", [(0, "O"), (1, "dK"), (2, "dV"),
                                        (3, "dQ")])
def test_hi_lo_split_passes_the_kernel_check(outputs, index, name):
    plain, got = outputs
    err, worst, rel, ok = chip_smoke._stats(got[True][index], plain[index],
                                            chip_smoke.BF16_TOL)
    assert ok, (f"{name}: the hi/lo split failed the check (max err/bound "
                f"{worst:.3f}, rms {rel:.2e})")
