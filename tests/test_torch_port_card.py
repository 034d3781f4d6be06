"""The port's CUDA kernels against their plain versions, and its models
and collectives on the card, on the card only.

Each test needs an NVIDIA GPU and nvcc (the kernels are built at first use)
and skips without them; the device tests need two cards, and Adasum over
NCCL two or four. The file imports
nothing of JAX, so it runs where only the port's dependencies are installed:

    python -m pytest tests/test_torch_port_card.py -q

Tolerances: the fp32 cases (FMA kernels) hold rtol = atol = 1e-5, the same
fp32 sums taken in another order. The bf16 cases (tensor-core kernels for the
forward, dQ and dK/dV) hold ``chip_smoke``'s bound: every element within
``BF16_TOL`` (2^-6 of itself + 1e-3 of the rms) and the rms error within
1e-2 of the rms; lse, fp32 whatever the input type, at ``F32_TOL``.
"""

import copy
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as pfa

REPO = pathlib.Path(__file__).resolve().parents[1]

# name -> (B, Tq, Tk, H, D, causal, offset, bias, seg, dtype)
CASES = {
    "causal": (2, 32, 32, 2, 8, True, 0, False, False, torch.float32),
    "everything": (2, 19, 19, 2, 8, True, -1, True, True, torch.float32),
    "ragged_cross": (1, 20, 28, 2, 8, False, 0, False, False,
                     torch.float32),
    "causal-bf16": (2, 128, 128, 2, 64, True, 0, False, False,
                    torch.bfloat16),
    "everything-bf16": (2, 150, 150, 2, 64, True, -1, True, True,
                        torch.bfloat16),
    "cross-bf16": (2, 77, 130, 2, 128, False, 0, True, False,
                   torch.bfloat16),
    # d 128 where the causal diagonal cuts the tiles: the 32-key passes of
    # the dQ kernel and the d-128 forward.
    "causal-d128-bf16": (2, 256, 256, 2, 128, True, 0, False, False,
                         torch.bfloat16),
    # A negative scale whose scores spread over more than 128 in log2 units:
    # the forward's unmasked softmax (max of the raw scores) would overflow.
    "negative-scale-bf16": (2, 256, 256, 2, 64, True, 0, False, False,
                            torch.bfloat16),
}

# Logit scale of a case, where it is not d ** -0.5.
SCALES = {"negative-scale-bf16": -4.0}


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(case, seed=0):
    """Packed (BH, T, D) q, k, v, dO, key bias and segment ids, from numpy."""
    b, tq, tk, h, d, causal, offset, bias, seg, dtype = CASES[case]
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, tq, h, d)).astype(np.float32)
    k = g.standard_normal((b, tk, h, d)).astype(np.float32)
    v = g.standard_normal((b, tk, h, d)).astype(np.float32)
    do = g.standard_normal((b, tq, h, d)).astype(np.float32)
    kb = sg = None
    if bias:
        kb = g.standard_normal((b, tk)).astype(np.float32)
        kb[:, -3:] = -1e30                      # padded keys
        kb[-1, :] = -1e30                       # every key of a row masked
    if seg:
        sg = np.sort(g.integers(0, 3, (b, tq)), axis=1).astype(np.int32)

    def pack(x):
        return torch.tensor(x).permute(0, 2, 1, 3).reshape(
            -1, x.shape[1], x.shape[3]).contiguous().to(dtype)

    return (pack(q), pack(k), pack(v), pack(do),
            None if kb is None else torch.tensor(kb),
            None if sg is None else torch.tensor(sg))


def _check_case(case, device):
    """Runs the three kernels and their plain versions on ``device`` and
    asserts that they agree."""
    b, tq, tk, h, d, causal, offset, bias, seg, dtype = CASES[case]
    q, k, v, do, kb, sg = (None if x is None else x.to(device)
                           for x in _inputs(case))
    scale = SCALES.get(case, d ** -0.5)
    o, lse = pfa.flash_fwd(q, k, v, kb, sg, h, scale, causal, offset)
    o_p, lse_p = pfa.flash_fwd_plain(q, k, v, kb, sg, h, scale, causal,
                                     offset)
    delta = (do.float() * o_p.float()).sum(-1)
    dq = pfa.flash_bwd_dq(q, k, v, kb, sg, do, lse_p, delta, h, scale,
                          causal, offset)
    dq_p = pfa.flash_bwd_dq_plain(q, k, v, kb, sg, do, lse_p, delta, h,
                                  scale, causal, offset)
    dkv = pfa.flash_bwd_dkv(q, k, v, kb, sg, do, lse_p, delta, h, scale,
                            causal, offset)
    dkv_p = pfa.flash_bwd_dkv_plain(q, k, v, kb, sg, do, lse_p, delta, h,
                                    scale, causal, offset)
    torch.cuda.synchronize(device)
    for x in (o, lse, dq) + tuple(t for t in dkv if t is not None):
        assert x.device == q.device
    if dtype == torch.float32:
        pairs = [(o, o_p), (lse, lse_p), (dq, dq_p)] + list(zip(dkv, dkv_p))
        for a, want in pairs:
            if a is None:
                assert want is None
                continue
            np.testing.assert_allclose(a.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
        return
    live = lse_p > -1e29
    assert torch.equal(live, lse > -1e29)
    checks = [("O", o, o_p, chip_smoke.BF16_TOL),
              ("lse", lse[live], lse_p[live], chip_smoke.F32_TOL),
              ("dQ", dq, dq_p, chip_smoke.BF16_TOL),
              ("dK", dkv[0], dkv_p[0], chip_smoke.BF16_TOL),
              ("dV", dkv[1], dkv_p[1], chip_smoke.BF16_TOL)]
    if bias:
        checks.append(("dbias", dkv[2], dkv_p[2], chip_smoke.BF16_TOL))
        # The last batch row sees no key: O = 0 and lse = -1e30 exactly.
        assert o[(b - 1) * h:].abs().max().item() == 0.0
        assert lse[(b - 1) * h:].max().item() <= -1e29
    for name, got, want, tol in checks:
        err, worst, rel, ok = chip_smoke._stats(got, want, tol)
        assert ok, (f"{case} {name}: max err {err:.3e}, max err/bound "
                    f"{worst:.3f}, rms err/rms {rel:.3e}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_on_card(cuda_card, case):
    _check_case(case, cuda_card)


def test_kernels_launch_on_the_inputs_device():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    before = dict(pfa.launches)
    with torch.cuda.device(0):
        _check_case("everything-bf16", torch.device("cuda:1"))
        _check_case("everything", torch.device("cuda:1"))
        assert torch.cuda.current_device() == 0
    assert all(pfa.launches[k] == before[k] + 2 for k in pfa.KERNELS)


def test_kernels_refuse_plain_tiles_on_card(cuda_card):
    q = torch.zeros((1, 16, 2, 8), device=cuda_card)
    with pytest.raises(ValueError, match="tile only the plain versions"):
        pfa.flash_attention(q, q, q, block_q=8)
    with pytest.raises(ValueError, match="tile only the plain versions"):
        pfa.flash_attention(q, q, q, block_k_bwd=8)


def test_bf16_kernels_refuse_misaligned_inputs(cuda_card):
    q = torch.zeros((2, 16, 8), dtype=torch.bfloat16, device=cuda_card)
    off = torch.zeros(2 * 16 * 8 + 1, dtype=torch.bfloat16,
                      device=cuda_card)[1:].view(2, 16, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfa.flash_fwd(off, q, q, None, None, 1, 1.0, False)


# --------------------------------------------------- models and collectives

def _assert_bn_close(got, want, tol):
    """The CPU tests' tolerance for what passes through BNs: ``tol`` =
    (rtol, atol), atol at least ``chip_smoke.BN_SCALE`` of max |want|."""
    g, w = got.detach().float().cpu().numpy(), want.detach().float().numpy()
    atol = max(tol[1], chip_smoke.BN_SCALE * np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=tol[0], atol=atol)


@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_tiny_resnet_on_card_matches_cpu(cuda_card, block, stem):
    """A tiny fp32 ResNet (TF32 off) on the card against the same on the
    CPU: logits, every gradient and the running statistics, in train
    mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = chip_smoke._tiny_resnet(block, stem)
    card = copy.deepcopy(cpu).to(cuda_card).to(
        memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 3, 32, 32, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    want = cpu(x)
    F.cross_entropy(want, y).backward()
    got = card(x.to(cuda_card).to(memory_format=torch.channels_last))
    F.cross_entropy(got, y.to(cuda_card)).backward()
    _assert_bn_close(got, want, chip_smoke.LOGIT_TOL)
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        _assert_bn_close(p.grad, q.grad, chip_smoke.GRAD_TOL)
    for a, b in zip(card.buffers(), cpu.buffers()):
        _assert_bn_close(a, b, chip_smoke.LOGIT_TOL)


_SBN_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()                                   # this rank's card, NCCL
    r, n = hvd.rank(), hvd.size()
    data = np.load(sys.argv[2])
    h = data["x"].shape[0] // n
    x = torch.tensor(data["x"][r * h:(r + 1) * h], device=hvd.device(),
                     requires_grad=True)
    w = torch.tensor(data["w"][r * h:(r + 1) * h], device=hvd.device())
    sbn = hvd.SyncBatchNorm(3, momentum=0.1).to(hvd.device())
    y = sbn(x)
    (y * w).sum().backward()
    np.savez(sys.argv[3] + f".rank{r}.npz", y=y.detach().cpu().numpy(),
             dx=x.grad.cpu().numpy(),
             running_var=sbn.running_var.cpu().numpy())
    hvd.shutdown()
""")


def test_sync_batch_norm_on_two_cards(tmp_path):
    """hvd.SyncBatchNorm over two ranks on two cards (NCCL) == torch's
    BatchNorm2d over the whole batch on the CPU."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    g = np.random.default_rng(0)
    x = (g.standard_normal((8, 3, 6, 6)) * 1.5 + 0.3).astype(np.float32)
    w = g.standard_normal((8, 3, 6, 6)).astype(np.float32)
    script = tmp_path / "worker.py"
    script.write_text(_SBN_WORKER)
    np.savez(tmp_path / "data.npz", x=x, w=w)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), str(REPO),
         str(tmp_path / "data.npz"), str(out)], cwd=REPO,
        env=dict(os.environ), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    xt = torch.tensor(x, requires_grad=True)
    bn = torch.nn.BatchNorm2d(3, momentum=0.1)
    yt = bn(xt)
    (yt * torch.tensor(w)).sum().backward()
    for rank in range(2):
        res = np.load(f"{out}.rank{rank}.npz")
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(res["y"], yt[rows].detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["dx"], xt.grad[rows].numpy(),
                                   rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(res["running_var"],
                                   bn.running_var.numpy(), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------ Adasum over NCCL

_ADASUM_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd

    hvd.init()                                   # this rank's card, NCCL
    r, n = hvd.rank(), hvd.size()
    data = np.load(sys.argv[2])
    x = torch.tensor(data["x"][r], device=hvd.device())
    # The first collective on each group is an Adasum: its point-to-point
    # ops need the group's communicator made first.
    out = {"global": hvd.allreduce(x, op=hvd.Adasum),
           "bf16": hvd.allreduce(x.to(torch.bfloat16), op=hvd.Adasum)}
    if n == 4:
        ps = hvd.add_process_set([0, 1, 2])
        out["k3"] = hvd.allreduce(x, op=hvd.Adasum, process_set=ps)
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.float().cpu().numpy() for k, v in out.items()})
    hvd.shutdown()
""")


def _adasum64(xs):
    """Adasum of the rows of ``xs`` in float64 with the port's order of
    combination: pre-pairing of the extra ranks, then recursive doubling
    among the first power of two."""
    def combine(a, b):
        dot = a @ b
        ca = 1 - dot / (2 * (a @ a)) if a @ a > 0 else 1.0
        cb = 1 - dot / (2 * (b @ b)) if b @ b > 0 else 1.0
        return ca * a + cb * b
    xs = [x.astype(np.float64) for x in xs]
    k = len(xs)
    p = 1 << (k.bit_length() - 1)
    ys = [combine(xs[i], xs[p + i]) if i < k - p else xs[i]
          for i in range(p)]
    d = 1
    while d < p:
        ys = [combine(ys[i], ys[i ^ d]) for i in range(p)]
        d *= 2
    return ys[0]


@pytest.mark.parametrize("nranks", [2, 4])
def test_adasum_over_nccl_matches_cpu(tmp_path, nranks):
    """Adasum of 1 M-element fp32 vectors (and their bf16 roundings) over
    two and four NCCL ranks, each on its card, against float64 on the CPU;
    on four ranks also over the set {0, 1, 2} (pre-pairing and the
    post-broadcast). Tolerances: 1e-5 of the largest element in fp32, and
    one bf16 rounding (2^-8 relative) more for bf16."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < nranks:
        pytest.skip(f"needs {nranks} CUDA cards")
    g = np.random.default_rng(nranks)
    x = g.standard_normal((nranks, 2 ** 20)).astype(np.float32)
    x[1] += 0.5 * x[0]
    script = tmp_path / "worker.py"
    script.write_text(_ADASUM_WORKER)
    np.savez(tmp_path / "data.npz", x=x)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(nranks), "--timeout", "240", str(script), str(REPO),
         str(tmp_path / "data.npz"), str(out)], cwd=REPO,
        env=dict(os.environ), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    bf = torch.tensor(x).bfloat16().float().numpy()
    want = {"global": _adasum64(x), "bf16": _adasum64(bf),
            "k3": _adasum64(x[:3])}
    for rank in range(nranks):
        res = np.load(f"{out}.rank{rank}.npz")
        for name in res.files:
            w = want[name] if name != "k3" or rank < 3 else x[rank]
            top = np.abs(w).max()
            rtol = 2 ** -8 if name == "bf16" else 0.0
            np.testing.assert_allclose(res[name], w, rtol=rtol,
                                       atol=1e-5 * top,
                                       err_msg=f"rank {rank} {name}")


# ------------------------------------------------- the controller over NCCL

@pytest.mark.parametrize("nranks", [2, 4])
def test_controller_over_nccl(nranks):
    """``tools/torch_controller_bench.py`` on ``nranks`` NCCL ranks, each on
    its card: the join service with the reference's averages widened to N
    ranks, a mismatch that raises on every rank with no data-plane work
    issued, and per-rank timeline shards whose op ids line up."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < nranks:
        pytest.skip(f"needs {nranks} CUDA cards")
    import json
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_controller_bench.py"),
         "--np", str(nranks)], cwd=REPO, env=dict(os.environ),
        capture_output=True, text=True, timeout=600)
    assert r.returncode in (0, 1), r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"], out["failed"]
    assert out["ranks"] == nranks and out["device"] == "cuda"
