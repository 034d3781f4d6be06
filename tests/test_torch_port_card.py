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
import importlib
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
pfa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

REPO = pathlib.Path(__file__).resolve().parents[1]

# name -> (B, Tq, Tk, H, D, causal, offset, bias, seg, dtype); seg "split"
# gives the keys their own ids (a ring hop's resident block) and the queries
# packed ones.
CASES = {
    "causal": (2, 32, 32, 2, 8, True, 0, False, False, torch.float32),
    "everything": (2, 19, 19, 2, 8, True, -1, True, True, torch.float32),
    "ragged_cross": (1, 20, 28, 2, 8, False, 0, False, False,
                     torch.float32),
    "causal-bf16": (2, 128, 128, 2, 64, True, 0, False, False,
                    torch.bfloat16),
    "everything-bf16": (2, 150, 150, 2, 64, True, -1, True, True,
                        torch.bfloat16),
    "split-seg": (2, 19, 19, 2, 8, True, -1, True, "split", torch.float32),
    "split-seg-bf16": (2, 150, 150, 2, 64, True, -1, False, "split",
                       torch.bfloat16),
    "split-seg-full-bf16": (2, 130, 130, 2, 64, False, 0, True, "split",
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
    """Packed (BH, T, D) q, k, v, dO, key bias and the queries' and keys'
    segment ids, from numpy."""
    b, tq, tk, h, d, causal, offset, bias, seg, dtype = CASES[case]
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, tq, h, d)).astype(np.float32)
    k = g.standard_normal((b, tk, h, d)).astype(np.float32)
    v = g.standard_normal((b, tk, h, d)).astype(np.float32)
    do = g.standard_normal((b, tq, h, d)).astype(np.float32)
    kb = sg = sg_k = None
    if bias:
        kb = g.standard_normal((b, tk)).astype(np.float32)
        kb[:, -3:] = -1e30                      # padded keys
        kb[-1, :] = -1e30                       # every key of a row masked
    if seg:
        sg = np.sort(g.integers(0, 3, (b, tq)), axis=1).astype(np.int32)
        sg_k = sg
        if seg == "split":
            sg_k = np.sort(g.integers(1, 4, (b, tk)), axis=1).astype(np.int32)

    def pack(x):
        return torch.tensor(x).permute(0, 2, 1, 3).reshape(
            -1, x.shape[1], x.shape[3]).contiguous().to(dtype)

    return (pack(q), pack(k), pack(v), pack(do),
            None if kb is None else torch.tensor(kb),
            None if sg is None else torch.tensor(sg),
            None if sg_k is None else torch.tensor(sg_k))


def _check_case(case, device):
    """Runs the three kernels and their plain versions on ``device`` and
    asserts that they agree."""
    b, tq, tk, h, d, causal, offset, bias, seg, dtype = CASES[case]
    q, k, v, do, kb, sg, sk = (None if x is None else x.to(device)
                               for x in _inputs(case))
    scale = SCALES.get(case, d ** -0.5)
    o, lse = pfa.flash_fwd(q, k, v, kb, sg, sk, h, scale, causal, offset)
    o_p, lse_p = pfa.flash_fwd_plain(q, k, v, kb, sg, sk, h, scale, causal,
                                     offset)
    delta = (do.float() * o_p.float()).sum(-1)
    dq = pfa.flash_bwd_dq(q, k, v, kb, sg, sk, do, lse_p, delta, h, scale,
                          causal, offset)
    dq_p = pfa.flash_bwd_dq_plain(q, k, v, kb, sg, sk, do, lse_p, delta, h,
                                  scale, causal, offset)
    dkv = pfa.flash_bwd_dkv(q, k, v, kb, sg, sk, do, lse_p, delta, h, scale,
                            causal, offset)
    dkv_p = pfa.flash_bwd_dkv_plain(q, k, v, kb, sg, sk, do, lse_p, delta, h,
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


def test_flash_attention_takes_batch_one_on_card(cuda_card):
    """At batch 1 the packed heads reach the kernels contiguous: fp32
    flash_attention on the card equals its plain version on the CPU
    (forward and every gradient; rtol = atol = 1e-5 as the fp32 cases)."""
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn(1, 96, 4, 32, generator=g) for _ in range(4))
    outs = []
    for dev in ("cpu", cuda_card):
        qq, kk, vv = (x.to(dev).detach().requires_grad_(True)
                      for x in (q, k, v))
        o = pfa.flash_attention(qq, kk, vv, causal=True)
        o.backward(do.to(dev))
        outs.append([x.detach().cpu() for x in (o, qq.grad, kk.grad,
                                                 vv.grad)])
    for want, got in zip(*outs):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_bf16_kernels_refuse_misaligned_inputs(cuda_card):
    q = torch.zeros((2, 16, 8), dtype=torch.bfloat16, device=cuda_card)
    off = torch.zeros(2 * 16 * 8 + 1, dtype=torch.bfloat16,
                      device=cuda_card)[1:].view(2, 16, 8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pfa.flash_fwd(off, q, q, None, None, None, 1, 1.0, False)


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


# ------------------------------------------ the flash ring and Ulysses

_SP_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import ring_flash_attention, ulysses_attention

    hvd.init()                                   # this rank's card, NCCL
    r, n = hvd.rank(), hvd.size()
    data = np.load(sys.argv[2])
    dev = hvd.device()
    out = {}
    for name, layout in (("contiguous", "contiguous"),
                         ("striped", "striped"), ("ulysses", None)):
        t = data["q"].shape[1] // n
        cols = (slice(r, None, n) if layout == "striped"
                else slice(r * t, (r + 1) * t))
        q, k, v = (torch.tensor(data[x][:, cols], device=dev)
                   .to(torch.bfloat16).requires_grad_(True) for x in "qkv")
        do = torch.tensor(data["do"][:, cols], device=dev).to(torch.bfloat16)
        seg = (torch.tensor(data["seg"][:, cols], device=dev)
               if name == "contiguous" else None)
        if layout is None:
            o = ulysses_attention(q, k, v, causal=True, impl="flash")
        else:
            o = ring_flash_attention(q, k, v, causal=True, layout=layout,
                                     segment_ids=seg)
        o.backward(do)
        for key, x in (("o", o), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
            out[f"{name}:{key}"] = x.detach().float().cpu().numpy()
    np.savez(sys.argv[3] + f".rank{r}.npz", **out)
    hvd.shutdown()
""")


def _virtual_ring(q, k, v, do, n, layout, seg):
    """The flash ring of n ranks through ``ring_flash``'s per-hop functions
    on one card, in the ring's order: (O, dQ, dK, dV) of each rank."""
    from horovod_tpu_torch.ops import ring_flash as rf
    t = q.shape[1] // n

    def shards(x):
        return [(x[:, r::n] if layout == "striped"
                 else x[:, r * t:(r + 1) * t]).contiguous()
                for r in range(n)]
    Q, K, V, DO = ([rf._pack(x) for x in shards(y)] for y in (q, k, v, do))
    S = shards(seg) if seg is not None else [None] * n
    h, scale, striped = q.shape[2], q.shape[3] ** -0.5, layout == "striped"
    o = [torch.zeros(x.shape, device=x.device) for x in Q]
    lse = [torch.full(x.shape[:2], -1e30, device=x.device) for x in Q]
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            hop = rf.fwd_hop(Q[r], (K[src], V[src], None, S[src]), S[r], src,
                             r, h, scale, True, striped)
            if hop is not None:
                o[r], lse[r] = rf.safe_merge(o[r], lse[r], *hop)
    o = [x.to(q.dtype) for x in o]
    delta = [(DO[r].float() * o[r].float()).sum(-1) for r in range(n)]
    dq, dk, dv = ([torch.zeros(x.shape, device=x.device) for x in Q]
                  for _ in range(3))
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            hop = rf.bwd_hop(Q[r], (K[src], V[src], None, S[src]), S[r],
                             DO[r], lse[r], delta[r], src, r, h, scale, True,
                             striped)
            if hop is not None:
                dq[r] += hop[0]
                dk[src] += hop[1]
                dv[src] += hop[2]
    b = q.shape[0]
    return [[rf._unpack(x.to(q.dtype), b, h).float().cpu().numpy()
             for x in xs] for xs in (o, dq, dk, dv)]


def test_flash_ring_and_ulysses_on_two_cards(tmp_path):
    """Two NCCL ranks on two cards, B 1, H 4, T 1024, d 64, bf16, causal:
    the flash ring (contiguous with packed segment ids, and striped) equals
    the same hops run as virtual ranks on one card bit for bit (the same
    kernels on the same blocks, summed in the same order), and Ulysses
    equals one-card ``flash_attention`` over the whole sequence bit for bit
    (the all-to-alls only move heads)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    g = np.random.default_rng(10)
    b, t, h, d = 1, 1024, 4, 64
    data = {x: g.standard_normal((b, t, h, d)).astype(np.float32)
            for x in ("q", "k", "v", "do")}
    data["seg"] = np.sort(g.integers(0, 3, (b, t)), axis=1).astype(np.int32)
    script = tmp_path / "worker.py"
    script.write_text(_SP_WORKER)
    np.savez(tmp_path / "data.npz", **data)
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), str(REPO),
         str(tmp_path / "data.npz"), str(out)], cwd=REPO,
        env=dict(os.environ), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = [np.load(f"{out}.rank{i}.npz") for i in range(2)]
    dev = torch.device("cuda:0")
    q, k, v, do = (torch.tensor(data[x], device=dev).to(torch.bfloat16)
                   for x in ("q", "k", "v", "do"))
    seg = torch.tensor(data["seg"], device=dev)
    for name, layout in (("contiguous", "contiguous"),
                         ("striped", "striped")):
        want = _virtual_ring(q, k, v, do, 2, layout,
                             seg if name == "contiguous" else None)
        for key, parts in zip(("o", "dq", "dk", "dv"), want):
            for rank in range(2):
                np.testing.assert_array_equal(
                    ranks[rank][f"{name}:{key}"], parts[rank],
                    err_msg=f"{name} {key} rank {rank}")
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = pfa.flash_attention(qq, kk, vv, causal=True)
    o.backward(do)
    for key, x in (("o", o), ("dq", qq.grad), ("dk", kk.grad),
                   ("dv", vv.grad)):
        whole = x.detach().float().cpu().numpy()
        got = np.concatenate([ranks[i][f"ulysses:{key}"] for i in range(2)],
                             axis=1)
        np.testing.assert_array_equal(got, whole, err_msg=f"ulysses {key}")


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


# ------------------------------------- the allreduce algorithm axis over NCCL

_ALG_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import overlap

    hvd.init()                                   # this rank's card, NCCL
    r, n = hvd.rank(), hvd.size()
    data = np.load(sys.argv[2])
    x = torch.tensor(data["x"][r], device=hvd.device())
    out = {"topology": torch.tensor(hvd.topology())}
    for alg in overlap.ALGORITHMS:
        for wire in overlap.WIRES:
            for oname, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
                out[f"{alg}_{wire}_{oname}"] = hvd.allreduce(
                    x, op=op, algorithm=alg, wire=wire, overlap_chunks=3)
    # overlap=True: the hooks run on the autograd engine's device thread.
    for tag, ov in (("plain", False), ("overlap", True)):
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(),
                                torch.nn.Linear(256, 64)).to(hvd.device())
        hvd.broadcast_parameters(m.state_dict(), 0)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                       lr=0.1),
                                       overlap=ov, fusion_threshold_bytes=4096)
        for step in range(3):
            inp = torch.tensor(data["inp"][r, step], device=hvd.device())
            opt.zero_grad()
            m(inp).square().mean().backward()
            opt.step()
        out[f"model_{tag}"] = torch.cat([p.detach().reshape(-1)
                                         for p in m.parameters()])
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.float().cpu().numpy() for k, v in out.items()})
    hvd.shutdown()
""")


@pytest.mark.parametrize("nranks", [2, 4])
def test_algorithms_over_nccl_match_psum(tmp_path, nranks):
    """Every algorithm x wire, Sum and Average, of 2^16 fp32 values a rank
    over two NCCL ranks and over four under ``HOROVOD_TOPOLOGY=2x2`` (the
    ``_2d`` forms run two phases), against ``psum`` in the same world,
    within the CPU tests' tolerances (``tests/test_torch_port_algorithms.py``:
    fp32 rtol 2e-6 / atol 1e-5, the bf16 wire 2e-2 / 2e-2, the quantized
    wires three half-steps of the largest value a contribution); the
    quantized forms and ``swing`` give every rank the same bits; and a small
    model trained 3 steps with ``overlap=True`` ends where ``overlap=False``
    ends."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < nranks:
        pytest.skip(f"needs {nranks} CUDA cards")
    from horovod_tpu_torch import overlap
    g = np.random.default_rng(nranks)
    x = g.standard_normal((nranks, 2 ** 16)).astype(np.float32)
    inp = g.standard_normal((nranks, 3, 8, 64)).astype(np.float32)
    script = tmp_path / "worker.py"
    script.write_text(_ALG_WORKER)
    np.savez(tmp_path / "data.npz", x=x, inp=inp)
    out = tmp_path / "out"
    env = dict(os.environ)
    if nranks == 4:
        env["HOROVOD_TOPOLOGY"] = "2x2"
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(nranks), "--timeout", "400", str(script), str(REPO),
         str(tmp_path / "data.npz"), str(out)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=450)
    assert r.returncode == 0, r.stderr[-3000:]
    res = [np.load(f"{out}.rank{i}.npz") for i in range(nranks)]
    assert tuple(res[0]["topology"]) == ((2, 2) if nranks == 4 else (2,))
    top = float(np.abs(x).max())
    for rank in range(nranks):
        for oname in ("sum", "avg"):
            base = res[rank][f"psum_fp32_{oname}"]
            k = nranks if oname == "sum" else 1
            for alg in overlap.ALGORITHMS:
                for wire in overlap.WIRES:
                    got = res[rank][f"{alg}_{wire}_{oname}"]
                    qw = overlap.parse_algorithm(alg)[1]
                    msg = f"rank {rank} {alg} {wire} {oname}"
                    if qw is not None:
                        bound = 3.0 * k * top / (127 if qw == "int8" else 8)
                        if wire == "bf16":
                            bound += 0.1 * k
                        assert np.abs(got - base).max() < bound, msg
                    elif wire == "bf16":
                        np.testing.assert_allclose(got, base, rtol=2e-2,
                                                   atol=2e-2 * k, err_msg=msg)
                    else:
                        np.testing.assert_allclose(got, base, rtol=2e-6,
                                                   atol=1e-5, err_msg=msg)
                    if qw is not None or alg == "swing":
                        np.testing.assert_array_equal(
                            got, res[0][f"{alg}_{wire}_{oname}"], msg)
        np.testing.assert_allclose(res[rank]["model_overlap"],
                                   res[rank]["model_plain"], rtol=1e-6,
                                   atol=1e-7)


# ------------------------------------------- elastic training and checkpoints

def test_sharded_save_snapshots_before_an_in_place_change(cuda_card,
                                                          tmp_path):
    """``ShardedCheckpointManager.save`` of card tensors starts the
    device-to-host copies on a side stream behind an event of the caller's
    stream and returns: the file holds the values the caller's queued work
    gave the tensors (an add queued behind a device sleep), not the in-place
    change the caller queues right after ``save()``; bf16 travels as its
    raw words. Exact equality."""
    from horovod_tpu_torch import checkpoint_sharded as cs
    g = torch.Generator(device=cuda_card).manual_seed(0)
    x = torch.randn(2, 1 << 21, device=cuda_card, generator=g)
    b = torch.randn(3, 5, device=cuda_card, generator=g).to(torch.bfloat16)
    want_x, want_b = (x + 1).cpu(), b.cpu()
    m = cs.ShardedCheckpointManager(str(tmp_path / "c"))
    torch.cuda._sleep(20_000_000)        # the add below waits behind this
    x.add_(1)
    m.save(1, shards={"x": x}, replicated={"b": b})
    x.mul_(0)                            # after save() returned
    b.zero_()
    m.wait()
    r = m.restore()
    assert torch.equal(r.shards["['x']"], want_x)
    assert r.replicated["['b']"].dtype == torch.bfloat16
    assert torch.equal(r.replicated["['b']"], want_b)
    m.close()


@pytest.mark.parametrize("family", ["gpt2", "llama", "t5"])
def test_bf16_decode_matches_forward_on_card(cuda_card, family):
    """Tiny bf16 models decoded through the KV cache on the card: the
    logits at every position within the reference's bound (atol 0.02,
    ``tests/test_generate.py``) of the dense training forward's over the
    same tokens."""
    from horovod_tpu_torch.models import generate as G
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.models.t5 import T5, T5Config
    g = torch.Generator(device=cuda_card).manual_seed(0)
    tok = torch.randint(1, 256, (4, 24), generator=g, device=cuda_card)
    with torch.device(cuda_card):
        m = {"gpt2": lambda: GPT2(GPT2Config.tiny(), g),
             "llama": lambda: Llama(LlamaConfig.tiny(), g),
             "t5": lambda: T5(T5Config.tiny(), g)}[family]()
    step = G.decode_step(m.cfg)
    cache = G.init_cache(m.cfg, 4, 24, device=cuda_card)
    extras = None
    with torch.no_grad():
        if family == "t5":
            mask = tok != 0
            extras = {"cross": G.t5_encode(m, m.cfg, tok, mask),
                      "src_mask": mask,
                      "dec_bias": G.t5_decoder_bias(m.cfg, m, 24)}
            fwd = m(tok, tok)
        else:
            fwd = m(tok)
    for t in range(24):
        cache, logits = step(m, cache, tok[:, t], t, extras)
        torch.testing.assert_close(logits, fwd[:, t], rtol=0, atol=0.02)


def test_elastic_two_ranks_over_nccl():
    """``chip_smoke.py`` phase 8 (c): GPT-2 medium under ``run_elastic`` on
    two ranks, each on its card: a golden run, then ``kill@rank=1,step=3``
    without a spare (the world shrinks to one rank and resumes from a
    manifest written at two: losses within ``SHRINK_LOSS_TOL`` of the
    golden run's) and with one (the spare, holding no CUDA context while it
    waits, is promoted onto GPU 1: losses within ``LOSS_TOL``)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from horovod_tpu_torch.ops import _build
    _build.build()           # once, before the workers load the kernels
    out = chip_smoke.two_rank_elastic(steps=4)
    print(out)
    assert out["spares_1"]["world_after"] == 2
    assert out["spares_0"]["world_after"] == 1


def test_sharded_adamw_on_card_matches_cpu(cuda_card):
    """ZeRO-1 on a one-rank NCCL world against the same three steps on a
    one-rank gloo world on the CPU: fp32 and bf16 leaves, weight decay;
    the rows within rtol 1e-6 (CUDA's ``pow`` and ``sqrt`` may round an
    ulp apart from the CPU's), the step counter exactly."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optimizer_sharded import sharded_adamw
    g = np.random.default_rng(3)
    shapes = {"b": (7,), "a": (5, 3), "c": (2, 4)}
    dtypes = {"b": torch.bfloat16, "a": torch.float32, "c": torch.float32}
    p0 = {k: g.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: g.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]

    def run(device):
        def tree(d):
            return {k: torch.tensor(v).to(dtypes[k]).to(device)
                    for k, v in d.items()}
        opt = sharded_adamw(1e-2, weight_decay=0.1)
        p = tree(p0)
        st = opt.init(p)
        for grads in gs:
            u, st = opt.update(tree(grads), st, p)
            p = {k: p[k] + u[k] for k in p}
        return ({k: v.float().cpu() for k, v in p.items()},
                [t.cpu() for t in st])

    hvd.init()
    try:
        assert hvd.backend() == "nccl"
        card = run(hvd.device())
    finally:
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        cpu = run("cpu")
    finally:
        hvd.shutdown()
    assert torch.equal(card[1][0], cpu[1][0])
    for a, b in zip(card[1][1:], cpu[1][1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    for k in shapes:
        tol = (dict(rtol=2 ** -7, atol=1e-6) if dtypes[k] == torch.bfloat16
               else dict(rtol=1e-6, atol=1e-7))
        torch.testing.assert_close(card[0][k], cpu[0][k], **tol)


def _one_rank(device, fn):
    """``fn()`` on a one-rank world: NCCL on the card, gloo on the CPU."""
    import horovod_tpu_torch as hvd
    hvd.init(device=None if device == "cuda" else "cpu")
    try:
        return fn(hvd.device())
    finally:
        hvd.shutdown()


def test_fsdp_apply_on_card_matches_cpu(cuda_card):
    """``fsdp_apply`` of an fp32 MLP block on a one-rank NCCL world
    against the same call on a one-rank gloo world: the output and the
    row's gradient within rtol 1e-5, atol 1e-6 (cuBLAS and the CPU sum in
    other orders)."""
    from horovod_tpu_torch.parallel import fsdp
    g = np.random.default_rng(4)
    p0 = {"w1": g.standard_normal((16, 32)), "b1": g.standard_normal(32),
          "w2": g.standard_normal((32, 16)), "b2": g.standard_normal(16)}
    x0 = g.standard_normal((4, 16))

    def run(dev):
        p = {k: torch.tensor(v, dtype=torch.float32, device=dev) * 0.3
             for k, v in p0.items()}
        row = fsdp.fsdp_shard_params(p).requires_grad_()
        y = fsdp.fsdp_apply(
            lambda q, x: x + torch.relu(x @ q["w1"] + q["b1"]) @ q["w2"]
            + q["b2"], p, row, torch.tensor(x0, dtype=torch.float32,
                                            device=dev))
        (y ** 2).mean().backward()
        return y.detach().cpu(), row.grad.cpu()

    card, cpu = _one_rank("cuda", run), _one_rank("cpu", run)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_gather_shard_int8_on_card_matches_cpu(cuda_card):
    """``gather_shard(wire="int8")`` of a row with a ragged scale tail on
    the card equals the CPU's bit for bit (the quantizer divides by
    tensors, so its codes and scales are the CPU's)."""
    from horovod_tpu_torch.parallel import mp
    x0 = np.random.default_rng(5).standard_normal(300).astype(np.float32)

    def run(dev):
        return mp.gather_shard(torch.tensor(x0, device=dev),
                               wire="int8").cpu()

    card, cpu = _one_rank("cuda", run), _one_rank("cpu", run)
    assert torch.equal(card, cpu)
    assert not torch.equal(card, torch.tensor(x0))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_tensor_parallel_at_mp1_on_card_equals_dense(cuda_card, family):
    """Tensor parallelism over a one-rank mp set on the card is the dense
    model bit for bit: ``tensor_parallel`` returns the model as it is, the
    flash forward's logits and ``vocab_parallel_loss`` equal ``loss_fn``'s,
    and ``tp_decode_step`` over the state dict equals ``decode_step`` at
    every position, logits and cache."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import generate as G
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.parallel import mp
    hvd.init()
    try:
        dev = hvd.device()
        g = torch.Generator(device=dev).manual_seed(0)
        tok = torch.randint(1, 256, (4, 24), generator=g, device=dev)
        with torch.device(dev):
            build = {"gpt2": lambda: GPT2(GPT2Config.tiny(
                attention="flash"), g), "llama": lambda: Llama(
                LlamaConfig.tiny(attention="flash"), g)}[family]
            m = build()
        dense = copy.deepcopy(m)
        assert mp.tensor_parallel(m) is m and m.tp is None
        with torch.no_grad():
            lg, want = m(tok), dense(tok)
            assert torch.equal(lg, want)
            assert torch.equal(mp.vocab_parallel_loss(lg, tok),
                               loss_fn(want, tok))
        m = m.to(torch.bfloat16)
        step, tp = G.decode_step(m.cfg), mp.tp_decode_step(m.cfg)
        state = m.state_dict()
        ca = G.init_cache(m.cfg, 4, 24, device=dev)
        cb = G.init_cache(m.cfg, 4, 24, device=dev)
        for t in range(24):
            ca, la = step(m, ca, tok[:, t], t)
            cb, lb = tp(state, cb, tok[:, t], t)
            assert torch.equal(la, lb)
        assert all(torch.equal(ca[i][k], cb[i][k]) for i in ca for k in "kv")
    finally:
        hvd.shutdown()
