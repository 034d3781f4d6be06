#!/usr/bin/env python3
"""Smoke run of horovod_tpu_torch on one NVIDIA GPU (H100): ``python3
chip_smoke.py``.

Phases, in order; any failure exits nonzero and prints no result:

1. the card's name and power limit (nvidia-smi), TF32 off, and the build of
   every CUDA kernel from ``horovod_tpu_torch/ops/csrc`` (nvcc, in
   parallel, with the planted-fault builds of ``_build.PLANTED``), with
   build seconds and ptxas's register/spill report;
2. each kernel against its plain PyTorch version on the card: at GPT-2
   medium's attention shapes (B 8, T 1024, H 16, d 64, bf16, causal) and at
   ragged shapes with key bias, segment ids and ``causal_offset=-1`` and
   cross-attention shapes at d 128, in bf16 (all three kernels on the tensor
   cores: forward, dQ and dK/dV) and in fp32 (the FMA kernels), and at B 8,
   T 1024, H 8, d 128 in bf16, each
   output element by element (tolerances at ``BF16_TOL``/``F32_TOL``; the
   worst share of the bound is printed); at the main shapes the same check
   must also catch four planted faults (a scale off by 1 %, a strict causal
   mask, a dropped last key tile, and kernels built to round P and dS to
   bf16 once, caught on O, dQ, dK and dV); then median times of each
   kernel, one call between two
   events and over 10 back-to-back calls, with its achieved TFLOP/s, its
   plain version, and, as a yardstick only, ``scaled_dot_product_attention``
   forward and backward (the port never calls it), at the main shapes and at
   d 128;
3. the main path: ``hvd.init()`` (one rank, NCCL), GPT-2 medium at full
   width and depth with ``attention="flash"``, ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW)`` for 5 steps on a fixed seeded batch. The
   loss must be finite and falling and every kernel's launch count must grow
   by ``num_layers`` a step. A tiny fp32 GPT-2 checks flash against dense
   attention first.
4. the reference's headline models and the rest of the collective API, on
   a new one-rank NCCL world: a tiny fp32 ResNet on the card against the
   same on the CPU (logits, a gradient), with cross-replica BN, and its
   space-to-depth stem against the conv stem; ResNet-50 at the bench's
   shape (``bench.py:186-235``: B 128, 224x224, bf16, 1000 classes,
   ``channels_last``, local BN) through ``broadcast_parameters`` and
   ``DistributedOptimizer(SGD(0.1, momentum 0.9))`` for 5 steps on a
   seeded fixed batch (loss finite and falling, running statistics finite
   and moved; images/s, the step split, peak memory and the share of the
   tensor-core bound printed); one step with bf16 BN statistics and the
   s2d stem; the MNIST CNN at the bench's shape (B 512, fp32, 5 steps); and
   every new collective once on NCCL with card tensors. This path runs no
   kernel of the port's own (the reference computes it outside Pallas), so
   no kernel may launch in it.
5. the reference's BERT-large, ViT-B/16 and Llama-340M on the flash
   kernels, Adasum and the join mask, on a new one-rank NCCL world: the
   three kernels against their plain versions at each model's attention
   shape (``PATHS``: BERT B 8, T 512, non-causal with a zero key bias, and
   once with the last 64 keys of two rows padded; ViT B 128, T 197,
   non-causal; Llama B 4, T 2048, causal, K and V expanded from 4 heads;
   all bf16, d 64), with their times, bounds, plain times and SDPA with the
   same mask; tiny fp32 BERT, ViT and Llama on the card against the CPU
   (logits, a gradient) and flash against dense; each model trained at
   full width for 5 steps through ``broadcast_parameters`` and
   ``DistributedOptimizer(AdamW(1e-4))`` (BERT with ``op=Adasum``), the
   loss finite and falling and each kernel launched ``num_layers`` times a
   step, with tokens or images per second, the step split, peak memory
   and the share of the tensor-core bound; Adasum on the card (the
   identity on one rank, its arithmetic against float64 on the CPU) and
   the join mask (``alive``).
6. the controller on the card, on a new one-rank NCCL world: phase 3's
   GPT-2 medium run again under ``start_timeline`` (before ``init``),
   ``start_metrics_flusher`` and the stall watchdog ``init`` starts. The
   trace must be valid JSON with init's ``clock_anchor``, every op must
   have one QUEUE and one EXEC event and the op ids must run 1..N; the
   growth of ``collective_calls_total`` (5 allreduces, one broadcast per
   state tensor) and of ``fusion_buckets_total`` (5 times the gradients'
   bucket plan) must be what the steps issued, the metrics file must hold
   the count, each kernel must launch 24 times a step, and the losses must
   equal phase 3's within ``LOSS_TOL``; the median step time is printed
   beside phase 3's. Then a planted stall (a ``collective_begin`` with no
   end under a ``StallWatchdog(timeout_s=0.2)``) must fire exactly one
   report naming the tensor, add one to ``stall_events_total`` and leave
   one ``collective_stall`` marker. With two cards,
   ``tools/torch_controller_bench.py --np 2`` runs the join service, a
   mismatch and the negotiation timing on a two-rank NCCL world; with one
   card a line says it did not run.

Before the last line it prints one JSON object ``{"kernels": [...]}``: each
kernel's numbers at GPT-2's shapes, its launches on each path (GPT-2,
BERT, ViT, Llama, GPT-2 under the controller, each counted from 0 just
before the path and read just after) and their sum, and its numbers at each new path's shape. The last
line is ``{"ok": true, "device": {...}}``. ``--phases 1,2`` stops after
the kernel checks.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
PEAK_HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth

# Tolerances of kernel vs plain, (rtol, atol_rms, rel_rms): every element
# must hold |got - want| <= rtol * |want| + atol_rms * rms(want), and the
# whole tensor rms(got - want) <= rel_rms * rms(want). Both sides do the same
# fp32 math, summed in another order, and round the result once.
BF16_TOL = (2 ** -6, 1e-3, 1e-2)   # two bf16 ulps of each element
F32_TOL = (1e-5, 1e-4, 1e-5)       # fp32 sums taken in another order

KERNEL_INFO = {
    "flash_fwd": ("horovod_tpu_torch/ops/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:110"),
    "flash_bwd_dq": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                     "horovod_tpu/ops/flash_attention.py:256"),
    "flash_bwd_dkv": ("horovod_tpu_torch/ops/csrc/flash_bwd.cu",
                      "horovod_tpu/ops/flash_attention.py:296"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Cycles the card sleeps before a run of back-to-back calls (~2.5 ms): the
# host queues the whole run meanwhile, so its speed never shows in the time.
QUEUE_SLEEP_CYCLES = 5_000_000


def cuda_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Device time of one ``fn()`` in ms: the median over ``reps`` runs of
    ``inner`` back-to-back calls, each run timed with events and divided by
    ``inner``. With ``inner`` > 1 the card first sleeps while the host
    queues the run, so the calls follow each other on the card and the
    host's time per call is not counted even on a slow host."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if inner > 1:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


# ---------------------------------------------------------------- phase 1

def phase_build():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: matmul and cudnn off")
    from horovod_tpu_torch.ops import _build
    t0 = time.perf_counter()
    secs = _build.build(list(_build.SOURCES) + list(_build.PLANTED))
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per library "
        + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for name in _build.SOURCES:
        rep = _build.ptxas_report(name)
        if rep:
            log(f"ptxas {name}:\n{rep}")
        # The tensor-core kernels must keep everything in registers.
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry" in line:
                entry = line
            elif "_wg_kernel" in entry and re.search(
                    r"[1-9]\d* bytes spill (stores|loads)", line):
                fail(f"a wgmma kernel spills: {entry}: {line}")
    # The tensor-core kernels take all their shared memory dynamically, so
    # ptxas's lines above show none for them.
    fwd, bwd = _build.load("flash_fwd"), _build.load("flash_bwd")
    smem = {"forward": fwd.hvd_flash_fwd_smem, "dQ": bwd.hvd_flash_bwd_dq_smem,
            "dK/dV": bwd.hvd_flash_bwd_dkv_smem}
    log("dynamic shared memory per block (bytes) of the bf16 wgmma kernels, "
        "head dim <= 64 / 128: " + ", ".join(
            f"{k} {f(64)} / {f(128)}" for k, f in smem.items()))
    return card


# ---------------------------------------------------------------- phase 2

def _inputs(bh, b, tq, tk, d, dtype, seed, bias=False, seg=False):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d), \
        rnd(bh, tq, d)
    kb = sg = None
    if bias:
        kb = torch.randn(b, tk, generator=g, device="cuda")
        kb[:, -7:] = -1e30                 # padded keys
        kb[b - 1, :] = -1e30               # a batch row with no visible key
    if seg:
        cut = torch.randint(1, tq, (b, 2), generator=g, device="cuda")
        pos = torch.arange(tq, device="cuda")[None]
        sg = ((pos >= cut[:, :1]).int() + (pos >= cut[:, 1:]).int())
        sg = sg.to(torch.int32).contiguous()
    return q, k, v, do, kb, sg


def _visible_pairs(bh, tq, tk, causal, offset, h, bias=None, seg=None):
    """Visible (q, k) pairs of this run's masks, summed over BH."""
    import torch
    qp = torch.arange(tq, device="cuda")[:, None]
    kp = torch.arange(tk, device="cuda")[None, :]
    vis = torch.ones(tq, tk, dtype=torch.bool, device="cuda")
    if causal:
        vis = qp + offset >= kp
    vis = vis[None].expand(bh // h, tq, tk)
    if seg is not None:
        vis = vis & (seg[:, :, None] == seg[:, None, :])
    if bias is not None:
        vis = vis & (bias[:, None, :] > -1e29)
    return int(vis.sum().item()) * h


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _stats(got, want, tol):
    """(max |err|, max of err / per-element bound, rms(err) / rms(want), ok)
    of ``got`` against ``want`` under ``tol`` = (rtol, atol_rms, rel_rms)."""
    rtol, atol_rms, rel_rms = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms_w = w.pow(2).mean().sqrt()
    bound = rtol * w.abs() + atol_rms * rms_w
    worst = (err / bound.clamp_min(1e-30)).max().item()
    rel = (err.pow(2).mean().sqrt() / rms_w.clamp_min(1e-30)).item()
    ok = bool((err <= bound).all().item()) and rel <= rel_rms
    return err.max().item(), worst, rel, ok


# Worst share of the per-element bound seen by _check, per tolerance.
WORST = {BF16_TOL: 0.0, F32_TOL: 0.0}


def _check(name, got, want, tol):
    """Fails unless ``got`` holds ``tol`` against ``want``; returns the max
    abs error."""
    err, worst, rel, ok = _stats(got, want, tol)
    WORST[tol] = max(WORST[tol], worst)
    log(f"  {name}: max_abs_err {err:.3e}, max err/bound {worst:.3f}, "
        f"rms err/rms {rel:.3e} (rtol {tol[0]:.3e}, atol {tol[1]:.0e} rms, "
        f"rel rms <= {tol[2]:.0e})")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_case(label, b, tq, tk, h, d, dtype, causal, offset, bias, seg,
                 tol):
    """Kernel vs plain for the three kernels on one case of ``_inputs``;
    returns errors, the inputs and plain residuals, and the outputs."""
    bh = b * h
    inputs = _inputs(bh, b, tq, tk, d, dtype, seed=tq + d, bias=bias,
                     seg=seg)
    log(f"case {label}: B {b} Tq {tq} Tk {tk} H {h} d {d} {dtype} "
        f"causal {causal} offset {offset} bias {bias} seg {seg}")
    return compare_kernels(inputs, b, h, d, causal, offset, tol,
                           dead_row=bias)


def compare_kernels(inputs, b, h, d, causal, offset, tol, dead_row=False):
    """The three kernels against their plain versions on packed ``inputs``
    (q, k, v, dO, key bias, segment ids); with ``dead_row`` the last batch
    row sees no key and must give O = 0 and lse = -1e30."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, kb, sg = inputs
    scale = d ** -0.5
    o, lse = fa.flash_fwd(q, k, v, kb, sg, h, scale, causal, offset)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kb, sg, h, scale, causal,
                                    offset)
    torch.cuda.synchronize()
    # lse is compared where a row sees any key; rows that see none must
    # hold -1e30 on both sides.
    live = lse_p > -1e29
    if not torch.equal(live, lse > -1e29):
        fail("kernel and plain disagree on which rows see no key")
    # lse is fp32 from the same fp32 scores whatever the input type.
    errs = {"flash_fwd": max(
        _check("O", o, o_p, tol),
        _check("lse", lse[live], lse_p[live], F32_TOL))}
    if dead_row:
        masked = lse_p[(b - 1) * h:].max().item()
        if masked > -1e29 or lse[(b - 1) * h:].max().item() > -1e29:
            fail("fully masked rows must give lse = -1e30")
        if o[(b - 1) * h:].abs().max().item() != 0.0:
            fail("fully masked rows must give O = 0")
    delta = (do.float() * o_p.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, kb, sg, do, lse_p, delta, h, scale,
                         causal, offset)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, sg, do, lse_p, delta, h,
                                 scale, causal, offset)
    dk, dv, db = fa.flash_bwd_dkv(q, k, v, kb, sg, do, lse_p, delta, h,
                                  scale, causal, offset)
    dk_p, dv_p, db_p = fa.flash_bwd_dkv_plain(q, k, v, kb, sg, do, lse_p,
                                              delta, h, scale, causal,
                                              offset)
    torch.cuda.synchronize()
    errs["flash_bwd_dq"] = _check("dQ", dq, dq_p, tol)
    e = [_check("dK", dk, dk_p, tol), _check("dV", dv, dv_p, tol)]
    if kb is not None:
        e.append(_check("dbias", db, db_p, tol))
    errs["flash_bwd_dkv"] = max(e)
    return errs, (q, k, v, do, kb, sg, lse_p, delta, o_p), (o, dq, dk, dv)


def planted_faults(inputs, outs, b, h, d, tol):
    """The check must catch a wrong kernel: the kernels' outputs at the main
    shapes are held against plain runs with a fault planted, and each fault
    must fail the check of every kernel. Also prints what a bound of
    1.6e-2 * max(1, max |want|) would have said."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do = inputs[:4]
    tk = k.shape[1]
    scale = d ** -0.5
    drop = torch.zeros(b, tk, device="cuda")
    drop[:, tk - 64:] = -1e30
    faults = {
        "scale x 1.01": (scale * 1.01, 0, None),
        "strict causal (offset -1)": (scale, -1, None),
        "last 64-key tile dropped": (scale, 0, drop),
    }
    for label, (sc, off, kb) in faults.items():
        o_f, lse_f = fa.flash_fwd_plain(q, k, v, kb, None, h, sc, True, off)
        delta_f = (do.float() * o_f.float()).sum(-1)
        dq_f = fa.flash_bwd_dq_plain(q, k, v, kb, None, do, lse_f, delta_f,
                                     h, sc, True, off)
        dk_f, dv_f, _ = fa.flash_bwd_dkv_plain(q, k, v, kb, None, do, lse_f,
                                               delta_f, h, sc, True, off,
                                               want_db=False)
        caught, loose = {}, []
        for name, got, want in zip(("O", "dQ", "dK", "dV"), outs,
                                   (o_f, dq_f, dk_f, dv_f)):
            err, worst, rel, ok = _stats(got, want, tol)
            caught[name] = not ok
            if err <= 1.6e-2 * max(1.0, want.float().abs().max().item()):
                loose.append(name)
            log(f"  fault {label}: {name} max_abs_err {err:.3e}, max "
                f"err/bound {worst:.3f}, rms err/rms {rel:.3e} -> "
                f"{'caught' if not ok else 'MISSED'}")
        log(f"  fault {label}: a max-relative bound would pass "
            f"{loose or 'nothing'}")
        if not (caught["O"] and caught["dQ"]
                and (caught["dK"] or caught["dV"])):
            fail(f"the kernel check misses the planted fault {label}")


def planted_rounding(inputs, h, d, tol):
    """The check must catch kernels that round P and dS to bf16 once instead
    of splitting them into hi + lo (``_build.PLANTED``): their O, dQ, dK and
    dV at the main shapes are held against the plain versions, and each must
    fail. These launches go through the libraries directly and count
    nowhere."""
    import torch
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, _, _, lse_p, delta, o_p = inputs
    scale = d ** -0.5
    dq_p = fa.flash_bwd_dq_plain(q, k, v, None, None, do, lse_p, delta, h,
                                 scale, True)
    dk_p, dv_p, _ = fa.flash_bwd_dkv_plain(q, k, v, None, None, do, lse_p,
                                           delta, h, scale, True,
                                           want_db=False)
    st = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty(q.shape[:2], device="cuda")
    fa.launch_fwd(_build.load("flash_fwd_one_rounding"), q, k, v, None, None,
                  o, lse, h, scale, True, 0, st)
    bwd = _build.load("flash_bwd_one_rounding")
    dq = torch.empty_like(q)
    fa.launch_bwd_dq(bwd, q, k, v, None, None, do, lse_p, delta, dq, h, scale,
                     True, 0, st)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa.launch_bwd_dkv(bwd, q, k, v, None, None, do, lse_p, delta, dk, dv,
                      None, h, scale, True, 0, st)
    torch.cuda.synchronize()
    for name, got, want in (("O", o, o_p), ("dQ", dq, dq_p), ("dK", dk, dk_p),
                            ("dV", dv, dv_p)):
        err, worst, rel, ok = _stats(got, want, tol)
        log(f"  fault P and dS rounded to bf16 once: {name} max_abs_err "
            f"{err:.3e}, max err/bound {worst:.3f}, rms err/rms {rel:.3e} -> "
            f"{'MISSED' if ok else 'caught'}")
        if ok:
            fail(f"the kernel check misses one bf16 rounding of P/dS on "
                 f"{name}")


def kernel_times(case, b, h, d, causal=True):
    """Median ms of each kernel and of SDPA forward and backward (the
    yardstick, with the same mask: the case's key bias as a boolean key
    mask, or the causal diagonal) on one case's inputs: ({kernel: one
    call}, {kernel: per call of 10 back-to-back}, (sdpa one call, sdpa
    10))."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, kb, _, lse, delta, _ = case
    t_ = q.shape[1]
    scale = d ** -0.5
    runs = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, kb, None, h, scale,
                                          causal),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, kb, None, do, lse,
                                                delta, h, scale, causal),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, kb, None, do,
                                                  lse, delta, h, scale,
                                                  causal),
    }

    # SDPA on the same inputs in its (B, H, T, D) layout; its backward alone
    # computes dQ, dK and dV in one call, the work of both backward kernels.
    def bhtd(x):
        return x.view(b, h, t_, d).detach().clone().requires_grad_(True)
    sq, sk, sv = bhtd(q), bhtd(k), bhtd(v)
    sdo = do.view(b, h, t_, d)
    mask = None if kb is None else (kb > -1e29)[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=mask,
                                              is_causal=causal)
    sout = sdpa()
    runs["fwd"] = sdpa
    runs["bwd"] = lambda: torch.autograd.grad(sout, (sq, sk, sv), sdo,
                                              retain_graph=True)
    one = {n: cuda_ms(f, 20) for n, f in runs.items()}
    ten = {n: cuda_ms(f, 20, inner=10) for n, f in runs.items()}
    pick = lambda x: ({n: x[n] for n in fa.KERNELS},
                      {n: x[n] for n in ("fwd", "bwd")})
    (k1, s1), (k10, s10) = pick(one), pick(ten)
    return k1, k10, (s1, s10)


def plain_times(case, h, d, causal=True, reps=5):
    """Median ms of each kernel's plain version on one case's inputs."""
    from horovod_tpu_torch.ops import flash_attention as fa
    q, k, v, do, kb, _, lse, delta, _ = case
    scale = d ** -0.5
    return {
        "flash_fwd": cuda_ms(lambda: fa.flash_fwd_plain(
            q, k, v, kb, None, h, scale, causal), reps),
        "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq_plain(
            q, k, v, kb, None, do, lse, delta, h, scale, causal), reps),
        "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv_plain(
            q, k, v, kb, None, do, lse, delta, h, scale, causal), reps),
    }


def kernel_work(bh, tq, tk, d, pairs, bias_rows=0):
    """{kernel: (FLOPs, bytes)} of the function each kernel computes:
    4·d, 6·d and 8·d FLOPs per visible (q, k) pair; each input read once
    and each output written once: bf16 (BH, T, d) tensors, fp32 (BH, T)
    rows (lse, delta; the bias gradient), and a (B, Tk) fp32 key bias of
    ``bias_rows`` rows."""
    el_q, el_k = bh * tq * d * 2, bh * tk * d * 2
    row = bh * tq * 4
    kb = bias_rows * tk * 4
    return {
        "flash_fwd": (4 * d * pairs, 2 * el_q + 2 * el_k + row + kb),
        "flash_bwd_dq": (6 * d * pairs, 3 * el_q + 2 * el_k + 2 * row + kb),
        "flash_bwd_dkv": (8 * d * pairs, 2 * el_q + 4 * el_k + 2 * row + kb
                          + (bh * tk * 4 if bias_rows else 0)),
    }


def bound(flops, nbytes):
    """(ms, "operations" or "bytes"): the larger of FLOPs over the bf16
    tensor-core peak and bytes over the HBM rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one ``fn()`` in us: the wrapper's Python and the
    launch, not the kernel (the card runs it behind the host's back)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_kernels():
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa

    B, T, H, D = 8, 1024, 16, 64
    errs, main, main_outs = compare_case("main", B, T, T, H, D,
                                         torch.bfloat16, True, 0, False,
                                         False, BF16_TOL)
    planted_faults(main, main_outs, B, H, D, BF16_TOL)
    planted_rounding(main, H, D, BF16_TOL)
    del main_outs
    for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, "bf16"),
                            (torch.float32, F32_TOL, "fp32")):
        compare_case(f"ragged-{tag}", 2, 200, 200, 4, 64, dtype, True, -1,
                     True, True, tol)
        compare_case(f"cross-{tag}", 2, 77, 130, 2, 128, dtype, False, 0,
                     True, False, tol)
    compare_case("small-head", 2, 50, 50, 3, 24, torch.bfloat16, True, 0,
                 False, True, BF16_TOL)
    _, wide, _ = compare_case("d128", 8, 1024, 1024, 8, 128, torch.bfloat16,
                              True, 0, False, False, BF16_TOL)
    log(f"worst max err/bound: bf16 outputs {WORST[BF16_TOL]:.3f}, fp32 "
        f"outputs and lse {WORST[F32_TOL]:.3f} (fails above 1)")

    # Times at the main-path shapes: one call between two events (the
    # kernels line's ms), and per call over 10 back-to-back calls, which
    # leaves the wrapper's host time out.
    q, k, v, do, _, _, lse, delta, o = main
    bh, scale = B * H, D ** -0.5
    t, t10, (sdpa, sdpa10) = kernel_times(main, B, H, D)
    p = plain_times(main, H, D)
    log(f"times (ms; median of 20 single calls / of 20 runs of 10 "
        f"back-to-back calls; 5 single calls for the plain versions) at B {B} "
        f"T {T} H {H} d {D} bf16 causal:")
    for name in fa.KERNELS:
        log(f"  {name}: kernel {t[name]:.4f} / {t10[name]:.4f}  plain "
            f"{p[name]:.4f}")
    log(f"  sdpa fwd {sdpa['fwd']:.4f} / {sdpa10['fwd']:.4f}  sdpa bwd "
        f"{sdpa['bwd']:.4f} / {sdpa10['bwd']:.4f} (yardstick; the port never "
        f"calls it); flash_bwd_dq + flash_bwd_dkv "
        f"{t['flash_bwd_dq'] + t['flash_bwd_dkv']:.4f} / "
        f"{t10['flash_bwd_dq'] + t10['flash_bwd_dkv']:.4f}")
    host = {
        "flash_fwd": host_us(lambda: fa.flash_fwd(q, k, v, None, None, H,
                                                  scale, True)),
        "flash_bwd_dq": host_us(lambda: fa.flash_bwd_dq(
            q, k, v, None, None, do, lse, delta, H, scale, True)),
    }
    log("wrapper host time per call (us, median of 200; the kernel runs "
        "behind it): " + ", ".join(f"{n} {us:.1f}" for n, us in host.items()))
    wt, wt10, (wsdpa, wsdpa10) = kernel_times(wide, 8, 8, 128)
    log(f"times (ms, the same two ways) at B 8 T 1024 H 8 d 128 bf16 causal: "
        f"flash_fwd {wt['flash_fwd']:.4f} / {wt10['flash_fwd']:.4f}, "
        f"flash_bwd_dkv {wt['flash_bwd_dkv']:.4f} / "
        f"{wt10['flash_bwd_dkv']:.4f}, flash_bwd_dq {wt['flash_bwd_dq']:.4f} "
        f"/ {wt10['flash_bwd_dq']:.4f}; sdpa fwd {wsdpa['fwd']:.4f} / "
        f"{wsdpa10['fwd']:.4f}, bwd {wsdpa['bwd']:.4f} / "
        f"{wsdpa10['bwd']:.4f}")
    del wide

    pairs = _visible_pairs(bh, T, T, True, 0, H)
    work = kernel_work(bh, T, T, D, pairs)
    library = {"flash_fwd": (sdpa["fwd"], "scaled_dot_product_attention "
                             "forward"),
               "flash_bwd_dq": (None, "no library call computes dQ alone"),
               "flash_bwd_dkv": (sdpa["bwd"], "scaled_dot_product_attention "
                                 "backward: dQ, dK and dV in one call, the "
                                 "work of flash_bwd_dq and flash_bwd_dkv "
                                 "together")}
    report = {}
    for name in fa.KERNELS:
        flops, nbytes = work[name]
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"  {name}: {flops / t[name] / 1e9:.1f} TFLOP/s one call at a "
            f"time, {flops / t10[name] / 1e9:.1f} back to back, on the "
            f"function's {flops / 1e9:.2f} GFLOP ({flops // (D * pairs)}·d "
            f"per visible pair)")
        src, replaces = KERNEL_INFO[name]
        report[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": 0,
            "max_abs_err": errs[name], "ms": t[name],
            "ms_back_to_back": t10[name], "plain_ms": p[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library[name][0],
            "library_ms_back_to_back": {"flash_fwd": sdpa10["fwd"],
                                        "flash_bwd_dkv": sdpa10["bwd"]}.get(
                                            name),
            "library_note": library[name][1],
            "flops": flops, "bytes": nbytes,
            "tflops": flops / t[name] / 1e9,
            "tflops_back_to_back": flops / t10[name] / 1e9,
        }
    log(json.dumps({"kernel_checks": list(fa.KERNELS),
                    "launches_in_checks": dict(fa.launches)}))
    return report


# ---------------------------------------------------------------- phase 3

def phase_reference_check():
    """Tiny fp32 GPT-2 on the card: flash logits == dense logits."""
    import torch
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    tokens = torch.randint(0, 256, (2, 100),
                           generator=torch.Generator().manual_seed(3))
    tokens = tokens.cuda()
    out = {}
    for impl in ("dense", "flash"):
        m = GPT2(GPT2Config.tiny(dtype=torch.float32, attention=impl),
                 torch.Generator().manual_seed(0)).cuda()
        logits = m(tokens)
        loss = loss_fn(logits, tokens)
        loss.backward()
        out[impl] = (logits.detach(), loss.item(),
                     m.h[0].attn.qkv.weight.grad.clone())
    err = _err(out["flash"][0], out["dense"][0])
    gerr = _err(out["flash"][2], out["dense"][2])
    log(f"reference check (tiny fp32 GPT-2, flash vs dense): logits "
        f"max_abs_err {err:.3e}, qkv grad max_abs_err {gerr:.3e}, loss "
        f"{out['flash'][1]:.6f} vs {out['dense'][1]:.6f}")
    if out["flash"][0].shape != (2, 100, 256) or \
            not torch.isfinite(out["flash"][0]).all():
        fail("tiny GPT-2 logits are not finite or have the wrong shape")
    if err > 1e-4 or gerr > 1e-4:
        fail("flash GPT-2 disagrees with dense GPT-2 (tol 1e-4)")


def phase_main_path(card):
    """GPT-2 medium through the port's training path (``build_path``,
    ``phase_train_path``) on a one-rank NCCL world."""
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    run = phase_train_path("gpt2_medium", card, hvd.device())
    hvd.shutdown()
    return run


# ---------------------------------------------------------------- phase 4

# The CPU tests' tolerances (tests/test_torch_port_resnet.py): fp32 logits
# and gradients, plus BN_SCALE of the tensor's largest element for what
# passes through a stack of BNs.
LOGIT_TOL = (1e-4, 1e-5)
GRAD_TOL = (1e-3, 1e-6)
BN_SCALE = 1e-4


def _close(name, got, want, tol, floor=BN_SCALE):
    """Fails unless every element of ``got`` is within rtol·|want| + atol
    (atol at least ``floor`` of max |want|) of ``want``."""
    import torch
    rtol, atol = tol
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    atol = max(atol, floor * w.abs().max().item())
    err = (g - w).abs()
    worst = (err / (rtol * w.abs() + atol)).max().item()
    log(f"  {name}: max_abs_err {err.max().item():.3e}, max err/bound "
        f"{worst:.3f}")
    if not torch.isfinite(g).all() or worst > 1.0:
        fail(f"{name} disagrees (tol rtol {rtol}, atol {atol:.2e})")


def _tiny_resnet(block, stem, **kw):
    import torch
    from horovod_tpu_torch.models import resnet
    return resnet.ResNet(stage_sizes=[1, 1, 1, 1],
                         block_cls=getattr(resnet, block), num_classes=10,
                         num_filters=8, dtype=torch.float32, stem=stem,
                         generator=torch.Generator().manual_seed(0), **kw)


def _train_pass(model, x, y):
    import torch.nn.functional as F
    logits = model(x)
    F.cross_entropy(logits, y).backward()
    return logits, model.conv_init.weight.grad


def phase_resnet_reference(dev):
    """Tiny fp32 ResNets: the card against the CPU (train mode: logits,
    the stem's gradient, the running statistics), cross-replica BN over the
    one-rank NCCL set against local BN, and the s2d stem with converted
    weights against the conv stem."""
    import copy
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 3, 32, 32, generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    xd, yd = x.to(dev), y.to(dev)
    for block in ("BasicBlock", "BottleneckBlock"):
        cpu = _tiny_resnet(block, "conv")
        card = copy.deepcopy(cpu).to(dev)
        cross = _tiny_resnet(block, "conv",
                             bn_cross_replica=hvd.global_process_set())
        cross.load_state_dict(cpu.state_dict())
        cross = cross.to(dev)
        want = _train_pass(cpu, x, y)
        log(f"tiny fp32 ResNet ({block}), card against CPU:")
        for tag, m in (("local BN", card), ("cross-replica BN", cross)):
            got = _train_pass(m, xd, yd)
            _close(f"{tag} logits", got[0], want[0], LOGIT_TOL)
            _close(f"{tag} conv_init grad", got[1], want[1], GRAD_TOL)
            _close(f"{tag} running_var", m.blocks[0].bn0.running_var,
                   cpu.blocks[0].bn0.running_var, LOGIT_TOL)
    conv = _tiny_resnet("BottleneckBlock", "conv").to(dev)
    s2d = _tiny_resnet("BottleneckBlock", "s2d")
    sd = {k: v.cpu() for k, v in conv.state_dict().items()}
    w = sd["conv_init.weight"].permute(2, 3, 1, 0).numpy()
    sd["conv_init.weight"] = torch.tensor(
        resnet.convert_stem_weights(w).transpose(3, 2, 0, 1).copy())
    s2d.load_state_dict(sd)
    s2d = s2d.to(dev)
    log("tiny fp32 ResNet, s2d stem with convert_stem_weights against the "
        "conv stem, on the card:")
    with torch.no_grad():
        _close("s2d logits", s2d(xd), conv(xd), LOGIT_TOL)


def _conv_macs(model, x):
    """Multiply-adds of one forward of ``model`` on ``x``: every conv and
    dense layer, counted from the shapes this run gives them."""
    import torch
    from horovod_tpu_torch.models.gpt2 import Dense
    from horovod_tpu_torch.models.resnet import Conv
    macs = [0]

    def hook(mod, inp, out):
        if isinstance(mod, Conv):
            macs[0] += out.numel() * mod.weight[0].numel()
        else:
            macs[0] += out.numel() * mod.weight.shape[1]
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, (Conv, Dense))]
    with torch.no_grad():
        model(x)
    for h in hs:
        h.remove()
    return macs[0]


def _train_steps(model, opt, x, y, steps, tag, generator=None):
    """``steps`` SGD steps on one fixed batch: per step the loss, the wall
    seconds and the device ms of forward + loss, backward and the
    optimizer (fused allreduce + SGD), from CUDA events. These paths have
    no kernel of the port's: the launch counts, zeroed just before, must
    still be 0 just after."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.ops import flash_attention as fa
    fa.reset_launches()
    losses, wall, parts = [], [], []
    for step in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad()
        logits = (model(x) if generator is None else model(x, generator))
        loss = F.cross_entropy(logits, y)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.item())
        log(f"{tag} step {step}: loss {losses[-1]:.6f}  {wall[-1]:.3f} s  "
            f"forward {parts[-1][0]:.1f} ms  backward {parts[-1][1]:.1f} ms"
            f"  allreduce+sgd {parts[-1][2]:.1f} ms")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: non-finite loss: {losses}")
    if any(fa.launches.values()):
        fail(f"{tag}: a flash kernel launched: {fa.launches}")
    return losses, wall, parts


def phase_resnet50(card, dev):
    """ResNet-50 at the bench's shape through the port's training path."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    B, S, steps = 128, 224, 5
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with torch.device(dev):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         generator=g)
    model = model.to(memory_format=torch.channels_last)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"ResNet-50: 16 bottleneck blocks, {n_params} params, B {B} {S}x{S} "
        f"bf16 channels_last, local BN, built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(B, 3, S, S, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (B,), generator=g, device=dev)
    macs = _conv_macs(model, x)
    flops = 3 * 2 * macs            # forward, and twice it backward
    bn = [m for m in model.modules() if hasattr(m, "running_var")]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bn]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, parts = _train_steps(model, opt, x, y, steps, "resnet50")
    peak = torch.cuda.max_memory_allocated()
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 loss is not falling: {losses}")
    stats = [(m.running_mean, m.running_var) for m in bn]
    if not all(torch.isfinite(t).all() for pair in stats for t in pair):
        fail("ResNet-50 running statistics are not finite")
    moved = sum(not torch.equal(a, c) or not torch.equal(b, d)
                for (a, b), (c, d) in zip(stats, before))
    if moved != len(bn):
        fail(f"only {moved} of {len(bn)} BNs moved their running stats")
    steady = wall[1:]
    med = [statistics.median(p[i] for p in parts[1:]) for i in range(3)]
    step_ms = statistics.median(steady) * 1e3
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    out = {"images_per_s": B * len(steady) / sum(steady),
           "step_ms_median": step_ms, "forward_ms": med[0],
           "backward_ms": med[1], "allreduce_sgd_ms": med[2],
           "peak_gib": peak / 2 ** 30, "gmac_per_image": macs / B / 1e9,
           "step_tflop": flops / 1e12, "bound_ms": bound_ms,
           "share_of_bound": bound_ms / step_ms, "losses": losses,
           "bns_moved": moved}
    log(f"ResNet-50 on {card}: {out['images_per_s']:.1f} images/s (steps "
        f"1-{steps - 1}, wall), step {step_ms:.1f} ms median (forward "
        f"{med[0]:.1f}, backward {med[1]:.1f}, allreduce+sgd {med[2]:.1f} "
        f"ms, device time between events), peak memory "
        f"{out['peak_gib']:.2f} GiB; {macs / B / 1e9:.3f} GMAC an image, "
        f"{flops / 1e12:.3f} TFLOP a step, tensor-core bound {bound_ms:.3f}"
        f" ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{out['share_of_bound']:.4f} of the step; running stats moved in "
        f"{moved} of {len(bn)} BNs; losses {losses}")
    del model, opt, x, y
    torch.cuda.empty_cache()
    return out


def phase_resnet50_s2d_bf16_stats(dev):
    """One step of ResNet-50 with bf16 BN statistics and the s2d stem."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.resnet import ResNet50
    g = torch.Generator(device=dev).manual_seed(2)
    with torch.device(dev):
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         bn_stats_dtype=torch.bfloat16, stem="s2d",
                         generator=g)
    model = model.to(memory_format=torch.channels_last)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(128, 3, 224, 224, generator=g, device=dev).to(
        memory_format=torch.channels_last)
    y = torch.randint(0, 1000, (128,), generator=g, device=dev)
    _train_steps(model, opt, x, y, 1, "resnet50 s2d + bf16 BN stats")
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        fail("ResNet-50 (s2d, bf16 BN statistics): non-finite parameters")
    del model, opt, x, y
    torch.cuda.empty_cache()


def phase_mnist(card, dev):
    """The MNIST CNN at the bench's shape (``bench.py:356-385``)."""
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.mnist import MnistCNN
    B, steps = 512, 5
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        model = MnistCNN(generator=g)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1, momentum=0.9))
    x = torch.randn(B, 1, 28, 28, generator=g, device=dev)
    y = torch.randint(0, 10, (B,), generator=g, device=dev)

    def eval_loss():
        model.eval()
        with torch.no_grad():
            v = F.cross_entropy(model(x), y).item()
        model.train()
        return v
    first = eval_loss()
    losses, wall, parts = _train_steps(model, opt, x, y, steps, "mnist",
                                       generator=g)
    last = eval_loss()
    if not last < first:
        fail(f"MNIST loss (eval mode, the same batch) is not falling: "
             f"{first} -> {last}")
    steady = wall[1:]
    out = {"images_per_s": B * len(steady) / sum(steady),
           "step_ms_median": statistics.median(steady) * 1e3,
           "losses": losses, "eval_loss": [first, last]}
    log(f"MNIST on {card}: {out['images_per_s']:.1f} images/s (steps "
        f"1-{steps - 1}, wall), step {out['step_ms_median']:.2f} ms median;"
        f" train losses {losses}; eval loss {first:.6f} -> {last:.6f}")
    return out


def phase_collectives(dev):
    """Every collective of the port once on NCCL (one rank), card tensors:
    each result against what a one-rank world must give."""
    import torch
    import horovod_tpu_torch as hvd
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, 3, generator=g, device=dev)
    xb = x.to(torch.bfloat16)
    xi = torch.randint(-9, 9, (4, 2), generator=g, device=dev,
                       dtype=torch.int32)
    checks = {}

    def same(name, got, want):
        ok = (got.device == want.device and got.dtype == want.dtype
              and torch.equal(got, want))
        checks[name] = ok
        if not ok:
            fail(f"collective {name} on NCCL: got {got} want {want}")

    y = x.clone()
    same("allreduce_", hvd.allreduce_(y, op=hvd.Sum), x)
    same("allreduce bf16", hvd.allreduce(xb), xb)
    same("allreduce int32 average", hvd.allreduce(xi), xi)
    handles = {
        "allreduce_async": (hvd.allreduce_async(x), x),
        "allreduce_async_": (hvd.allreduce_async_(x.clone()), x),
        "broadcast_async": (hvd.broadcast_async(x, 0), x),
        "broadcast_async_": (hvd.broadcast_async_(x.clone(), 0), x),
        "allgather_async": (hvd.allgather_async(xb), xb),
        "alltoall_async": (hvd.alltoall_async(x), x),
        "reducescatter_async": (hvd.reducescatter_async(x, op=hvd.Sum), x),
    }
    grouped = {
        "grouped_allreduce_async": (hvd.grouped_allreduce_async([x, xb]),
                                    [x, xb]),
        "grouped_allgather_async": (hvd.grouped_allgather_async([x, xi]),
                                    [x, xi]),
        "grouped_reducescatter_async": (hvd.grouped_reducescatter_async(
            [x, xb], op=hvd.Average), [x, xb]),
    }
    # Synchronized in the reverse of their issue order.
    for name in reversed(list(grouped)):
        h, wants = grouped[name]
        for i, (got, want) in enumerate(zip(hvd.synchronize(h), wants)):
            same(f"{name}[{i}]", got, want)
    for name in reversed(list(handles)):
        h, want = handles[name]
        same(name, hvd.synchronize(h), want)
        checks[name + " poll"] = hvd.poll(h)
    same("grouped_allgather", hvd.grouped_allgather([x])[0], x)
    same("grouped_reducescatter",
         hvd.grouped_reducescatter([x], op=hvd.Sum)[0], x)
    same("reducescatter", hvd.reducescatter(x), x)
    same("alltoall", hvd.alltoall(x), x)
    recv, rsplits = hvd.alltoall(x[:3], splits=[3])
    same("alltoall splits", recv, x[:3])
    checks["alltoall received splits"] = rsplits.tolist() == [3]
    same("ragged_allgather", hvd.ragged_allgather(x[:3]), x[:3])
    checks["allgather_object"] = hvd.allgather_object({"r": 0}) == [{"r": 0}]
    ps = hvd.add_process_set([0])
    same("allreduce on an added set", hvd.allreduce(x, process_set=ps), x)
    checks["process sets"] = (hvd.get_process_set_ids_and_ranks()
                              == {0: None, 1: [0]}
                              and hvd.remove_process_set(ps))
    sbn = hvd.SyncBatchNorm(3).to(dev)
    t = torch.randn(8, 3, 5, 5, generator=g, device=dev, requires_grad=True)
    w = torch.randn(8, 3, 5, 5, generator=g, device=dev)
    ref = torch.nn.BatchNorm2d(3).to(dev)
    tr = t.detach().clone().requires_grad_(True)
    (sbn(t) * w).sum().backward()
    (ref(tr) * w).sum().backward()
    log("hvd.SyncBatchNorm on NCCL against torch's BatchNorm2d:")
    _close("SyncBatchNorm input grad", t.grad, tr.grad, GRAD_TOL)
    hvd.barrier()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"collectives on NCCL failed: {bad}")
    log(f"collectives on NCCL (one rank, card tensors): {len(checks)} "
        f"checks passed: {', '.join(checks)}")
    return len(checks)


def phase_models(card):
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    phase_resnet_reference(dev)
    resnet50 = phase_resnet50(card, dev)
    phase_resnet50_s2d_bf16_stats(dev)
    mnist = phase_mnist(card, dev)
    n_checks = phase_collectives(dev)
    hvd.shutdown()
    torch.cuda.synchronize()
    return {"resnet50": resnet50, "mnist": mnist,
            "collective_checks": n_checks}


# ---------------------------------------------------------------- phase 5

# The attention shapes of the three new paths, one launch of each kernel a
# layer (bf16, d 64): batch, query heads, T, causal, the KV heads that GQA
# expands to the query heads before the kernels, and whether the model
# passes a key bias (BERT always does: its mask of all ones is a zero
# bias).
PATHS = {
    "bert_large": dict(b=8, h=16, t=512, causal=False, hkv=16, bias=True),
    "vit_b16": dict(b=128, h=12, t=197, causal=False, hkv=12, bias=False),
    "llama_340m": dict(b=4, h=16, t=2048, causal=True, hkv=4, bias=False),
}


def _path_inputs(b, h, t, causal, hkv, bias, seed, pad_rows=0):
    """Packed (B·H, T, 64) bf16 q, k, v, dO at a model's attention shape: K
    and V drawn for ``hkv`` heads, each repeated for its query heads as GQA
    expands them; a zero key bias (a mask of all ones) whose last 64 keys
    are padded (-1e30) in the first ``pad_rows`` rows."""
    import torch
    d = 64
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(heads):
        x = torch.randn(b, t, heads, d, generator=g, device="cuda")
        x = x.repeat_interleave(h // heads, dim=2).to(torch.bfloat16)
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    q, k, v, do = rnd(h), rnd(hkv), rnd(hkv), rnd(h)
    kb = None
    if bias:
        kb = torch.zeros(b, t, device="cuda")
        kb[:pad_rows, t - 64:] = -1e30
    return q, k, v, do, kb, None


def phase_path_kernels():
    """The three kernels against their plain versions at each new path's
    shape (and at BERT's with two rows padded), then their times, bounds,
    plain times and SDPA with the same mask: {path: {kernel: numbers}}."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    out = {}
    for path, c in PATHS.items():
        b, h, t, causal = c["b"], c["h"], c["t"], c["causal"]
        log(f"path {path}: B {b} H {h} T {t} d 64 bf16 causal {causal} "
            f"KV heads {c['hkv']} key bias {c['bias']}")
        errs, case, outs = compare_kernels(
            _path_inputs(seed=t, **c), b, h, 64, causal, 0, BF16_TOL)
        del outs
        if c["bias"]:
            log(f"path {path}, the last 64 keys of two rows padded:")
            padded = compare_kernels(_path_inputs(seed=t + 1, pad_rows=2,
                                                  **c),
                                     b, h, 64, causal, 0, BF16_TOL)[0]
            errs = {k: max(v, padded[k]) for k, v in errs.items()}
        one, ten, (sdpa, sdpa10) = kernel_times(case, b, h, 64, causal)
        plain = plain_times(case, h, 64, causal)
        pairs = _visible_pairs(b * h, t, t, causal, 0, h, bias=case[4])
        work = kernel_work(b * h, t, t, 64, pairs,
                           bias_rows=b if c["bias"] else 0)
        library = {"flash_fwd": (sdpa["fwd"], sdpa10["fwd"]),
                   "flash_bwd_dq": (None, None),
                   "flash_bwd_dkv": (sdpa["bwd"], sdpa10["bwd"])}
        out[path] = {}
        for name in fa.KERNELS:
            flops, nbytes = work[name]
            bound_ms, bound_by = bound(flops, nbytes)
            out[path][name] = {
                "max_abs_err": errs[name], "ms": one[name],
                "ms_back_to_back": ten[name], "plain_ms": plain[name],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library[name][0],
                "library_ms_back_to_back": library[name][1],
                "flops": flops, "bytes": nbytes}
            log(f"  {name}: {one[name]:.4f} / {ten[name]:.4f} ms (one call /"
                f" back to back), plain {plain[name]:.4f}, bound "
                f"{bound_ms:.4f} ms ({bound_by}), "
                f"{flops / ten[name] / 1e9:.1f} TFLOP/s back to back")
        log(f"  sdpa with the same mask: fwd {sdpa['fwd']:.4f} / "
            f"{sdpa10['fwd']:.4f}, bwd {sdpa['bwd']:.4f} / "
            f"{sdpa10['bwd']:.4f} ms (yardstick; the port never calls it)")
        del case
        torch.cuda.empty_cache()
    return out


# The tiny fp32 models of the CPU tests, on the card against the CPU: their
# tolerances (tests/test_torch_port_{bert,vit,llama}.py).
def _tiny_transformers():
    """{name: (build(attention), inputs, loss(model, inputs) -> (output,
    loss), the parameter whose gradient is compared)}."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.bert import Bert, BertConfig, mlm_loss
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig, loss_fn
    from horovod_tpu_torch.models.vit import ViT, ViTConfig
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, 256, (2, 40), generator=g)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, -9:] = False
    mpos = (torch.rand(2, 40, generator=g) < 0.15).float()
    images = torch.randn(4, 3, 32, 32, generator=g)
    labels = torch.randint(0, 10, (4,), generator=g)
    f32 = torch.float32

    def bert_loss(m, x):
        mlm, nsp = m(x[0], attention_mask=x[1])
        return mlm, mlm_loss(mlm, x[0], x[2]) + 0.1 * (nsp ** 2).mean()

    def vit_loss(m, x):
        logits = m(x[0])
        return logits, F.cross_entropy(logits, x[1])

    def llama_loss(m, x):
        logits = m(x[0])
        return logits, loss_fn(logits, x[0])

    return {
        "bert": (lambda a: Bert(BertConfig.tiny(dtype=f32, attention=a)),
                 (tokens, mask, mpos), bert_loss, "layer.0.qkv.weight"),
        "vit": (lambda a: ViT(ViTConfig.tiny(dtype=f32, attention=a)),
                (images, labels), vit_loss, "block.0.qkv.weight"),
        "llama": (lambda a: Llama(LlamaConfig.tiny(dtype=f32, attention=a)),
                  (tokens,), llama_loss, "h.0.attn.wk.weight"),
    }


def phase_tiny_transformers(dev):
    """Tiny fp32 BERT (key mask with padding), ViT (T 17) and Llama (GQA, 4
    heads over 2): flash on the card against flash on the CPU (logits and
    one gradient), and flash against dense on the card."""
    import copy
    for name, (build, inputs, loss_of, pname) in \
            _tiny_transformers().items():
        runs = {}
        cpu = build("flash")
        for tag, model, x in (
                ("cpu", cpu, inputs),
                ("card", copy.deepcopy(cpu).to(dev),
                 [t.to(dev) for t in inputs])):
            out, loss = loss_of(model, x)
            loss.backward()
            runs[tag] = (out, dict(model.named_parameters())[pname].grad)
        dense = build("dense").to(dev)
        dense.load_state_dict(cpu.state_dict())
        log(f"tiny fp32 {name}, flash on the card against flash on the CPU "
            f"and against dense on the card:")
        _close(f"{name} logits", runs["card"][0], runs["cpu"][0], LOGIT_TOL,
               floor=0.0)
        _close(f"{name} {pname} grad", runs["card"][1], runs["cpu"][1],
               GRAD_TOL, floor=0.0)
        _close(f"{name} flash vs dense logits", runs["card"][0],
               loss_of(dense, [t.to(dev) for t in inputs])[0], LOGIT_TOL,
               floor=0.0)


def build_path(name, dev):
    """One training path at full width, on ``dev``, from seed 0: (model,
    optimizer, loss closure, info: the items a step and their unit, the
    model's input, the LM head's multiply-adds a step outside ``Dense``,
    the attention's (B, heads, T, causal), the optimizer's name). GPT-2
    medium as ``bench.py:258-286``, BERT-large and Llama-340M as
    ``:289-319`` and ``:552-586``, all without the bench's remat (not
    ported); ViT-B/16 as ``:322-353`` with ``attention="flash"``."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import get_model
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    opt_kw = {}
    if name == "gpt2_medium":
        from horovod_tpu_torch.models.gpt2 import loss_fn
        # Built on the CPU, as in every earlier run, so its losses compare.
        cpu = torch.Generator().manual_seed(0)
        model = get_model("gpt2_medium", attention="flash",
                          generator=cpu).to(dev)
        b, t = 8, 1024
        tokens = torch.randint(0, model.cfg.vocab_size, (b, t),
                               generator=torch.Generator().manual_seed(0))
        inputs = tokens.to(dev)

        def loss():
            return loss_fn(model(inputs), inputs)
    elif name == "bert_large":
        from horovod_tpu_torch.models.bert import mlm_loss
        with torch.device(dev):
            model = get_model("bert_large", attention="flash", generator=g)
        b, t = 8, 512
        inputs = torch.tensor(rng.integers(0, model.cfg.vocab_size, (b, t)),
                              device=dev)
        mpos = torch.tensor(rng.random((b, t)) < 0.15, device=dev).float()

        def loss():
            return mlm_loss(model(inputs)[0], inputs, mpos)
        opt_kw = {"op": hvd.Adasum}
    elif name == "vit_b16":
        with torch.device(dev):
            model = get_model("vit_b16", attention="flash", generator=g)
            b, t = 128, 197
            inputs = torch.randn(b, 3, 224, 224, generator=g)
            labels = torch.randint(0, 1000, (b,), generator=g)

        def loss():
            return F.cross_entropy(model(inputs), labels)
    else:
        from horovod_tpu_torch.models.llama import loss_fn
        with torch.device(dev):
            model = get_model("llama", vocab_size=32000, max_seq_len=2048,
                              num_layers=24, num_heads=16, num_kv_heads=4,
                              d_model=1024, d_ff=2816, attention="flash",
                              generator=g)
        b, t = 4, 2048
        inputs = torch.tensor(rng.integers(0, model.cfg.vocab_size, (b, t)),
                              device=dev)

        def loss():
            return loss_fn(model(inputs), inputs)
    cfg = model.cfg
    lm = name != "vit_b16"
    info = dict(items=b * t if lm else b, unit="tokens" if lm else "images",
                inputs=inputs,
                head_macs=b * t * cfg.vocab_size * cfg.d_model if lm else 0,
                attention=(b, cfg.num_heads, t, name in ("gpt2_medium",
                                                         "llama_340m")),
                optimizer="AdamW, op=" + ("Adasum" if opt_kw else "Average"))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8), **opt_kw)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    return model, opt, loss, info


def phase_train_path(name, card, dev, steps=5):
    """Trains one path of ``build_path`` for ``steps`` steps: the loss must
    be finite and falling and each kernel must launch ``num_layers`` times
    a step (the counts set to 0 just before the steps and read just
    after). Returns tokens or images/s, the step split, peak memory, the
    share of the tensor-core bound, the losses and the launches."""
    import torch
    from horovod_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    model, opt, loss_of, info = build_path(name, dev)
    cfg, items, unit = model.cfg, info["items"], info["unit"]
    n_params = sum(p.numel() for p in model.parameters())
    from horovod_tpu_torch import fusion
    from horovod_tpu_torch.config import get_config
    grads = [p for p in model.parameters() if p.requires_grad]
    buckets = len(fusion.make_plan(
        [p.numel() for p in grads], [p.dtype for p in grads],
        get_config().fusion_threshold_bytes).buckets)
    log(f"{name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads, {n_params} params, {items} {unit} a step, "
        f"{cfg.dtype}, attention {cfg.attention}, {info['optimizer']}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    macs = _conv_macs(model, info["inputs"])
    b, h, t, causal = info["attention"]
    pairs = _visible_pairs(b * h, t, t, causal, 0, h)
    hd = cfg.d_model // cfg.num_heads
    # Model FLOPs: forward 2 per multiply-add of every dense layer, conv
    # and LM head, plus 4·d per visible (q, k) pair and layer; backward
    # twice the forward.
    flops = 3 * (2 * (macs + info["head_macs"])
                 + 4 * hd * pairs * cfg.num_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, wall, parts = [], [], []
    for step in range(steps):
        before = dict(fa.launches)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        opt.zero_grad()
        loss = loss_of()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        losses.append(loss.item())
        grew = {k: fa.launches[k] - before[k] for k in fa.KERNELS}
        log(f"{name} step {step}: loss {losses[-1]:.6f}  {wall[-1]:.3f} s  "
            f"forward {parts[-1][0]:.1f} ms  backward {parts[-1][1]:.1f} ms"
            f"  allreduce+adamw {parts[-1][2]:.1f} ms  launches {grew}")
        if any(v != cfg.num_layers for v in grew.values()):
            fail(f"{name}: each kernel must launch {cfg.num_layers} times a "
                 f"step, got {grew}")
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        fail(f"{name}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: loss is not falling: {losses}")
    steady = wall[1:]
    med = [statistics.median(p[i] for p in parts[1:]) for i in range(3)]
    step_ms = statistics.median(steady) * 1e3
    bound_ms = flops / PEAK_BF16_FLOPS * 1e3
    out = {f"{unit}_per_s": items * len(steady) / sum(steady),
           "step_ms_median": step_ms, "forward_ms": med[0],
           "backward_ms": med[1], "allreduce_adamw_ms": med[2],
           "peak_gib": peak / 2 ** 30, "step_tflop": flops / 1e12,
           "bound_ms": bound_ms, "share_of_bound": bound_ms / step_ms,
           "losses": losses, "launches": launches, "params": n_params,
           "buckets_per_step": buckets,
           "state_tensors": sum(torch.is_tensor(t)
                                for t in model.state_dict().values())}
    log(f"{name} on {card}: {out[f'{unit}_per_s']:.1f} {unit}/s (steps "
        f"1-{steps - 1}, wall), step {step_ms:.1f} ms median (forward "
        f"{med[0]:.1f}, backward {med[1]:.1f}, allreduce+adamw {med[2]:.1f} "
        f"ms, device time between events), peak memory "
        f"{out['peak_gib']:.2f} GiB; {flops / 1e12:.3f} TFLOP a step, "
        f"tensor-core bound {bound_ms:.3f} ms = {out['share_of_bound']:.4f}"
        f" of the step; launches {launches}; losses {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return out


def phase_adasum_card(dev):
    """Adasum on the card: on one rank it returns its input bit for bit;
    its arithmetic (the combine, a VHDD round's partial dot and norms
    summed over the two halves, the coefficients and the scaled add) on
    card tensors against float64 on the CPU, for fp32 and bf16 buffers of
    4 M elements. The fp32 results must hold 1e-5 of the float64 scale
    (|a||b| for the dot, |a|^2 for the norms, 1 for the coefficients, the
    largest element for vectors); the bf16 combine that plus one rounding
    to bf16 (2^-8 of each element)."""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import adasum as A
    g = torch.Generator(device=dev).manual_seed(6)
    n = 4 * 2 ** 20
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        x = torch.randn(n, generator=g, device=dev).to(dtype)
        if not torch.equal(hvd.allreduce(x, op=hvd.Adasum), x):
            fail(f"Adasum on one rank changed its {tag} input")
        pair = hvd.grouped_allreduce([x, x[:1000] * 2], op=hvd.Adasum)
        if not (torch.equal(pair[0], x) and torch.equal(pair[1],
                                                        x[:1000] * 2)):
            fail(f"grouped Adasum on one rank changed its {tag} inputs")
        a = torch.randn(n, generator=g, device=dev).to(dtype)
        b = (0.5 * a.float() + torch.randn(n, generator=g, device=dev)).to(
            dtype)
        a64, b64 = a.double().cpu(), b.double().cpu()
        want = torch.stack([a64 @ b64, a64 @ a64, b64 @ b64])
        scale = torch.stack([(want[1] * want[2]).sqrt(), want[1], want[2]])
        half = n // 2
        af, bf = a.float(), b.float()
        full = A.dot_and_norms(af, bf)
        split = (A.dot_and_norms(af[:half], bf[:half])
                 + A.dot_and_norms(af[half:], bf[half:]))
        errs = {}
        for what, got in (("dot and norms", full),
                          ("halves' partials summed", split)):
            errs[what] = ((got.double().cpu() - want).abs()
                          / scale).max().item()
        ca64 = 1 - want[0] / (2 * want[1])
        cb64 = 1 - want[0] / (2 * want[2])
        ca, cb = A.coefficients(*split.unbind())
        errs["coefficients"] = max(abs(ca.item() - ca64.item()),
                                   abs(cb.item() - cb64.item()))
        exact = ca64 * a64 + cb64 * b64
        top = exact.abs().max().item()
        errs["scaled add"] = ((A.scaled_add(ca, af, cb, bf).double().cpu()
                               - exact).abs().max().item() / top)
        comb = A.adasum_combine(a, b)
        if comb.dtype != dtype:
            fail(f"adasum_combine returned {comb.dtype} for {tag}")
        err = (comb.double().cpu() - exact).abs()
        # fp32: the fp32 limit; bf16: that plus one rounding to bf16, as a
        # share of that bound (at most 1).
        errs["combine"] = (err.max().item() / top if dtype == torch.float32
                           else (err / (2 ** -8 * exact.abs() + 1e-5 * top)
                                 ).max().item())
        lim = {k: 1e-5 for k in errs}
        if dtype == torch.bfloat16:
            lim["combine"] = 1.0
        log(f"Adasum arithmetic on the card, {tag}, {n} elements, against "
            f"float64 on the CPU: " + ", ".join(
                f"{k} {v:.3e} (limit {lim[k]:.1e})" for k, v in errs.items()))
        bad = [k for k, v in errs.items() if not v <= lim[k]]
        if bad:
            fail(f"Adasum arithmetic ({tag}) off float64 in {bad}")
        worst[tag] = errs
    return worst


def phase_join_mask(dev):
    """The join mask on the card: ``alive=0`` on the one rank gives zero
    (finite: ``n_alive`` is clamped to 1) gradients with Average and Sum,
    and a ``DistributedOptimizer`` step with ``alive=1`` equals one without
    the mask, bit for bit."""
    import copy
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig, loss_fn
    g = torch.Generator(device=dev).manual_seed(7)
    for op in (hvd.Average, hvd.Sum):
        grads = [torch.randn(300, generator=g, device=dev),
                 torch.randn(4, 5, generator=g, device=dev)]
        out = hvd.allreduce_gradients(grads, op=op, alive=0)
        if not all(torch.isfinite(t).all() and not t.any() for t in out):
            fail(f"alive=0 must give zero gradients (op {op})")
    with torch.device(dev):
        base = Llama(LlamaConfig.tiny(attention="flash"),
                     torch.Generator(device=dev).manual_seed(8))
    tokens = torch.randint(0, 256, (2, 64), generator=g, device=dev)
    after = []
    for alive in (None, 1):
        m = copy.deepcopy(base)
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters(),
                                                         lr=1e-3))
        opt.zero_grad()
        loss_fn(m(tokens), tokens).backward()
        if alive is None:
            opt.step()
        else:
            opt.step(alive=alive)
        after.append([p.detach().clone() for p in m.parameters()])
    if not all(torch.equal(a, b) for a, b in zip(*after)):
        fail("a step with alive=1 differs from a step without the mask")
    m = copy.deepcopy(base)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(m.parameters()))
    loss_fn(m(tokens), tokens).backward()
    opt.synchronize(alive=0)
    if any(p.grad.any() for p in m.parameters() if p.grad is not None):
        fail("alive=0 left a nonzero gradient in DistributedOptimizer")
    log("join mask on the card: alive=0 gives zero gradients (Average, "
        "Sum, DistributedOptimizer), alive=1 equals no mask bit for bit")


def phase_new_paths(card):
    """Phase 5 on a new one-rank NCCL world: returns its report."""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    dev = hvd.device()
    kernels = phase_path_kernels()
    phase_tiny_transformers(dev)
    trained = {name: phase_train_path(name, card, dev) for name in PATHS}
    adasum = phase_adasum_card(dev)
    phase_join_mask(dev)
    hvd.shutdown()
    torch.cuda.synchronize()
    return {"kernels": kernels, "trained": trained, "adasum": adasum}

# ---------------------------------------------------------------- phase 6

LOSS_TOL = 1e-6     # absolute: phase 3's losses, observed or not


def _phase_events(trace):
    """{op_id: [phase names]} of the trace's complete phase events."""
    ops: dict = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "phase" and e.get("ph") == "X":
            ops.setdefault(e["args"]["op_id"], []).append(
                (e["name"], e["args"]["kind"]))
    return ops


def _counter(snap, name, **labels):
    return sum(s["value"] for s in snap["counters"].get(name, [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def phase_controller(card, main_path):
    """Phase 6: the controller on the card. GPT-2 medium's phase-3 run
    again on a new one-rank NCCL world, under the timeline (started before
    ``init``, so init's clock anchor is in it), the metrics flusher and the
    stall watchdog that ``init`` starts; then a planted stall; then, with
    two cards, ``tools/torch_controller_bench.py --np 2``."""
    import os
    import tempfile
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics, timeline
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase6_")
    trace_path = os.path.join(tmp, "trace.json")
    prom_path = os.path.join(tmp, "metrics.prom")
    hvd.start_timeline(trace_path)
    hvd.init()
    if hvd.backend() != "nccl" or hvd.size() != 1:
        fail(f"expected a one-rank NCCL world, got {hvd.backend()} "
             f"x {hvd.size()}")
    hvd.start_metrics_flusher(prom_path, interval_s=0.5)
    dog = hvd.get_stall_watchdog()
    if dog is None or dog._thread is None:
        fail("init did not start the stall watchdog")
    before = metrics.snapshot()
    run = phase_train_path("gpt2_medium", card, hvd.device())
    after = metrics.snapshot()
    hvd.stop_timeline()
    hvd.stop_metrics_flusher()

    with open(trace_path) as f:
        trace = json.load(f)            # valid JSON, or this raises
    anchors = [e for e in trace["traceEvents"] if e["name"] == "clock_anchor"]
    if len(anchors) != 1 or anchors[0]["cat"] != "trace" or \
            anchors[0]["ph"] != "i" or set(anchors[0]["args"]) != {
                "epoch", "wall_time"}:
        fail(f"phase 6: no clock_anchor of the reference's form: {anchors}")
    ops = _phase_events(trace)
    if sorted(ops) != list(range(1, len(ops) + 1)):
        fail(f"phase 6: op ids are not 1..{len(ops)}: {sorted(ops)[:20]}")
    bad = {i: p for i, p in ops.items()
           if sorted(n for n, _ in p) != ["EXEC", "QUEUE"]}
    if bad:
        fail(f"phase 6: ops without one QUEUE and one EXEC: "
             f"{dict(list(bad.items())[:5])}")
    kinds = [p[0][1] for _, p in sorted(ops.items())]
    steps = len(run["losses"])
    delta = {k: _counter(after, "collective_calls_total", kind=k)
             - _counter(before, "collective_calls_total", kind=k)
             for k in ("allreduce", "broadcast")}
    buckets = (_counter(after, "fusion_buckets_total")
               - _counter(before, "fusion_buckets_total"))
    want = {"allreduce": steps, "broadcast": run["state_tensors"]}
    if delta != want or kinds.count("allreduce") != steps or \
            buckets != steps * run["buckets_per_step"]:
        fail(f"phase 6: collective_calls_total grew by {delta} (the steps "
             f"issued {want}), {kinds.count('allreduce')} allreduce spans, "
             f"fusion_buckets_total by {buckets} (the plan: "
             f"{steps} x {run['buckets_per_step']})")
    with open(prom_path) as f:
        prom = f.read()
    line = 'horovod_tpu_collective_calls_total{kind="allreduce"}'
    if f"{line} {_counter(after, 'collective_calls_total', kind='allreduce')}" \
            not in prom:
        fail(f"phase 6: the metrics file lacks {line}")
    diffs = [abs(a - b) for a, b in zip(run["losses"],
                                        main_path["losses"])]
    if len(diffs) != steps or max(diffs) > LOSS_TOL:
        fail(f"phase 6: losses {run['losses']} differ from phase 3's "
             f"{main_path['losses']} by up to {max(diffs):.3e} "
             f"(limit {LOSS_TOL})")
    log(f"phase 6: GPT-2 medium under the timeline, the metrics flusher and "
        f"the stall watchdog: {len(ops)} ops with QUEUE and EXEC, op ids "
        f"1..{len(ops)} ({steps} grouped allreduces, {delta['broadcast']} "
        f"broadcasts), fusion_buckets_total +{buckets}, losses within "
        f"{max(diffs):.3e} of phase 3's; step {run['step_ms_median']:.2f} ms "
        f"median of steps 2-{steps} against phase 3's "
        f"{main_path['step_ms_median']:.2f} ms")

    # A planted stall: a collective that begins and never ends.
    stall_path = os.path.join(tmp, "stall.json")
    timeline.start_timeline(stall_path)
    seen = []
    n0 = metrics.registry.counter("stall_events_total").value
    tok = metrics.collective_begin("allreduce", name="planted/stall",
                                   nbytes=4096)
    planted = metrics.StallWatchdog(timeout_s=0.2, poll_s=0.05,
                                    on_stall=seen.append).start()
    try:
        time.sleep(0.8)
    finally:
        planted.stop()
        metrics.collective_end(tok)
        timeline.stop_timeline()
    with open(stall_path) as f:
        marks = [e for e in json.load(f)["traceEvents"]
                 if e["name"] == "collective_stall"]
    fired = metrics.registry.counter("stall_events_total").value - n0
    if len(seen) != 1 or seen[0]["tensor"] != "planted/stall" or \
            fired != 1 or len(marks) != 1 or \
            marks[0]["args"]["tensor"] != "planted/stall":
        fail(f"phase 6: the planted stall fired {len(seen)} reports "
             f"({seen}), stall_events_total +{fired}, {len(marks)} markers")
    log(f"phase 6: planted stall reported once after "
        f"{seen[0]['pending_s']:.3f} s: {seen[0]}")
    hvd.shutdown()
    torch.cuda.synchronize()

    world = None
    if torch.cuda.device_count() >= 2:
        proc = subprocess.run(
            [sys.executable, "tools/torch_controller_bench.py", "--np", "2"],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"phase 6: the two-rank NCCL world failed:\n"
                 f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        world = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"phase 6: two-rank NCCL world on two cards: {world}")
    else:
        log("phase 6: the two-rank NCCL part (join service, mismatch, "
            "negotiation time) did not run for want of a second card "
            f"(cards: {torch.cuda.device_count()})")
    return {"step_ms_median": run["step_ms_median"],
            "phase3_step_ms_median": main_path["step_ms_median"],
            "losses": run["losses"], "max_loss_diff": max(diffs),
            "ops": len(ops), "collective_calls": delta,
            "fusion_buckets": buckets, "launches": run["launches"],
            "stall_report": seen[0], "two_rank_world": world}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phases to run (default "
                         "1,2,3,4,5,6; 6 needs 3)")
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    if 6 in phases and 3 not in phases:
        fail("phase 6 compares its losses with phase 3's: run both")

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the GPU")
    try:
        import horovod_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"horovod_tpu_torch is not importable ({e}); run from the "
             "repository root")
    card = phase_build()
    report = phase_kernels() if 2 in phases else {}
    launches = {}     # path -> {kernel: launches in that path's run}
    if 3 in phases:
        phase_reference_check()
        main_path = phase_main_path(card)
        launches["gpt2_medium"] = main_path.pop("launches")
        print(json.dumps({"main_path": main_path}), flush=True)
    if 4 in phases:
        print(json.dumps({"models": phase_models(card)}), flush=True)
    shapes = {}
    if 5 in phases:
        new = phase_new_paths(card)
        shapes = new.pop("kernels")
        for name, run in new["trained"].items():
            launches[name] = run.pop("launches")
        print(json.dumps({"phase5": new}), flush=True)
    if 6 in phases:
        ctl = phase_controller(card, main_path)
        launches["gpt2_medium_controller"] = ctl.pop("launches")
        print(json.dumps({"phase6": ctl}), flush=True)
    for name, row in report.items():
        row["launches_per_path"] = {p: n.get(name, 0)
                                    for p, n in launches.items()}
        row["launches"] = sum(row["launches_per_path"].values())
        row["paths"] = {p: k[name] for p, k in shapes.items()}
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
