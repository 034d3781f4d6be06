#!/usr/bin/env python3
"""Megatron tensor parallelism across cards: ``python3
tools/torch_tp_bench.py --np N [--mesh dpXxmpY] [--device cuda|cpu]
[--model gpt2_medium|t5_small] [--steps 5] [--band 1e-3]``. ``--np 2``
and ``--np 4`` split the model over a pure mp mesh (``dp1xmpN``);
``--np 4 --mesh dp2xmp2`` runs two data-parallel rows of two
tensor-parallel ranks.

``--model t5_small``: T5-small (bf16 compute, fp32 parameters, seed 0; a
two-layer d-64 T5 with ``--device cpu``) at ``chip_smoke.py`` phase 15's
shape, B 16, 512 source and 512 target tokens with four padded source
tails, split by T5's own rules and trained under ``t5.seq2seq_loss``
(vocab-parallel on a split model) with the same optimizer. A step then
issues 4 in-step allreduces an encoder layer and 7 a decoder layer (g at
``o`` and ``wo``; f at the attention and MLP inputs, the cross attention's
kv taking its own) and 7 more (two embedding sums, the loss's max and
sums, the two bias tables' f and the head's f); no flash kernel
launches. Decode is not run: a split T5 refuses it.

GPT-2 medium (``attention="flash"``, bf16 compute, fp32 parameters, seed
0; a two-layer d-64 GPT-2 with ``--device cpu``, a gloo rehearsal), built
alike on every rank and turned into each rank's part by
``mp.tensor_parallel``, trains ``--steps`` AdamW steps (lr 1e-4, weight
decay 1e-4, eps 1e-8; ``DistributedOptimizer`` over the mesh's dp set) on
one fixed batch of 8 x 1024 tokens (``chip_smoke.py`` phase 3's rows; each
dp row takes its contiguous share, the ranks of an mp set the same rows)
under ``mp.vocab_parallel_loss``. Then greedy decode: GPT-2 medium with
bf16 parameters (dense attention, seed 0), B 8, a 32-token prompt and 32
new tokens, each rank holding its ``split_params`` part and 16/mp kv
heads of the cache, through ``mp.tp_decode_step``. The same job runs on
one rank first (``dp1xmp1``).

Checks (exit code 0 when every one holds):

* every step's loss, averaged over the dp rows, lies within ``--band`` of
  the one rank's (the same mean over the same tokens, the row-parallel
  sums taken in another order), the ranks of a row agree, and the one
  rank's losses are finite and falling;
* each rank holds 1/mp of every split weight: its parameter bytes equal
  ``param_bytes`` of its ``split_params`` part, and the ratio to the whole
  model's is printed (about 0.50 at mp 2 and 0.26 at mp 4 for GPT-2
  medium, with ``wpe``, the norms and the row-parallel biases whole);
* a step issues 4 in-step allreduces a layer (2 f in the backward, 2 g in
  the forward) and 4 more (the embedding's g, the loss's max and sums,
  the head's f), and each flash kernel launches once a layer;
* decode: teacher-forced on the one rank's tokens, every token where the
  one rank's top two logits differ by more than 0.04 (``chip_smoke``'s
  ``DECODE_CLEAR_GAP``) equals its greedy choice; whether all tokens are
  identical is printed.

Per rank it reports ms a step (median of steps 1 on, wall clock behind
``torch.cuda.synchronize()``), tokens/s, peak memory and ms a decode step;
on the card also the step's split (device ms of the forward with the
loss, the backward and the optimizer between CUDA events, and the host's
ms to issue the forward and the backward) and one more step under
``torch.profiler``: the device's busy ms, the NCCL kernels' ms and the
top kernels by device time. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("gpt2_medium", "t5_small")
B, T = 8, 1024
# T5-small at phase 15's shape: B 16, 512 source and target tokens.
T5_B, T5_T = 16, 512
PROMPT, NEW = 32, 32
CLEAR_GAP = 0.04


def _gpt2(device, dev, **kw):
    """GPT-2 medium on the card, a tiny GPT-2 on the CPU, seed 0."""
    import torch
    from horovod_tpu_torch.models import get_model
    name, width = ("gpt2_medium", {}) if device == "cuda" else (
        "gpt2", dict(num_layers=2, num_heads=4, d_model=64, vocab_size=512,
                     max_seq_len=T, dtype=torch.float32))
    with torch.device(dev):
        return get_model(name, generator=torch.Generator(
            device=dev).manual_seed(0), **width, **kw)


def _t5(device, dev):
    """T5-small on the card, a tiny T5 on the CPU, seed 0, with phase 15's
    batch: (model, source ids with four padded tails, target ids)."""
    import numpy as np
    import torch
    from horovod_tpu_torch.models import get_model
    width = {} if device == "cuda" else dict(
        num_encoder_layers=2, num_decoder_layers=2, d_model=64, d_ff=128,
        num_heads=4, head_dim=16, vocab_size=512, dtype=torch.float32)
    with torch.device(dev):
        model = get_model("t5_small", generator=torch.Generator(
            device=dev).manual_seed(0), **width)
    rng = np.random.default_rng(0)
    v = model.cfg.vocab_size
    src = rng.integers(1, v, (T5_B, T5_T))
    for i in range(4):
        src[i, T5_T - 64 * (i + 1):] = model.cfg.pad_id
    tgt = rng.integers(1, v, (T5_B, T5_T))
    return model, torch.tensor(src), torch.tensor(tgt)


def _traced_allreduces() -> float:
    from horovod_tpu_torch import metrics
    return sum(s["value"] for s in metrics.snapshot()["counters"].get(
        "collective_traced_total", [])
        if s["labels"].get("kind") == "allreduce")


def worker(device, steps, out_dir, gold_path, name="gpt2_medium"):
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import generate as G
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.parallel import mp

    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    mesh = hvd.mesh2d()
    dp_set = mesh.process_set("dp")
    n_mp, n_dp = hvd.mp_size(), hvd.dp_size()
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t5 = name == "t5_small"
    if t5:
        from horovod_tpu_torch.models.t5 import seq2seq_loss
        model, src, tgt = _t5(device, dev)
        split = mp._split_t5
        b, items = T5_B, T5_B * T5_T
    else:
        model = _gpt2(device, dev, attention="flash")
        split = mp.split_params
        tokens = torch.randint(0, model.cfg.vocab_size, (B, T),
                               generator=torch.Generator().manual_seed(0))
        b, items = B, B * T
    cfg = model.cfg
    whole_bytes = mp.param_bytes(model.state_dict())
    part_bytes = mp.param_bytes(split(cfg, model.state_dict(), n_mp,
                                      hvd.mp_rank()))
    mp.tensor_parallel(model)
    held = mp.param_bytes(model.state_dict())
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8),
        process_set=dp_set)
    rows = slice(hvd.dp_rank() * (b // n_dp),
                 (hvd.dp_rank() + 1) * (b // n_dp))
    if t5:
        src, tgt = src[rows].to(dev), tgt[rows].to(dev)

        def loss_of():
            return seq2seq_loss(model, src, tgt)
    else:
        tok = tokens[rows].to(dev)

        def loss_of():
            return mp.vocab_parallel_loss(model(tok), tok)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, wall, grew, traced, split = [], [], [], [], []

    def step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
            if cuda else None
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        opt.zero_grad()
        loss = loss_of()
        t1 = time.perf_counter()
        if cuda:
            ev[1].record()
        loss.backward()
        t2 = time.perf_counter()
        if cuda:
            ev[2].record()
        opt.step()
        if cuda:
            ev[3].record()
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                         + [(t1 - t0) * 1e3, (t2 - t1) * 1e3])
        return loss

    for _ in range(steps):
        before, n0 = dict(fa.launches), _traced_allreduces()
        loss = step()
        traced.append(_traced_allreduces() - n0)
        grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
        losses.append(hvd.allreduce(loss.detach().reshape(1),
                                    op=hvd.Average,
                                    process_set=dp_set).item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    if t5:
        layers = 0
        want_traced = 0 if n_mp == 1 else (4 * cfg.num_encoder_layers
                                          + 7 * cfg.num_decoder_layers + 7)
    else:
        layers = cfg.num_layers
        want_traced = 0 if n_mp == 1 else 4 * layers + 4
    step_ms = statistics.median(wall[1:]) if len(wall) > 1 else wall[0]
    split_ms = None if not split else dict(zip(
        ("forward", "backward", "optimizer", "host_forward",
         "host_backward"),
        (statistics.median(x[i] for x in split[1:] or split)
         for i in range(5))))
    profile = None
    if cuda:
        profile = _profiled_step(step)
        profile["step_ms"] = wall.pop()
    out = {"rank": r, "dp": n_dp, "mp": n_mp, "losses": losses,
           "wall_ms": wall, "step_ms": step_ms,
           "tokens_per_s": items / step_ms * 1e3, "peak_gib": peak,
           "param_bytes": held, "whole_param_bytes": whole_bytes,
           "param_bytes_ratio": held / whole_bytes,
           "param_bytes_ok": held == part_bytes,
           "traced_allreduces_per_step": traced,
           "traced_ok": all(x == want_traced for x in traced),
           "launches_per_step": grew, "profile": profile,
           "split_ms": split_ms,
           "launches_ok": not cuda or all(
               x == {k: layers for k in fa.KERNELS} for x in grew)}
    del model, opt
    if cuda:
        torch.cuda.empty_cache()
    if t5:
        hvd.shutdown()
        with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
            json.dump(out, fh)
        return

    # Greedy decode over this rank's part, teacher-forced on the one rank's
    # tokens once they exist.
    dec = _gpt2(device, dev, attention="dense")
    if cuda:
        dec = dec.to(torch.bfloat16)
    part = mp.split_params(cfg, dec.state_dict(), n_mp, hvd.mp_rank())
    del dec
    hd = cfg.d_model // cfg.num_heads
    total = PROMPT + NEW
    cache = {i: {k: torch.zeros(B, total, cfg.num_heads // n_mp, hd,
                                dtype=cfg.dtype, device=dev) for k in "kv"}
             for i in range(layers)}
    prompt = torch.randint(1, cfg.vocab_size, (B, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    gold = None
    if gold_path:
        with open(gold_path) as fh:
            gold = torch.tensor(json.load(fh)["decode_tokens"])
    step = mp.tp_decode_step(cfg)
    seq, tok_t, step_ms_d, gaps, picks = [prompt[:, 0]], prompt[:, 0], [], \
        [], []
    for t in range(total - 1):
        sync()
        t0 = time.perf_counter()
        cache, logits = step(part, cache, tok_t.to(dev), t)
        sync()
        step_ms_d.append((time.perf_counter() - t0) * 1e3)
        pick = G.greedy_token(logits).cpu()
        top2 = logits.float().topk(2, dim=-1).values.cpu()
        gaps.append((top2[:, 0] - top2[:, 1]).tolist())
        picks.append(pick.tolist())
        if t + 1 < PROMPT:
            tok_t = prompt[:, t + 1]
        else:
            tok_t = pick if gold is None else gold[:, t + 1]
        seq.append(tok_t)
    out.update(decode_tokens=torch.stack(seq, 1).tolist(),
               decode_picks=picks, decode_gaps=gaps,
               decode_ms_per_step=statistics.median(step_ms_d))
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)


def _profiled_step(step) -> dict:
    """One more ``step()`` under ``torch.profiler``: the device's busy ms
    (kernels, copies and sets; not the annotated ranges around them), the
    NCCL kernels' ms and the top eight kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0 and not e.is_user_annotation
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda x: -x[1])
    return {"device_busy_ms": sum(ms for _, ms in rows),
            "nccl_ms": sum(ms for k, ms in rows if "nccl" in k.lower()),
            "top": rows[:8]}


def _world(nranks, args, timeout, **env):
    """Every rank's report of one spawned world running ``args``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__)] + args + ["--out-dir", tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1", **env),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"{args} world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        return [json.load(open(os.path.join(tmp, f"rank{i}.json")))
                for i in range(nranks)]


def run(nranks, mesh, device, steps, band, name="gpt2_medium",
        timeout=900.0):
    t5 = name == "t5_small"
    one = _world(1, ["--worker", device, str(steps), "", name], timeout,
                 HOROVOD_MESH="dp1xmp1")[0]
    with tempfile.TemporaryDirectory() as tmp:
        gold = os.path.join(tmp, "one.json")
        with open(gold, "w") as fh:
            json.dump({"decode_tokens": one.get("decode_tokens")}, fh)
        per = _world(nranks, ["--worker", device, str(steps), gold, name],
                     timeout, HOROVOD_MESH=mesh)
    ref = one["losses"]
    diff = max(abs(a - w) for x in per for a, w in zip(x["losses"], ref))
    n_mp = per[0]["mp"]
    rows_agree = all(x["losses"] == per[(i // n_mp) * n_mp]["losses"]
                     for i, x in enumerate(per))
    # Decode: the N-rank picks, teacher-forced on the one rank's tokens,
    # against the one rank's picks where its top two are clear of a tie.
    # A split T5 refuses decode: nothing to compare (identical is None).
    clear_wrong, identical = 0, None if t5 else True
    for x in ([] if t5 else per):
        for got, want, gap in zip(x["decode_picks"], one["decode_picks"],
                                  one["decode_gaps"]):
            for g_, w_, d_ in zip(got, want, gap):
                identical = identical and g_ == w_
                clear_wrong += int(g_ != w_ and d_ > CLEAR_GAP)
    checks = {
        "one_rank_falls": all(map(math.isfinite, ref)) and ref[-1] < ref[0],
        "within_band": diff <= band,
        "rows_agree": rows_agree,
        "param_bytes_are_the_part": all(x["param_bytes_ok"] for x in per),
        "in_step_allreduces": all(x["traced_ok"] for x in per),
        "launches": one["launches_ok"] and all(x["launches_ok"]
                                               for x in per),
        "decode_clear_tokens_equal": clear_wrong == 0,
    }
    keep = ("losses", "step_ms", "tokens_per_s", "peak_gib", "param_bytes",
            "param_bytes_ratio", "traced_allreduces_per_step",
            "wall_ms", "split_ms", "profile") \
        + (() if t5 else ("decode_ms_per_step",))
    return {"ranks": nranks, "mesh": mesh, "device": device, "model": name,
            "steps": steps,
            "band": band, "max_loss_diff": diff,
            "decode_tokens_identical": identical,
            "decode_clear_tokens_wrong": clear_wrong, "checks": checks,
            "ok": all(checks.values()),
            "one_rank": {k: one[k] for k in keep},
            "per_rank": [{k: x[k] for k in keep + ("rank", "dp", "mp")}
                         for x in per]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--mesh", default=None,
                    help="dp x mp spec (default dp1xmpN)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model", default="gpt2_medium", choices=MODELS)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        device, steps, gold, name = args.worker
        worker(device, int(steps), args.out_dir, gold, name)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load the kernels
    mesh = args.mesh or f"dp1xmp{args.np}"
    out = run(args.np, mesh, args.device, args.steps, args.band, args.model)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
