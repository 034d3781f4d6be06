#!/usr/bin/env python3
"""The flash ring and Ulysses across cards: ``python3
tools/torch_ring_bench.py --np N [--mode hop|gpt2] [--device cuda|cpu]``.

``--mode hop`` (default) spawns an N-rank world of ``horovod_tpu_torch``
(NCCL, one card a rank, or gloo with ``--device cpu``) with B 2, H 16, d 64
bf16 and ``--t-local`` tokens a rank (T_global = N x t_local) and measures,
on every rank, median ms over ``--reps`` runs after a barrier:

1. one hop's kernels: the forward kernel and the backward pair (dQ, then
   dK/dV with the hop's lse and delta) in each mode a hop can take ("full",
   "causal", "strict");
2. one hop's exchange alone: K and V (bf16) to the next rank, as every hop
   of the forward and the backward ships them, and the fp32 dK/dV partial
   sums the backward ships besides, with their bytes;
3. the whole ring, ``ring_flash_attention`` forward and backward, causal,
   contiguous and striped, with each hop's exchange posted before its
   kernels (as shipped) and with it waited on before them (serialized);
4. on rank 0 alone, ``flash_attention`` over the whole T_global on one
   card, forward and backward.

``--mode gpt2`` trains GPT-2 medium at T_global ``--t-global`` (8192), B 2,
``gpt2_long``'s "dots" remat and ``DistributedOptimizer(AdamW(1e-4))`` for
``--steps`` steps on one seeded batch, three ways: the striped flash ring
on N ranks (the tokens fed striped, as ``examples/gpt2_long_context.py``
feeds them, under ``striped_lm_loss``), Ulysses on N ranks (contiguous
shards; the exact next-token loss over the whole sequence, each rank
fetching its last target from the next rank), and one card through
``flash_attention`` with ``loss_fn``. Every step's loss on N ranks must lie
within ``--band`` of the one card's, and each kernel must launch as the
path says a step. ``chip_smoke.py`` phase 10 (d) runs both modes with
``--np 2`` where the machine has two cards.

Prints one JSON line; exit code 0 when every check holds.
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
B, H, D = 2, 16, 64
MODES = {"full": (False, 0), "causal": (True, 0), "strict": (True, -1)}


def _timer(device, world=True):
    """``ms(fn, reps)``: the median of ``reps`` runs, each after a barrier
    of the world (unless ``world`` is False); CUDA events on the card, the
    host clock on the CPU."""
    import torch
    import torch.distributed as dist

    def ms(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            if device == "cuda":
                torch.cuda.synchronize()
            if world:
                dist.barrier()
            if device == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return ms


def hop_worker(device, t_local, reps, out_dir):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.ops import ring_flash as rf
    from horovod_tpu_torch.ops.ring_attention import Ring

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    g = torch.Generator(device=dev).manual_seed(r)
    q, k, v, do = (torch.randn(B, t_local, H, D, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    Q, K, V, DO = (rf._pack(x) for x in (q, k, v, do))
    ms, ring, scale = _timer(device), Ring(), D ** -0.5
    out = {"rank": r, "ranks": n, "t_local": t_local, "kernels": {}}
    for mode, (causal, offset) in MODES.items():
        o, lse = fa.flash_fwd(Q, K, V, None, None, None, H, scale, causal,
                              offset)
        delta = (DO.float() * o.float()).sum(-1)
        out["kernels"][mode] = {
            "forward": ms(lambda: fa.flash_fwd(
                Q, K, V, None, None, None, H, scale, causal, offset), reps),
            "backward": ms(lambda: (
                fa.flash_bwd_dq(Q, K, V, None, None, None, DO, lse, delta,
                                H, scale, causal, offset),
                fa.flash_bwd_dkv(Q, K, V, None, None, None, DO, lse, delta,
                                 H, scale, causal, offset, False)), reps)}
    acc = [torch.zeros(K.shape, device=dev), torch.zeros(V.shape,
                                                         device=dev)]
    out["exchange"] = {
        "kv_bytes": K.nbytes + V.nbytes,
        "kv_ms": ms(lambda: ring.shift([K, V]), reps),
        "dkv_bytes": sum(x.nbytes for x in acc),
        "dkv_ms": ms(lambda: ring.shift(acc), reps)}

    def whole(layout):
        qq, kk, vv = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        rf.ring_flash_attention(qq, kk, vv, causal=True,
                                layout=layout).backward(do)
    shipped = Ring.post

    def serialized(self, send, forward=True, into=None):
        return self.wait(shipped(self, send, forward, into)), [], ()
    out["ring"] = {}
    for layout in ("contiguous", "striped"):
        out["ring"][layout] = {"overlapped": ms(lambda: whole(layout), reps)}
        Ring.post = serialized
        try:
            out["ring"][layout]["serialized"] = ms(lambda: whole(layout),
                                                   reps)
        finally:
            Ring.post = shipped
    dist.barrier()
    if r == 0:
        gq, gk, gv, gdo = (torch.randn(B, n * t_local, H, D, generator=g,
                                       device=dev).to(dtype)
                           for _ in range(4))

        def one_card():
            qq, kk, vv = (x.detach().clone().requires_grad_(True)
                          for x in (gq, gk, gv))
            fa.flash_attention(qq, kk, vv, causal=True).backward(gdo)
        out["one_card_ms"] = _timer(device, world=False)(one_card, reps)
    dist.barrier()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)


def contiguous_lm_loss(logits, tokens, ring):
    """Next-token cross entropy over the whole sequence of the contiguous
    layout: each rank's last target is the next rank's first token, and the
    last rank's last position predicts nothing; every rank returns the
    global mean through a differentiable allreduce."""
    import torch
    from torch.distributed.nn.functional import all_reduce
    t = tokens.shape[1]
    nxt = ring.shift([tokens[:, :1].contiguous()], forward=False)[0]
    targets = torch.cat([tokens[:, 1:], nxt], 1)
    valid = torch.ones(t, dtype=torch.bool, device=tokens.device)
    if ring.rank == ring.n - 1:
        valid[-1] = False
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    s = torch.where(valid, ll, torch.zeros((), device=ll.device)).sum()
    c = valid.to(ll.dtype).sum() * tokens.shape[0]
    return -all_reduce(s, group=ring.group) / all_reduce(c, group=ring.group)


def gpt2_worker(kind, device, t_global, steps, out_dir):
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import get_model
    from horovod_tpu_torch.models.gpt2 import loss_fn, striped_lm_loss
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.ops.ring_attention import Ring

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    sp = {"one": {},
          "striped": dict(use_ring_attention=True, sp_impl="ring",
                          ring_layout="striped"),
          "ulysses": dict(use_ring_attention=True, sp_impl="ulysses")}[kind]
    # GPT-2 medium on the card; a two-layer GPT-2 for a CPU rehearsal.
    name, width = ("gpt2_medium", {}) if device == "cuda" else (
        "gpt2", dict(num_layers=2, num_heads=4, d_model=64, vocab_size=512))
    with torch.device(dev):
        model = get_model(name, max_seq_len=t_global,
                          attention="flash", remat=True, remat_policy="dots",
                          generator=torch.Generator(device=dev).manual_seed(
                              0), **sp, **width)
    cfg = model.cfg
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, t_global)), device=dev)
    t = t_global // n
    if kind == "striped":
        x = tokens[:, r::n].contiguous()
    else:
        x = tokens[:, r * t:(r + 1) * t].contiguous()
    ring = Ring()

    def loss():
        if kind == "striped":
            return striped_lm_loss(model(x), x)
        if kind == "ulysses":
            return contiguous_lm_loss(model(x), x, ring)
        return loss_fn(model(x), x)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4, eps=1e-8))
    hops = n if kind == "striped" else 1
    want = {"flash_fwd": 2 * hops * cfg.num_layers,
            "flash_bwd_dq": hops * cfg.num_layers,
            "flash_bwd_dkv": hops * cfg.num_layers}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, wall, grew = [], [], []
    for _ in range(steps):
        before = dict(fa.launches)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        value = loss()
        value.backward()
        opt.step()
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(value.item())
        grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
    out = {"rank": r, "kind": kind, "ranks": n, "t_global": t_global,
           "losses": losses, "wall_ms": wall,
           "step_ms": statistics.median(wall[1:]),
           "tokens_per_s_world": B * t_global / statistics.median(
               wall[1:]) * 1e3,
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if device == "cuda" else 0.0),
           "launches_per_step": grew,
           "launches_ok": device != "cuda" or all(x == want for x in grew)}
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)


def _world(nranks, args, timeout):
    """Every rank's report of one spawned world running ``args``."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
             str(nranks), "--timeout", str(int(timeout)),
             os.path.abspath(__file__)] + args + ["--out-dir", tmp],
            cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
            capture_output=True, text=True, timeout=timeout + 60)
        if proc.returncode != 0:
            raise RuntimeError(f"{args} world failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        ranks = []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    return ranks


def run_hop(nranks, device, t_local, reps, timeout=600.0):
    ranks = _world(nranks, ["--hop-worker", device, str(t_local),
                            str(reps)], timeout)
    return {"mode": "hop", "ranks": nranks, "device": device, "ok": True,
            "per_rank": ranks}


def run_gpt2(nranks, device, t_global, steps, band, timeout=900.0):
    runs = {kind: _world(n, ["--gpt2-worker", kind, device, str(t_global),
                             str(steps)], timeout)
            for kind, n in (("one", 1), ("striped", nranks),
                            ("ulysses", nranks))}
    ref = runs["one"][0]["losses"]
    out = {"mode": "gpt2", "ranks": nranks, "device": device,
           "t_global": t_global, "band": band, "one_card": runs["one"][0]}
    ok = all(map(math.isfinite, ref)) and ref[-1] < ref[0]
    for kind in ("striped", "ulysses"):
        per = runs[kind]
        diff = max(abs(a - w) for x in per for a, w in zip(x["losses"], ref))
        same = all(x["losses"] == per[0]["losses"] for x in per)
        ok = ok and diff <= band and same and all(
            x["launches_ok"] for x in per)
        out[kind] = {"max_loss_diff": diff, "ranks_agree": same,
                     "per_rank": per}
    out["ok"] = ok
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="hop", choices=("hop", "gpt2"))
    ap.add_argument("--t-local", type=int, default=4096)
    ap.add_argument("--t-global", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--hop-worker", nargs=3, help=argparse.SUPPRESS)
    ap.add_argument("--gpt2-worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.hop_worker:
        device, t_local, reps = args.hop_worker
        hop_worker(device, int(t_local), int(reps), args.out_dir)
        return 0
    if args.gpt2_worker:
        kind, device, t_global, steps = args.gpt2_worker
        gpt2_worker(kind, device, int(t_global), int(steps), args.out_dir)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load the kernels
    if args.mode == "hop":
        out = run_hop(args.np, args.device, args.t_local, args.reps)
    else:
        out = run_gpt2(args.np, args.device, args.t_global, args.steps,
                       args.band)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
