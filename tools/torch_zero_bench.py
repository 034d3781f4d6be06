#!/usr/bin/env python3
"""ZeRO-1, ZeRO-2 and ZeRO-3 across cards: ``python3 tools/torch_zero_bench.py
--np N [--stage 1|2|3] [--device cuda|cpu] [--steps 5] [--band 1e-3]``, and
FSDP x tensor parallelism: ``--np 4 --mesh dp2xmp2``.

GPT-2 medium (``attention="flash"``, bf16 compute, fp32 parameters, seed
0; a two-layer d-64 GPT-2 with ``--device cpu``, a gloo rehearsal) trains
``--steps`` AdamW steps (lr 1e-4, weight decay 1e-4, eps 1e-8) on one
fixed global batch of 8 x 1024 tokens (``chip_smoke.py`` phase 3's rows),
twice: on N ranks (NCCL, one card a rank), each rank taking its
``ShardedBatchIterator`` share of the batch (rows r, r + N, ...), and on
one rank over the whole batch. ``--stage`` picks the ZeRO stage:

* 1 (default): ``sharded_adamw`` over the gradients of
  ``hvd.value_and_grad`` over ``torch.func.functional_call``;
* 2: ``parallel.zero2_grad_shard`` of each rank's own gradients and
  ``zero2_update`` over the whole model;
* 3: the blocks as ``stack_layer_shards`` rows through
  ``fsdp_scan_blocks`` and ``fsdp_adamw``, the rest under
  ``sharded_adamw`` (``chip_smoke._fsdp_trainer``, phase 12 (a)'s step).

Checks:

* every step's loss on N ranks (averaged over them) lies within
  ``--band`` of the one rank's (the same mean over the same tokens,
  summed in another order), the ranks agree, the losses are finite and
  falling;
* each rank's moments hold ceil(L/N) elements (L parameter elements; for
  stage 3 each rank's rows are (layers, ceil(L_block/N)) and its block
  moments the same), and each kernel launches ``num_layers`` times a step
  (stage 3: the forward twice that);
* stage 1: the N-rank job's last state, saved through
  ``ShardedCheckpointManager`` (``checkpoint_sharded.save_state`` of a
  ``TensorState``: each rank writes its row), restores on one rank
  (N -> 1) equal, bit for bit, to the N ranks' rows gathered
  (``reshard_opt_state``);
* stage 3: an ``FsdpState`` committed at N ranks, then, in the same
  processes, ``sync()``ed and restored in a world of N/2 ranks (and so on
  down to one), gives each rank its row of the unpadded vectors padded for
  the new world, and the vectors committed again there equal the first
  commit, bit for bit.

Per rank it reports ms a step (median of steps 1 on, wall clock behind
``torch.cuda.synchronize()``), peak memory, the parameter bytes it holds
and the moments' bytes. ``--mesh dp2xmp2`` (four ranks) runs GPT-2
medium's MLP at full width (d 1024, ff 4096, fp32, tanh GELU)
Megatron-split over mp (the fc rows and bias, the proj columns, the
partial outputs summed by ``psum_fwd_identity_bwd``) under ``fsdp_apply``
over dp, on 4 x 256 tokens a dp rank; every rank also runs the whole
block on the whole batch on its card, and its loss (rtol 1e-5) and its
fiber's row of the gradients (within 1e-4 of the largest gradient, rtol
2e-4) must equal that. Prints one JSON line; exit code 0 when every check
holds. ``chip_smoke.py`` phase 11 (e) runs ``--np 2``, phase 12 (e)
``--stage 3`` and ``--mesh dp2xmp2`` where the machine has the cards.
"""

from __future__ import annotations

import argparse
import hashlib
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
B, T = 8, 1024


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _model_builder(device):
    """``build(dev)``: GPT-2 medium on the card, a tiny GPT-2 on the
    CPU."""
    import torch
    from horovod_tpu_torch.models import get_model
    name, width = ("gpt2_medium", {}) if device == "cuda" else (
        "gpt2", dict(num_layers=2, num_heads=4, d_model=64, vocab_size=512,
                     max_seq_len=T, dtype=torch.float32))

    def build(dev):
        with torch.device(dev):
            return get_model(name, attention="flash",
                             generator=torch.Generator(
                                 device=dev).manual_seed(0), **width)
    return build


def _fsdp_state_remesh(device, fs, out, ports):
    """The stage-3 re-mesh: ``fs`` (committed in this world of n ranks)
    goes to worlds of n/2, n/4, ..., 1 in these processes (ranks that
    leave stop here); in each, ``sync()`` then each rank's row and a new
    commit are checked against the first commit. Returns whether this
    rank's checks held."""
    import numpy as np
    import horovod_tpu_torch as hvd
    canon = {k: fs._saved[k] for k in ("shard", "mu", "nu")}
    r, n = hvd.rank(), hvd.size()
    ok, worlds = True, []
    m = n // 2
    while m >= 1:
        hvd.shutdown()
        if r >= m:
            break
        env = dict(WORLD_SIZE=str(m), RANK=str(r), LOCAL_SIZE=str(m),
                   LOCAL_RANK=str(r))
        if m > 1:
            env["MASTER_PORT"] = str(ports.pop(0))
        else:
            for k in ("MASTER_ADDR", "MASTER_PORT"):
                os.environ.pop(k, None)
        os.environ.update(env)
        hvd.init(device=device)
        t0 = time.perf_counter()
        fs.sync()
        sync_s = time.perf_counter() - t0
        rows = {"shard": fs.shard, "mu": fs.opt_state.mu,
                "nu": fs.opt_state.nu}
        row_ok = all(np.array_equal(
            rows[k].cpu().numpy(),
            fs._row(canon[k], m, r, "cpu").numpy()) for k in canon)
        fs.commit()
        commit_ok = all(np.array_equal(fs._saved[k], canon[k])
                        for k in canon)
        ok = ok and row_ok and commit_ok
        worlds.append({"ranks": m, "rows_shape": list(fs.shard.shape),
                       "rows_ok": row_ok, "commit_ok": commit_ok,
                       "sync_s": sync_s})
        m //= 2
    out["remesh"] = worlds
    return ok


def worker(device, steps, out_dir, ckpt_dir, stage=1):
    sys.path.insert(0, REPO)
    import torch
    from torch.func import functional_call
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint_sharded as cs
    from horovod_tpu_torch.data import ShardedBatchIterator
    from horovod_tpu_torch.elastic import TensorState
    from horovod_tpu_torch.models.gpt2 import loss_fn
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    from horovod_tpu_torch.parallel import mp

    hvd.init(device=device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()
    build = _model_builder(device)
    out = {"rank": r, "ranks": n, "stage": stage}
    if stage == 3:
        import chip_smoke
        st, fsdp_step = chip_smoke._fsdp_trainer(dev, build=build)
        layers = st["layers"]
        vocab = st["rest"]["wte"].shape[0]
        length = layers * fsdp_step_numel(st) + sum(
            v.numel() for v in st["rest"].values())
        want = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers,
                "flash_bwd_dkv": layers}
    else:
        model = build(dev)
        cfg = model.cfg
        vocab, layers = cfg.vocab_size, cfg.num_layers
        params = dict(model.named_parameters())
        length = sum(p.numel() for p in params.values())
        want = {k: layers for k in fa.KERNELS}

        def f(p, t):
            return loss_fn(functional_call(model, p, (t,)), t)
        opt = hvd.sharded_adamw(1e-4, weight_decay=1e-4, eps=1e-8)
        state = opt.init(params)
        vg = hvd.value_and_grad(f)
    tokens = torch.randint(0, vocab, (B, T),
                           generator=torch.Generator().manual_seed(0))
    batches = ShardedBatchIterator([tokens.numpy()], B // n, shuffle=False)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, wall, grew = [], [], []
    for epoch in range(steps):
        batches.set_epoch(epoch)
        (rows, ), _ = next(iter(batches))
        tok = torch.from_numpy(rows).to(dev)
        before = dict(fa.launches)
        t0 = time.perf_counter()
        if stage == 3:
            value = hvd.allreduce(fsdp_step(tok).reshape(1),
                                  op=hvd.Average)[0]
        elif stage == 2:
            names = list(params)
            local = f(params, tok)
            grads = torch.autograd.grad(local, [params[k] for k in names])
            g_shard = mp.zero2_grad_shard(dict(zip(names, grads)))
            del grads
            new, state = mp.zero2_update(
                params, g_shard, state, learning_rate=1e-4,
                weight_decay=1e-4, eps=1e-8)
            with torch.no_grad():
                for k in names:
                    params[k].copy_(new[k])
            del new
            value = hvd.allreduce(local.detach().reshape(1),
                                  op=hvd.Average)[0]
        else:
            value, grads = vg(params, tok)
            upd, state = opt.update(grads, state, params)
            with torch.no_grad():
                for k, p in params.items():
                    p.add_(upd[k])
            del grads, upd
        if device == "cuda":
            torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(value.item())
        grew.append({k: fa.launches[k] - before[k] for k in fa.KERNELS})
    if stage == 3:
        mu = st["f"].mu
        held = (st["rows"].numel() * st["rows"].element_size()
                + sum(v.numel() * v.element_size()
                      for v in st["rest"].values()))
        moments = 2 * (mu.numel() * mu.element_size()
                       + st["z"].mu.numel() * st["z"].mu.element_size())
        out.update(rows_shape=list(st["rows"].shape),
                   block_elements=fsdp_step_numel(st),
                   mu_elements=int(mu.numel()))
    else:
        mu = state.mu
        held = sum(p.numel() * p.element_size() for p in params.values())
        moments = 2 * mu.numel() * mu.element_size()
        out["mu_elements"] = int(mu.numel())
    out.update({"losses": losses, "wall_ms": wall,
                "step_ms": statistics.median(wall[1:]),
                "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                             if device == "cuda" else 0.0),
                "params": length, "param_bytes": held,
                "moment_bytes": moments, "launches_per_step": grew,
                "launches_ok": device != "cuda" or all(
                    x == want for x in grew)})
    if stage == 1 and ckpt_dir:
        st1 = TensorState(params={k: p.detach() for k, p in params.items()},
                          opt_state=state)
        mgr = cs.ShardedCheckpointManager(ckpt_dir)
        cs.save_state(mgr, steps, st1, wait=True)
        mgr.close()
        whole = cs.reshard_opt_state(state, 1, unpadded_len=length)
        out["gathered"] = {k: _digest(getattr(whole, k))
                           for k in ("step", "mu", "nu")}
    if stage == 3 and n > 1:
        import socket
        from horovod_tpu_torch.elastic import FsdpState

        def free_port():
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                return sock.getsockname()[1]
        ports = hvd.broadcast_object(
            [free_port() for _ in range(4)] if r == 0 else None, 0)
        fs = FsdpState(st["template"], shard=st["rows"], opt_state=st["f"])
        del st, fsdp_step
        out["remesh_ok"] = _fsdp_state_remesh(device, fs, out, ports)
        if hvd.is_initialized():
            hvd.shutdown()
    else:
        hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)


def fsdp_step_numel(st) -> int:
    """Unpadded elements of one block of a stage-3 state."""
    from horovod_tpu_torch.parallel.fsdp import flat_size
    return flat_size(st["template"])


def mesh_worker(device, out_dir):
    """``--mesh dp2xmp2``: GPT-2 medium's MLP, Megatron-split over mp,
    under ``fsdp_apply`` over dp, against the whole block on one card."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.parallel import conjugate, fsdp

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=device)
    r, dev = hvd.rank(), hvd.device()
    dp, mp_ = hvd.dp_size(), hvd.mp_size()
    d, ff, b, t = (1024, 4096, 4, 256) if device == "cuda" else \
        (64, 256, 2, 16)
    g = torch.Generator().manual_seed(0)
    w = {"fc.weight": torch.randn(ff, d, generator=g) * d ** -0.5,
         "fc.bias": torch.randn(ff, generator=g) * 0.02,
         "proj.weight": torch.randn(d, ff, generator=g) * ff ** -0.5,
         "proj.bias": torch.randn(d, generator=g) * 0.02}
    x = torch.randn(dp, b, t, d, generator=g)
    w = {k: v.to(dev) for k, v in w.items()}
    x = x.to(dev)
    i, j = hvd.mp_rank(), hvd.dp_rank()
    lo, hi = i * ff // mp_, (i + 1) * ff // mp_
    fiber = {"fc.weight": w["fc.weight"][lo:hi].contiguous(),
             "fc.bias": w["fc.bias"][lo:hi].contiguous(),
             "proj.weight": w["proj.weight"][:, lo:hi].contiguous(),
             "proj.bias": w["proj.bias"].clone()}
    mesh = hvd.mesh2d()
    dp_set, mp_set = mesh.process_set("dp"), mesh.process_set("mp")
    g_tp = conjugate.psum_fwd_identity_bwd(mp_set)

    def block(p, h):
        part = F.gelu(h @ p["fc.weight"].t() + p["fc.bias"],
                      approximate="tanh") @ p["proj.weight"].t()
        return h + g_tp(part) + p["proj.bias"]

    shard = fsdp.fsdp_shard_params(fiber, process_set=dp_set)
    shard.requires_grad_()
    t0 = time.perf_counter()
    y = fsdp.fsdp_apply(block, fiber, shard, x[j], process_set=dp_set)
    loss = (y ** 2).mean()
    loss.backward()
    loss = C._in_step_allreduce(loss.detach().reshape(1), C.Average,
                                dp_set)[0].item()
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3

    # The whole block on the whole batch, on this card.
    full = {k: v.clone().requires_grad_() for k, v in w.items()}

    def whole(p, h):
        return h + F.gelu(h @ p["fc.weight"].t() + p["fc.bias"],
                          approximate="tanh") @ p["proj.weight"].t() \
            + p["proj.bias"]
    ref = sum((whole(full, x[k]) ** 2).mean() for k in range(dp)) / dp
    ref.backward()
    want_fiber = {"fc.weight": full["fc.weight"].grad[lo:hi],
                  "fc.bias": full["fc.bias"].grad[lo:hi],
                  "proj.weight": full["proj.weight"].grad[:, lo:hi],
                  "proj.bias": full["proj.bias"].grad}
    want = torch.cat([want_fiber[k].reshape(-1) for k in sorted(want_fiber)])
    c = shard.shape[0]
    want = torch.nn.functional.pad(want, (0, dp * c - want.numel()))[
        j * c:(j + 1) * c]
    err = float((shard.grad - want).abs().max())
    scale = float(want.abs().max())
    grads_ok = bool(torch.allclose(shard.grad, want, rtol=2e-4,
                                   atol=1e-4 * scale))
    out = {"rank": r, "dp": dp, "mp": mp_, "dp_rank": j, "mp_rank": i,
           "loss": loss, "ref_loss": ref.item(),
           "loss_ok": abs(loss - ref.item()) <= 1e-5 * abs(ref.item()),
           "grad_max_abs_err": err, "grad_max_abs": scale,
           "grads_ok": grads_ok, "row_elements": c, "ms": ms,
           "dims": dict(d=d, ff=ff, tokens_per_dp_rank=b * t)}
    hvd.shutdown()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh)


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
        ranks = []
        for i in range(nranks):
            with open(os.path.join(tmp, f"rank{i}.json")) as fh:
                ranks.append(json.load(fh))
    return ranks


def _restore_on_one(ckpt_dir, length):
    """The N-rank save restored for one rank: its row's digests."""
    sys.path.insert(0, REPO)
    from horovod_tpu_torch import checkpoint_sharded as cs
    res = cs.ShardedCheckpointManager(ckpt_dir).restore(num_shards=1)
    packed = {k.split("['opt_state']")[1].strip("[]'"): v
              for k, v in res.shards.items() if k.startswith("['opt_state']")}
    row = cs.unpack_opt_state(packed, rank=0)
    return {"step": _digest(row.step), "mu": _digest(row.mu),
            "nu": _digest(row.nu), "mu_elements": int(row.mu.numel()),
            "unpadded": length}


def run(nranks, device, steps, band, stage=1, timeout=900.0):
    one = _world(1, ["--worker", device, str(steps), "", str(stage)],
                 timeout)[0]
    ckpt = tempfile.mkdtemp(prefix="zero_bench_") if stage == 1 else ""
    try:
        per = _world(nranks, ["--worker", device, str(steps), ckpt,
                              str(stage)], timeout)
        restored = _restore_on_one(ckpt, per[0]["params"]) if ckpt else None
    finally:
        if ckpt:
            import shutil
            shutil.rmtree(ckpt, ignore_errors=True)
    ref = one["losses"]
    diff = max(abs(a - w) for x in per for a, w in zip(x["losses"], ref))
    checks = {
        "one_rank_falls": all(map(math.isfinite, ref)) and ref[-1] < ref[0],
        "within_band": diff <= band,
        "ranks_agree": all(x["losses"] == per[0]["losses"] for x in per),
        "launches": one["launches_ok"] and all(x["launches_ok"]
                                               for x in per),
    }
    if stage == 3:
        c = -(-per[0]["block_elements"] // nranks)
        layers = one["rows_shape"][0]
        checks["rows_layers_by_ceil_l_over_n"] = all(
            x["rows_shape"] == [layers, c] and x["mu_elements"] == layers * c
            for x in per)
        want = []
        m = nranks // 2
        while m >= 1:
            want.append(m)
            m //= 2
        checks["fsdp_state_remesh_bit_equal"] = all(
            x["remesh_ok"] for x in per) and [
            w["ranks"] for w in per[0]["remesh"]] == want
    else:
        c = -(-per[0]["params"] // nranks)
        checks["rows_ceil_l_over_n"] = all(x["mu_elements"] == c
                                           for x in per)
    if restored is not None:
        checks["restore_n_to_1_bit_equal"] = restored["mu_elements"] == \
            per[0]["params"] and all(
                restored[k] == per[0]["gathered"][k] for k in ("step", "mu",
                                                              "nu"))
    return {"ranks": nranks, "stage": stage, "device": device,
            "steps": steps, "band": band, "max_loss_diff": diff,
            "checks": checks, "ok": all(checks.values()), "one_rank": one,
            "per_rank": [{k: v for k, v in x.items() if k != "gathered"}
                         for x in per]}


def run_mesh(nranks, device, mesh, timeout=900.0):
    per = _world(nranks, ["--mesh-worker", device], timeout,
                 HOROVOD_MESH=mesh)
    checks = {"loss": all(x["loss_ok"] for x in per),
              "fiber_grads": all(x["grads_ok"] for x in per),
              "mesh": all((x["dp"], x["mp"]) == (2, 2) for x in per)}
    return {"ranks": nranks, "mesh": mesh, "device": device,
            "checks": checks, "ok": all(checks.values()), "per_rank": per}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--band", type=float, default=1e-3)
    ap.add_argument("--stage", type=int, default=1, choices=(1, 2, 3))
    ap.add_argument("--mesh", default=None,
                    help="dp x mp spec: run the FSDP x tp MLP check "
                         "(dp2xmp2 with --np 4)")
    ap.add_argument("--worker", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-worker", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        device, steps, ckpt, stage = args.worker
        worker(device, int(steps), args.out_dir, ckpt, int(stage))
        return 0
    if args.mesh_worker:
        mesh_worker(args.mesh_worker, args.out_dir)
        return 0
    sys.path.insert(0, REPO)
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()      # once, before the ranks load the kernels
    if args.mesh:
        out = run_mesh(args.np, args.device, args.mesh)
    else:
        out = run(args.np, args.device, args.steps, args.band, args.stage)
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
