#!/usr/bin/env python3
"""Holds ``chip_smoke.SHRINK_LOSS_TOL`` between a correct shrink and two
wrong restores planted after it.

``chip_smoke.py`` phase 8 (c) lets a two-rank GPT-2 run that shrinks to one
rank after ``kill@rank=1,step=3`` differ from the golden two-rank losses by
``SHRINK_LOSS_TOL`` (the same global batch, its gradient summed in another
order). This tool reads how far a correct shrink lands from the golden run
and how far two wrong ones do, each planted in the relaunched worker only:

* ``fresh_moments``: adoption restores the weights but leaves AdamW's
  moments fresh;
* ``half_batch``: the shrunk rank trains on its old half of the batch.

Two cards (GPT-2 medium, bf16, flash; kernels built first)::

    python3 tools/torch_elastic_band.py --out chiprun_out/band.json

On the CPU (a two-layer fp32 GPT-2 on gloo)::

    python3 tools/torch_elastic_band.py --model tiny --device cpu

It runs ``chip_smoke.two_rank_elastic`` (the golden run, the shrink and the
promoted spare, each held to its contract), then the shrink once for each
planted fault, and prints one JSON line a run with its loss gaps. It exits
1 when a planted fault passes ``check_elastic_job`` at ``SHRINK_LOSS_TOL``.
"""

import argparse
import copy
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_elastic_worker.py")
PLANTS = ("fresh_moments", "half_batch")


def planted_worker(plant, argv):
    """``tools/torch_elastic_worker.py`` with ``plant`` in its relaunched
    attempt (``HVD_TPU_ELASTIC_RESTART`` > 0)."""
    sys.argv = [WORKER] + argv
    spec = importlib.util.spec_from_file_location("torch_elastic_worker",
                                                  WORKER)
    w = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(w)
    if os.environ.get("HVD_TPU_ELASTIC_RESTART", "0") != "0":
        if plant == "fresh_moments":
            adopt = w.cs.adopt_state

            def adopt_fresh(mgr, state, step=None):
                fresh = copy.deepcopy(state.optimizer.state_dict())
                out = adopt(mgr, state, step)
                state._saved["optimizer"] = fresh
                state.restore()
                return out
            w.cs.adopt_state = adopt_fresh
        else:
            import chip_smoke
            build_path, build_tiny = chip_smoke.build_path, w.build_tiny
            chip_smoke.build_path = lambda name, dev, rows: build_path(
                name, dev, rows=slice(0, 4))
            w.build_tiny = lambda dev, rank, world: build_tiny(dev, rank, 2)
    w.main()


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--plant":
        return planted_worker(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_medium",
                    choices=("gpt2_medium", "tiny"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None, help="write the result here")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from horovod_tpu_torch.runner import run_elastic
    if args.device == "cuda":
        from horovod_tpu_torch.ops import _build
        _build.build()           # once, before the workers load the kernels
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    res = {"two_rank_elastic": C.two_rank_elastic(
        steps=args.steps, model=args.model, device=args.device)}
    want = res["two_rank_elastic"]["golden_losses"]
    print("two_rank_elastic", json.dumps(res["two_rank_elastic"]),
          flush=True)
    missed = []
    for plant in PLANTS:
        d = tempfile.mkdtemp(prefix="elastic_band_")
        cmd = [sys.executable, os.path.abspath(__file__), "--plant", plant,
               "--steps", str(args.steps), "--model", args.model,
               "--device", args.device, "--max-pending", "1"]
        restarts = run_elastic(
            cmd, np=2, spares=0, state_dir=d, timeout=900, max_restarts=1,
            extra_env={"HOROVOD_FAULT_PLAN": "kill@rank=1,step=3"})
        lines, exits = ([json.loads(x) for x in open(os.path.join(d, name))
                         if x.strip()]
                        for name in ("steps.jsonl", "exits.jsonl"))
        shutil.rmtree(d, ignore_errors=True)
        runs = [(x["attempt"], x["step"], x["loss"],
                 abs(x["loss"] - want[x["step"]]))
                for x in lines if "event" not in x]
        try:
            C.check_elastic_job(plant, restarts, lines, exits, want,
                                C.SHRINK_LOSS_TOL, args.steps, 1, 3, 1,
                                promoted=False)
            verdict = "passed: the band misses this fault"
            missed.append(plant)
        except AssertionError as e:
            verdict = f"failed: {str(e)[-200:]}"
        res[plant] = {"restarts": restarts, "runs": runs,
                      "max_gap": max(g for a, _, _, g in runs if a == 1),
                      "check": verdict}
        print(plant, json.dumps(res[plant]), flush=True)
    res["shrink_loss_tol"] = C.SHRINK_LOSS_TOL
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
