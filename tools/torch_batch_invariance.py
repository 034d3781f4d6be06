#!/usr/bin/env python3
"""Why ``models/generate.py`` runs a decode step's row-wise work on at least
``MIN_ROWS`` rows on the GPU: how far decode leaves the training forward
with and without it.

    python3 tools/torch_batch_invariance.py [--new 96]

On one CUDA card (TF32 off, as ``chip_smoke.py`` runs):

* for LayerNorm over d 1024 and for bf16 ``F.linear`` at the shapes of
  GPT-2 medium (with a bias) and Llama-340M (without), the share of
  outputs computed on M rows that differ from the same rows computed among
  4096 (the forward's B x T), for M from 8 to 256;
* for GPT-2 medium, Llama-340M and T5-small with bf16 weights (random,
  seed 0, ``chip_smoke.py`` phase 9 (g)'s shapes with ``--new`` tokens),
  the largest difference of the decode logits from the dense forward's
  over the same tokens, with the rows padded to ``MIN_ROWS`` (the shipped
  step) and with no padding (``MIN_ROWS`` = 1).

Prints the card's name and power limit first and one JSON object last.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROWS = (8, 16, 32, 64, 128, 256)
# (K, N, bias) of the products a decode step runs: GPT-2 medium's qkv,
# out, fc and proj (with a bias, as its Dense layers have); Llama-340M's
# wq / wo, wk / wv, gate / up and down (without). A bias changes cuBLAS's
# kernel (the bias epilogue), so each is measured as the model runs it.
LINEARS = ((1024, 3072, True), (1024, 1024, True), (1024, 4096, True),
           (4096, 1024, True), (1024, 1024, False), (1024, 256, False),
           (1024, 2816, False), (2816, 1024, False))


def row_invariance(dev):
    """{op: {M: share of its M rows' outputs that differ from the same
    rows computed among 4096}}."""
    import torch
    import torch.nn.functional as F
    from horovod_tpu_torch.models.gpt2 import LayerNorm
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    out = {}
    ln = LayerNorm(1024, 1e-6).to(dev)
    x = torch.randn(4096, 1024, generator=g, device=dev)
    with torch.no_grad():
        full = ln(x)
        out["layernorm 1024"] = {m: (ln(x[:m]) != full[:m]).float().mean()
                                 .item() for m in ROWS}
        for k, n, has_bias in LINEARS:
            w = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5)
            w = w.to(bf)
            b = torch.randn(n, generator=g, device=dev).to(bf) \
                if has_bias else None
            x = torch.randn(4096, k, generator=g, device=dev).to(bf)
            full = F.linear(x, w, b)
            out[f"linear {k}->{n}{' bias' if has_bias else ''}"] = {
                m: (F.linear(x[:m], w, b) != full[:m]).float().mean().item()
                for m in ROWS}
    return out


def decode_errors(dev, new):
    """{model: {"padded": err, "unpadded": err}}: the largest |decode
    logit - forward logit| over every position."""
    import chip_smoke
    from horovod_tpu_torch.models import generate as G
    chip_smoke.DECODE_ATOL = float("inf")      # measure, do not gate
    out = {}
    for rows, tag in ((G.MIN_ROWS, "padded"), (1, "unpadded")):
        G.MIN_ROWS = rows
        for name, res in chip_smoke.phase_decode("card", dev,
                                                 gpt2_new=new).items():
            out.setdefault(name, {})[tag] = res["max_abs_err"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--new", type=int, default=96,
                    help="tokens GPT-2 medium's decode generates "
                         "(default 96)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_batch_invariance: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    rows = row_invariance(dev)
    for op, shares in rows.items():
        print(f"{op}: share differing from 4096 rows at M = " + ", ".join(
            f"{m}: {s:.5f}" for m, s in shares.items()), flush=True)
    dec = decode_errors(dev, args.new)
    for name, errs in dec.items():
        print(f"{name} decode against the dense forward: max |logit "
              f"difference| {errs['padded']:.3e} on padded rows, "
              f"{errs['unpadded']:.3e} without", flush=True)
    print(json.dumps({"rows": rows, "decode": dec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
