#!/usr/bin/env python3
"""Why the bf16 forward kernel of horovod_tpu_torch has the shape it has:
builds variants of ``ops/csrc/flash_fwd.cu`` that each undo one design
choice, checks each against the plain version and times each, in one run on
one GPU.

    python3 tools/torch_fwd_variants.py [--parent DIR]

Variants (each a text patch of the shipped source; compile-time constants
only, so the C interface stays the same):

* ``shipped``: as in the tree;
* ``one block per SM``: ``MIN_BLOCKS`` 1 at d <= 64, so setmaxnreg gives
  the consumers 240 registers instead of two blocks of 104;
* ``every tile masked``: no tile takes the softmax without mask code;
* ``64-key tiles``: ``BK`` 64 at d <= 64 as at d 128;
* ``parent``: with ``--parent DIR``, the forward kernel of the checkout at
  DIR (its own ``csrc/``), the yardstick of the previous design.

All are built by nvcc in parallel under ``build/fwd_variants/``. Each is
held against ``flash_fwd_plain`` at ``chip_smoke.BF16_TOL`` (O) and
``F32_TOL`` (lse) at GPT-2 medium's attention shapes (B 8, T 1024, H 16,
d 64, causal) and at d 128 (B 8, T 1024, H 8), then timed as chip_smoke
times the kernels, per call over 10 back-to-back calls behind a device
sleep, median of 20, in ``ROUNDS`` rounds that take the variants in turn;
the median of the rounds is printed with ptxas's registers and spills, and
``scaled_dot_product_attention`` forward in the same rounds. Launches go
through the libraries directly and count nowhere. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# name -> [(regex, replacement)] applied to flash_fwd.cu; every patch must
# match once.
VARIANTS = {
    "shipped": [],
    "one block per SM": [
        (r"MIN_BLOCKS = HD <= 64 \? 2 : 1", "MIN_BLOCKS = 1")],
    "every tile masked": [(r"if \(kt < n_plain\)", "if (false)")],
    "64-key tiles": [(r"BK = HD <= 64 \? 32 : 64", "BK = 64")],
}
# The setmaxnreg budget assertion pins the shipped shape; variants drop it.
_BUDGET = (r"static_assert\(CONSUMER_REGS == [^;]*;", "")
ROUNDS = 3


def patched(name: str, text: str) -> str:
    """flash_fwd.cu with variant ``name``'s patches applied."""
    for pat, rep in VARIANTS[name] + ([_BUDGET] if VARIANTS[name] else []):
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"patch {pat!r} of {name} matched {n}x")
    return text


def _ptxas_wg(log: str):
    """ptxas's lines about the bf16 (wgmma) forward kernels."""
    keep, wg = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            wg = "flash_fwd_wg_kernel" in line
        if wg and any(k in line for k in ("Compiling entry", "registers",
                                          "spill", "wgmma")):
            keep.append(line.strip())
    return keep


def build_variants(parent, out: Path):
    """Builds every variant; returns {name: (library path, ptxas lines)}."""
    from horovod_tpu_torch.ops import _build
    csrc = ROOT / "horovod_tpu_torch" / "ops" / "csrc"
    srcs = {n: csrc for n in VARIANTS}
    if parent:
        srcs["parent"] = Path(parent) / "horovod_tpu_torch" / "ops" / "csrc"
    procs = {}
    for name, src in srcs.items():
        d = out / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        if name != "parent":
            f = d / "flash_fwd.cu"
            f.write_text(patched(name, f.read_text()))
        lib = d / "libflash_fwd.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
               str(lib), str(d / "flash_fwd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    built = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        built[name] = (lib, _ptxas_wg(log))
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of the previous design")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_fwd_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    built = build_variants(args.parent, ROOT / "build" / "fwd_variants")
    libs = {n: _build.bind(ctypes.CDLL(str(p)), "flash_fwd")
            for n, (p, _) in built.items()}
    shapes = {"d64": (8, 1024, 16, 64), "d128": (8, 1024, 8, 128)}
    times = {s: {n: [] for n in list(libs) + ["sdpa"]} for s in shapes}
    worst = {n: 0.0 for n in libs}
    cases = {}
    for s, (b, t, h, d) in shapes.items():
        q, k, v, _, _, _ = chip_smoke._inputs(b * h, b, t, t, d,
                                              torch.bfloat16, seed=t + d)
        scale = d ** -0.5
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, None, None, h, scale, True)
        cases[s] = (q, k, v, h, scale)
        for n, lib in libs.items():
            o = torch.empty_like(q)
            lse = torch.empty(q.shape[:2], device="cuda")
            fa.launch_fwd(lib, q, k, v, None, None, o, lse, h, scale, True, 0,
                          torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            _, w, _, ok = chip_smoke._stats(o, o_p, chip_smoke.BF16_TOL)
            _, _, _, ok_l = chip_smoke._stats(lse, lse_p, chip_smoke.F32_TOL)
            if not (ok and ok_l):
                print(f"{n} at {s} disagrees with the plain version "
                      f"(max err/bound {w:.3f})", file=sys.stderr)
                return 1
            worst[n] = max(worst[n], w)
        del o_p, lse_p
    for _ in range(ROUNDS):
        for s, (q, k, v, h, scale) in cases.items():
            o = torch.empty_like(q)
            lse = torch.empty(q.shape[:2], device="cuda")
            st = torch.cuda.current_stream().cuda_stream
            for n, lib in libs.items():
                times[s][n].append(chip_smoke.cuda_ms(
                    lambda: fa.launch_fwd(lib, q, k, v, None, None, o, lse,
                                          h, scale, True, 0, st),
                    20, inner=10))
            b, t, d = q.shape[0] // h, q.shape[1], q.shape[2]
            sq, sk, sv = (x.view(b, h, t, d) for x in (q, k, v))
            times[s]["sdpa"].append(chip_smoke.cuda_ms(
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       is_causal=True),
                20, inner=10))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; ms per call back to back (median of {ROUNDS} "
          f"rounds, each the median of 20 runs of 10 calls)")
    result = {}
    for n in list(libs) + ["sdpa"]:
        row = {s: statistics.median(times[s][n]) for s in shapes}
        row["rounds"] = {s: times[s][n] for s in shapes}
        if n in built:
            row["ptxas"] = built[n][1]
            row["worst_share"] = worst[n]
        result[n] = row
        print(f"{n}: d 64 {row['d64']:.4f}, d 128 {row['d128']:.4f}"
              + (f", worst share of the bound {worst[n]:.3f}"
                 if n in worst else ""))
        for line in row.get("ptxas", []):
            print(f"    {line}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
