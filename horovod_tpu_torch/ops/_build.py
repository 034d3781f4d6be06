"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, and loaded with ``ctypes``. The build happens at first
use, never at import, into ``build/kernels/`` at the repository root (listed
in ``.gitignore``; ``HOROVOD_TORCH_BUILD_DIR`` overrides it). A library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is reused. :func:`build` compiles every
missing library at once, one ``nvcc`` process per library, all started
together. The libraries of :data:`PLANTED` are the same sources with a fault
planted by a define; they are built only when named, and only
``chip_smoke.py`` loads them, to show that its check catches the fault.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "PLANTED", "build", "load", "built", "build_dir",
           "nvcc_path", "ptxas_report"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("flash_common.cuh", "flash_mma.cuh")

# library name -> its one source file
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
}

# library name -> (its source file, the defines that plant its fault)
PLANTED = {
    # P and dS rounded to bf16 once before the tensor-core products
    # (flash_mma.cuh), instead of the hi + lo split.
    "flash_fwd_one_rounding": ("flash_fwd.cu", ("-DHVD_FLASH_ONE_ROUNDING",)),
    "flash_bwd_one_rounding": ("flash_bwd.cu", ("-DHVD_FLASH_ONE_ROUNDING",)),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("HOROVOD_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def _spec(name: str):
    """(source file, extra nvcc flags) of library ``name``."""
    return PLANTED[name] if name in PLANTED else (SOURCES[name], ())


def _digest(name: str) -> str:
    src, defines = _spec(name)
    h = hashlib.sha256()
    for f in (src,) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(defines)).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def built(names: Optional[Iterable[str]] = None) -> bool:
    """True when every named library (default: all) exists for the current
    sources."""
    return all(_lib_path(n).exists() for n in (names or SOURCES))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per library, concurrently. Returns seconds per library built
    (0.0 for one already present). Raises with nvcc's output on failure."""
    names = list(names or SOURCES)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs = {n: 0.0 for n in names}
    for n in names:
        dst = _lib_path(n)
        if dst.exists():
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        src, defines = _spec(n)
        cmd = [nvcc_path(), *NVCC_FLAGS, *defines, f"-I{_CSRC}", "-o",
               str(tmp), str(_CSRC / src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, dst, time.perf_counter())
    errors = []
    for n, (p, tmp, dst, t0) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        (out_dir / f"lib{n}.log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n} ({_spec(n)[0]}) "
                          f"(rc {p.returncode}):\n{log[-6000:]}")
            continue
        os.replace(tmp, dst)   # atomic: a concurrent loader never sees half
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def ptxas_report(name: str) -> str:
    """The register / shared-memory / spill lines, and any warning about
    serialized wgmma's, that ptxas printed for the last build of library
    ``name`` ('' when it was not built by this process's build directory)."""
    log = build_dir() / f"lib{name}.log"
    if not log.exists():
        return ""
    keep = ("Compiling entry", "registers", "spill", "wgmma")
    return "\n".join(l.strip() for l in log.read_text().splitlines()
                     if any(k in l for k in keep))


_C_INT, _C_FLOAT, _C_PTR = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

# argtypes of every C entry point, by source file
_SIGNATURES = {
    "flash_fwd.cu": {
        "hvd_flash_fwd": [_C_PTR] * 8 + [_C_INT] * 5 + [_C_FLOAT]
        + [_C_INT] * 3 + [_C_PTR],
        "hvd_flash_fwd_smem": [_C_INT],
    },
    "flash_bwd.cu": {
        "hvd_flash_bwd_dq": [_C_PTR] * 10 + [_C_INT] * 5 + [_C_FLOAT]
        + [_C_INT] * 3 + [_C_PTR],
        "hvd_flash_bwd_dkv": [_C_PTR] * 12 + [_C_INT] * 5 + [_C_FLOAT]
        + [_C_INT] * 3 + [_C_PTR],
        "hvd_flash_bwd_dq_smem": [_C_INT],
        "hvd_flash_bwd_dkv_smem": [_C_INT],
    },
}


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set argtypes/restype of library ``name``'s entry points on ``lib``."""
    for fn, argtypes in _SIGNATURES[_spec(name)[0]].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _C_INT
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if it is missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = bind(ctypes.CDLL(str(_lib_path(name))), name)
            _LIBS[name] = lib
        return lib
