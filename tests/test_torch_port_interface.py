"""The top-level interface of horovod_tpu_torch against the reference's
(``horovod_tpu/__init__.py:103-136``, ``ops/__init__.py``,
``models/__init__.py``).

Upstream Horovod's ``__version__`` and build flags exist under the same
names. The reference answers False to every flag (no MPI, NCCL, Gloo,
CUDA or ROCm on a TPU); the port reports its own build, the PyTorch it
runs on, and the backend ``init`` chose, so its flags differ from the
reference's where that PyTorch has the library (``ROADMAP.md`` §C).
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

import horovod_tpu as jhvd
import horovod_tpu.models as jmodels
import horovod_tpu.ops as jops

import horovod_tpu_torch as hvd
import horovod_tpu_torch.models as models
import horovod_tpu_torch.ops as ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("nccl_built", "gloo_built", "mpi_built", "cuda_built",
         "rocm_built", "mpi_enabled", "gloo_enabled",
         "mpi_threads_supported")
BUILT = {"nccl_built": dist.is_nccl_available,
         "gloo_built": dist.is_gloo_available,
         "mpi_built": dist.is_mpi_available,
         "cuda_built": lambda: torch.version.cuda is not None,
         "rocm_built": lambda: getattr(torch.version, "hip", None)
         is not None}


@pytest.mark.parametrize("name", ("__version__",) + FLAGS)
def test_upstream_name_exported(name):
    assert hasattr(jhvd, name)
    assert name in hvd.__all__
    assert hasattr(hvd, name)


def test_version_is_the_reference_packages():
    assert hvd.__version__ == jhvd.__version__


@pytest.mark.parametrize("name", sorted(BUILT))
def test_built_flags_report_this_pytorch(name):
    got = getattr(hvd, name)()
    assert got is bool(BUILT[name]())
    # The divergence: the reference's constant False, the port's build.
    assert getattr(jhvd, name)() is False
    assert (got != getattr(jhvd, name)()) == bool(BUILT[name]())


def test_build_info_agrees_with_the_flags():
    info = hvd.build_info()
    assert info["nccl_built"] is hvd.nccl_built()
    assert info["gloo_built"] is hvd.gloo_built()
    assert info["cuda"] == torch.version.cuda


def test_enabled_flags_follow_the_backend_init_chose():
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        import horovod_tpu_torch as hvd
        names = {list(FLAGS[5:])!r}
        before = {{n: getattr(hvd, n)() for n in names}}
        hvd.init(device="cpu")
        after = {{n: getattr(hvd, n)() for n in names}}
        after["backend"] = hvd.backend()
        hvd.shutdown()
        print(json.dumps({{"before": before, "after": after}}))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["before"] == {"mpi_enabled": False, "gloo_enabled": False,
                             "mpi_threads_supported": False}
    assert out["after"] == {"mpi_enabled": False, "gloo_enabled": True,
                            "mpi_threads_supported": False,
                            "backend": "gloo"}
    assert jhvd.gloo_enabled() is False


@pytest.mark.parametrize("name", ["flash_attention", "MoEMLP",
                                  "Top1Router", "ring_attention",
                                  "ring_flash_attention",
                                  "ulysses_attention"])
def test_ops_reexports_as_the_reference(name):
    from horovod_tpu_torch.ops import moe, sequence
    fa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")
    assert hasattr(fa, "flash_fwd")
    assert hasattr(jops, name)
    got = getattr(ops, name)
    assert got.__name__ == getattr(jops, name).__name__
    homes = {"flash_attention": fa.flash_attention, "MoEMLP": moe.MoEMLP,
             "Top1Router": moe.Top1Router,
             "ulysses_attention": sequence.ulysses_attention}
    if name in homes:
        assert got is homes[name]


@pytest.mark.parametrize("name", ["MnistCNN", "ResNet50", "ResNet18"])
def test_models_reexports_as_the_reference(name):
    from horovod_tpu_torch.models import mnist, resnet
    assert name in jmodels.__all__ and name in models.__all__
    home = mnist if name == "MnistCNN" else resnet
    assert getattr(models, name) is getattr(home, name)


@pytest.mark.parametrize("name", ["blackbox", "dump_postmortem",
                                  "postmortem_report"])
def test_flight_recorder_names_as_the_reference(name):
    """``hvd.blackbox``, ``hvd.dump_postmortem`` and
    ``hvd.postmortem_report`` exist as in the reference
    (``horovod_tpu/__init__.py:66-73``), the functions from the port's own
    ``blackbox`` module."""
    from horovod_tpu_torch import blackbox
    assert hasattr(jhvd, name)
    assert name in hvd.__all__
    got = getattr(hvd, name)
    if name == "blackbox":
        assert got is blackbox
        assert got.__all__ == jhvd.blackbox.__all__
    else:
        assert got is getattr(blackbox, name)
        assert got.__name__ == getattr(jhvd, name).__name__
