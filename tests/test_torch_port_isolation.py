"""horovod_tpu_torch stands alone: it imports nothing of JAX or of the JAX
package, builds nothing at import, runs on the GPU unless asked for the CPU,
and its CUDA wrappers refuse what their kernels do not take."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "horovod_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_no_jax_and_builds_nothing(tmp_path):
    build = tmp_path / "kernels"
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path.insert(0, {str(REPO)!r})
        import horovod_tpu_torch
        for m in pkgutil.walk_packages(horovod_tpu_torch.__path__,
                                       "horovod_tpu_torch."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        import chip_smoke
        from horovod_tpu_torch.ops import _build
        assert not _build._LIBS, "a kernel library was loaded at import"
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in {FORBIDDEN!r})
        print("FORBIDDEN:", bad)
    """)
    env = dict(os.environ, HOROVOD_TORCH_BUILD_DIR=str(build))
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FORBIDDEN: []" in r.stdout, r.stdout
    assert not build.exists(), "import must not run nvcc"


def test_init_defaults_to_cuda_and_raises_without_it(monkeypatch):
    import horovod_tpu_torch as hvd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init(device="cuda")
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="expected 'cuda' or 'cpu'"):
        hvd.init(device="meta")


def test_cpu_world_of_one(monkeypatch):
    import horovod_tpu_torch as hvd
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
        assert hvd.backend() == "gloo"
        assert hvd.device() == torch.device("cpu")
        hvd.init(device="cpu")                       # re-entrant
        info = hvd.build_info()
        assert set(info) >= {"nccl_built", "cuda", "kernels_built"}
        x = torch.arange(4.0)
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
        assert torch.equal(hvd.broadcast(x, 0), x)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        hvd.rank()


def test_kernel_wrappers_refuse_what_kernels_do_not_take():
    from horovod_tpu_torch.ops.flash_attention import _check_kernel_inputs
    q = torch.zeros(2, 8, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _check_kernel_inputs(q.half(), q.half(), q.half(), None, None)
    with pytest.raises(TypeError):
        _check_kernel_inputs(q, q.bfloat16(), q, None, None)
    odd = torch.zeros(2, 8, 12)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        _check_kernel_inputs(odd, odd, odd, None, None)
    big = torch.zeros(2, 8, 136)
    with pytest.raises(ValueError, match="multiples of 8 up to 128"):
        _check_kernel_inputs(big, big, big, None, None)
    t = torch.zeros(2, 64, 8).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        _check_kernel_inputs(t, t, t, None, None)
    with pytest.raises(TypeError, match="int32"):
        _check_kernel_inputs(q, q, q, None, torch.zeros(1, 8,
                                                        dtype=torch.int64))
    with pytest.raises(TypeError, match="lse and delta"):
        _check_kernel_inputs(q, q, q, None, None, q, q.double(), q)


def test_build_without_nvcc_says_so(monkeypatch, tmp_path):
    from horovod_tpu_torch.ops import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("HOROVOD_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_runner_reports_a_failing_rank(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        assert os.environ["WORLD_SIZE"] == "3"
        assert os.environ["MASTER_ADDR"] == "127.0.0.1"
        sys.exit(7 if os.environ["RANK"] == "2" else 0)
    """))
    r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.runner",
                        "-np", "3", str(script)], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 7, r.stderr


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    if alone:
        src = tmp_path / "chip_smoke.py"
        src.write_text((REPO / "chip_smoke.py").read_text())
        cwd = tmp_path
    else:
        src, cwd = REPO / "chip_smoke.py", REPO
    r = subprocess.run([sys.executable, str(src)], cwd=cwd,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_get_model_builds_ported_names_and_points_to_roadmap():
    from horovod_tpu_torch.models import PORTED, get_model
    from horovod_tpu_torch.models.bert import Bert
    from horovod_tpu_torch.models.gpt2 import GPT2
    from horovod_tpu_torch.models.llama import Llama
    from horovod_tpu_torch.models.mnist import MnistCNN
    from horovod_tpu_torch.models.resnet import ResNet
    from horovod_tpu_torch.models.vit import ViT
    assert PORTED == ("mnist", "resnet18", "resnet50", "gpt2_medium",
                      "bert", "bert_large", "vit", "vit_b16", "llama",
                      "llama7b", "llama_small")
    with torch.device("meta"):          # shapes only, no CPU init
        assert isinstance(get_model("mnist"), MnistCNN)
        r18 = get_model("resnet18", num_classes=10)
        assert len(get_model("ResNet50").blocks) == 16
        g = get_model("gpt2-medium", attention="flash")
        bert = get_model("bert_large", attention="flash")
        vit = get_model("vit-b/16", attention="flash")
        llama = get_model("llama", num_layers=24, num_heads=16,
                          num_kv_heads=4, d_model=1024, d_ff=2816,
                          vocab_size=32000, max_seq_len=2048)
    assert isinstance(r18, ResNet) and len(r18.blocks) == 8
    assert isinstance(g, GPT2) and g.cfg.num_layers == 24
    assert g.cfg.attention == "flash"
    assert isinstance(bert, Bert) and bert.cfg.num_layers == 24
    assert bert.cfg.d_model == 1024 and bert.cfg.attention == "flash"
    assert isinstance(vit, ViT) and vit.cfg.num_layers == 12
    assert vit.cfg.attention == "flash"
    assert isinstance(llama, Llama) and llama.cfg.num_kv_heads == 4
    assert llama.cfg.rms_eps == 1e-6 and llama.cfg.max_seq_len == 2048
    for name in ("t5_small", "gpt2", "alexnet"):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            get_model(name)
