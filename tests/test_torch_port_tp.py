"""horovod_tpu_torch's tensor-parallel validation, rules and weight splits
(``parallel/mp.py``) == horovod_tpu's (``horovod_tpu/parallel/mp.py``).

* ``validate_tp`` accepts and refuses what the reference does, with its
  exception types and messages;
* ``mp_partition_rules`` under ``"off"``, ``"auto"`` and ``"megatron"`` maps
  path by path onto the reference's: every flax path, carried to the port's
  name as ``models/convert.py`` carries it, gets the reference's spec, with
  the two entries swapped for a 2-D ``kernel`` (the port keeps
  ``nn.Linear``'s (out, in) weight), for dense and MoE GPT-2 and Llama;
  ``HOROVOD_MP_RULES`` parses as the reference's knob;
* ``split_params`` equals the reference's bit for bit after the same
  carry (kernels transposed) for tiny fp32 GPT-2 and Llama at mp 2 and 4
  (Llama with 4 heads over 2 kv heads at mp 2, and 8 over 4 at mp 2 and
  4: mp must divide the kv heads); ``merge_params`` inverts it bit for
  bit, a split at 4 merged and split at 2 equals the split at 2, mp 1 is
  the identity, and a rank's part holds at most 0.55 of the bytes at mp
  2 (``tests/test_mp.py:84-110``), the same bytes as the reference's part;
* on a spawned two-rank gloo world (``HOROVOD_MESH=dp1xmp2``):
  ``mp_stack`` gives each rank its own row on its device,
  ``mp_broadcast`` / ``mp_fetch`` carry a value there and back,
  ``wrap_spmd`` puts the mesh's mp set in scope (and takes it out after),
  ``tensor_parallel`` over a one-rank set returns the model unchanged and
  refuses a model that is tensor-parallel already, MoE and sequence
  parallelism, under ``HOROVOD_MP_RULES=off`` it splits nothing and
  ``vocab_parallel_loss`` is ``loss_fn``, and an eager allreduce over each rank's one-rank dp line
  negotiates as one op.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JGPT2Config
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.models.t5 import T5Config as JT5Config
from horovod_tpu.parallel import mp as jmp

from horovod_tpu_torch.models import convert
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
from horovod_tpu_torch.models.llama import Llama, LlamaConfig
from horovod_tpu_torch.models.t5 import T5Config
from horovod_tpu_torch.parallel import mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (family, config keywords); the tiny configs of both packages.
MODELS = {
    "gpt2": ("gpt2", {}),
    "llama_kv2": ("llama", {}),
    "llama_h8_kv4": ("llama", dict(num_heads=8, num_kv_heads=4)),
}
SPLITS = [("gpt2", 2), ("gpt2", 4), ("llama_kv2", 2), ("llama_h8_kv4", 2),
          ("llama_h8_kv4", 4)]


def _configs(name, **extra):
    fam, kw = MODELS[name]
    kw = dict(kw, **extra)
    if fam == "gpt2":
        kw = dict(dict(vocab_size=256, max_seq_len=128, num_layers=2,
                       num_heads=4, d_model=64), **kw)
        return (JGPT2Config(dtype=jnp.float32, **kw),
                GPT2Config(dtype=torch.float32, **kw))
    return (JLlamaConfig.tiny(dtype=jnp.float32, **kw),
            LlamaConfig.tiny(dtype=torch.float32, **kw))


_PARAMS = {}


def _params(name, **extra):
    """(reference config, its flax params as numpy, port config, the same
    params as the port's state dict)."""
    key = (name, tuple(sorted(extra.items())))
    if key not in _PARAMS:
        jcfg, cfg = _configs(name, **extra)
        model = (JGPT2 if MODELS[name][0] == "gpt2" else JLlama)(jcfg)
        params = model.init(jax.random.PRNGKey(0),
                            jnp.ones((1, 4), jnp.int32))["params"]
        params = jax.tree_util.tree_map(np.asarray, params)
        _PARAMS[key] = (jcfg, params, cfg,
                        convert.gpt2_params_from_jax(params))
    return _PARAMS[key]


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


VALIDATE = [
    ("gpt2", {}, 1), ("gpt2", {}, 2), ("gpt2", {}, 4), ("gpt2", {}, 3),
    ("gpt2", {}, 8), ("gpt2", {}, 0), ("gpt2", dict(vocab_size=250), 2),
    ("llama_kv2", {}, 2), ("llama_kv2", {}, 4),
    ("llama_h8_kv4", dict(d_ff=130), 4), ("llama_h8_kv4", {}, 4),
]


@pytest.mark.parametrize("name,extra,n", VALIDATE)
def test_validate_tp_as_reference(name, extra, n):
    jcfg, cfg = _configs(name, **extra)
    want = _error(lambda: jmp.validate_tp(jcfg, n))
    assert _error(lambda: mp.validate_tp(cfg, n)) == want


def test_validate_tp_refuses_other_families_as_reference():
    assert _error(lambda: mp.validate_tp(T5Config.tiny(), 2)) == _error(
        lambda: jmp.validate_tp(JT5Config.tiny(), 2))

    class C:
        pass
    want = _error(lambda: jmp.validate_tp(C(), 2))
    assert want[0] == "TypeError"
    assert _error(lambda: mp.validate_tp(C(), 2)) == want


def _swap(spec, path, ndim):
    """The reference's spec of a flax leaf, as the port's weight wants it:
    a 2-D kernel is stored transposed."""
    spec = tuple(spec)
    if path.endswith("/kernel") and ndim == 2 and spec:
        spec = tuple(spec) + (None,) * (2 - len(spec))
        return spec[::-1]
    return spec


@pytest.mark.parametrize("rules", ["off", "auto", "megatron"])
@pytest.mark.parametrize("name,extra", [
    ("gpt2", {}), ("gpt2", dict(num_experts=2)), ("llama_kv2", {}),
    ("llama_kv2", dict(num_experts=2))])
def test_partition_rules_path_by_path(rules, name, extra):
    jcfg, params, cfg, state = _params(name, **extra)
    jrules = jmp.mp_partition_rules(jcfg, rules)
    prules = mp.mp_partition_rules(cfg, rules)
    model = (GPT2 if MODELS[name][0] == "gpt2" else Llama)(cfg)
    flat = convert.flatten_tree(params)
    assert {convert._port_name(k) for k in flat} == set(model.state_dict())
    seen = set()
    for path, leaf in flat.items():
        want = _swap(jrules.spec_for(path), path, np.ndim(leaf))
        got = tuple(prules.spec_for(convert._port_name(path)))
        assert got == want, (path, got, want)
        seen.update(e for e in got if e is not None)
    assert seen == (set() if rules == "off" else
                    {"mp"} | ({"ep"} if extra else set()))


@pytest.mark.parametrize("value", ["auto", "MEGATRON", " off ", "", "zero"])
def test_mp_rules_knob_as_reference(monkeypatch, value):
    from horovod_tpu import config as jconfig
    from horovod_tpu_torch import config as pconfig
    monkeypatch.setenv("HOROVOD_MP_RULES", value)
    want = _error(jconfig._env_mp_rules) or jconfig._env_mp_rules()
    got = _error(pconfig._env_mp_rules) or pconfig._env_mp_rules()
    assert got == want
    if not isinstance(got, tuple):
        assert pconfig.refresh().mp_rules == want
    monkeypatch.delenv("HOROVOD_MP_RULES")
    pconfig.refresh()


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name,n", SPLITS)
def test_split_params_equals_reference_bit_for_bit(name, n):
    jcfg, params, cfg, state = _params(name)
    for r in range(n):
        want = convert.gpt2_params_from_jax(jmp.split_params(jcfg, params,
                                                             n, r))
        _equal(mp.split_params(cfg, state, n, r), want)


@pytest.mark.parametrize("name,n", SPLITS)
def test_merge_params_inverts_split(name, n):
    _, _, cfg, state = _params(name)
    parts = [mp.split_params(cfg, state, n, r) for r in range(n)]
    _equal(mp.merge_params(cfg, parts), state)


@pytest.mark.parametrize("name", ["gpt2", "llama_h8_kv4"])
def test_split_at_four_merged_and_split_at_two(name):
    _, _, cfg, state = _params(name)
    merged = mp.merge_params(cfg, [mp.split_params(cfg, state, 4, r)
                                   for r in range(4)])
    for r in range(2):
        _equal(mp.split_params(cfg, merged, 2, r),
               mp.split_params(cfg, state, 2, r))


@pytest.mark.parametrize("name", ["gpt2", "llama_kv2"])
def test_mp1_is_the_identity(name):
    _, _, cfg, state = _params(name)
    _equal(mp.split_params(cfg, state, 1, 0), state)
    _equal(mp.merge_params(cfg, [state]), state)


@pytest.mark.parametrize("name", ["gpt2", "llama_kv2"])
def test_param_bytes_ratio_and_reference_bytes(name):
    jcfg, params, cfg, state = _params(name)
    for r in range(2):
        part = mp.split_params(cfg, state, 2, r)
        assert mp.param_bytes(part) / mp.param_bytes(state) <= 0.55
        assert mp.param_bytes(part) == jmp.param_bytes(
            jmp.split_params(jcfg, params, 2, r))
    assert mp.param_bytes(state) == jmp.param_bytes(params)


def test_split_errors():
    _, _, cfg, state = _params("gpt2")
    assert _error(lambda: mp.split_params(cfg, state, 2, 2)) == (
        "ValueError", "rank 2 outside the mp=2 axis")
    moe = GPT2Config.tiny(dtype=torch.float32, num_experts=2)
    err = _error(lambda: mp.split_params(moe, GPT2(moe).state_dict(), 2, 0))
    assert err[0] == "NotImplementedError" and \
        "refuse an MoE config" in err[1]


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from horovod_tpu_torch.parallel import mp

    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = hvd.mesh2d()
    info = {}
    row = mp.mp_stack(lambda i: {"w": np.full(3, i, np.float32),
                                 "k": [i, i + 1]}, mesh)
    info["stack"] = [row["w"].tolist(), [int(x) for x in row["k"]],
                     str(row["w"].device)]
    b = mp.mp_broadcast(np.arange(4), mesh)
    info["broadcast"] = mp.mp_fetch(b).tolist()
    info["fetch_type"] = type(mp.mp_fetch(b)).__name__
    seen = []
    out = mp.wrap_spmd(lambda x, y=0: seen.append(mp._mp_set()) or x + y,
                       mesh)(2, y=3)
    info["scope"] = [out, seen[0] is mesh.process_set("mp"),
                     len(mp._SCOPE)]
    tp = mp.TensorParallel()
    info["tp"] = [tp.size, tp.rank, tp.process_set.ranks]
    cfg = GPT2Config.tiny(dtype=torch.float32)
    m = GPT2(cfg)
    one = mp.tensor_parallel(m, process_set=mesh.process_set("dp"))
    info["one_rank_unchanged"] = one is m and m.tp is None
    mp.tensor_parallel(m)
    info["split_shape"] = list(m.h[0].attn.qkv.weight.shape)
    # HOROVOD_MP_RULES=off: nothing is split and the loss is loss_fn's.
    import os
    from horovod_tpu_torch import config
    from horovod_tpu_torch.models.gpt2 import loss_fn
    os.environ["HOROVOD_MP_RULES"] = "off"
    config.refresh()
    whole = GPT2(cfg)
    before = {k: v.clone() for k, v in whole.state_dict().items()}
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(0))
    off = mp.tensor_parallel(whole)
    lg = off(tok)
    info["off"] = [off is whole and whole.tp is None,
                   all(torch.equal(v, before[k])
                       for k, v in whole.state_dict().items()),
                   lg.shape[-1] == cfg.vocab_size,
                   torch.equal(mp.vocab_parallel_loss(lg, tok),
                               loss_fn(lg, tok))]
    os.environ["HOROVOD_MP_RULES"] = "auto"
    config.refresh()

    def error(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__ + ": " + str(e)
    info["twice"] = error(lambda: mp.tensor_parallel(m))
    moe = mp.tensor_parallel(GPT2(GPT2Config.tiny(num_experts=2)))
    info["moe"] = [list(moe.h[0].mlp.moe.w_in.shape),
                   list(moe.h[0].attn.qkv.weight.shape)]
    info["sp"] = error(lambda: mp.tensor_parallel(
        GPT2(GPT2Config.tiny(use_ring_attention=True))))
    x = torch.full((2,), float(r))
    info["dp_line_allreduce"] = hvd.allreduce(
        x, process_set=mesh.process_set("dp")).tolist()
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_MESH="dp1xmp2")
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "120", str(script), REPO, str(tmp / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-4000:]
    return [json.load(open(tmp / f"out.rank{r}.json")) for r in range(2)]


def test_mp_stack_broadcast_fetch(world):
    for r, info in enumerate(world):
        assert info["stack"] == [[float(r)] * 3, [r, r + 1], "cpu"]
        assert info["broadcast"] == [0, 1, 2, 3]
        assert info["fetch_type"] == "ndarray"


def test_wrap_spmd_puts_the_mp_set_in_scope(world):
    for r, info in enumerate(world):
        assert info["scope"] == [5, True, 0]
        # The mp line spans the world here: it is the global set.
        assert info["tp"] == [2, r, None]


def test_tensor_parallel_one_rank_and_refusals(world):
    for info in world:
        assert info["one_rank_unchanged"]
        assert info["split_shape"] == [96, 64]
        assert info["twice"].startswith("ValueError: the model is "
                                        "tensor-parallel already")
        # MoE: the experts stay whole over tp (no ep line given), the
        # attention splits; sp: a split model must name its sp line.
        assert info["moe"] == [[2, 64, 256], [96, 64]]
        assert info["sp"].startswith("ValueError") and \
            "sp=mesh.process_set('sp')" in info["sp"]


def test_mp_rules_off_keeps_the_model_whole(world):
    """``HOROVOD_MP_RULES=off`` at mp 2: ``tensor_parallel`` splits no
    weight (under ``auto`` the same call halves qkv, see above), the
    logits cover the whole vocab and ``vocab_parallel_loss`` is
    ``loss_fn``."""
    for info in world:
        assert info["off"] == [True, True, True, True]


def test_mesh_lines_negotiate_as_one_op(world):
    """Each rank's dp line is a one-rank set of its own: an eager allreduce
    over it takes one negotiation round (the reference's in-program
    reduction over the dp axis) and returns the rank's own value."""
    for r, info in enumerate(world):
        assert info["dp_line_allreduce"] == [float(r)] * 2
