"""Tensor-parallel decode in horovod_tpu_torch (``mp.tp_decode_step``,
``mp.tp_decode_verify_step``) == the reference's, run as
``tests/test_mp.py:113-150`` runs it: ``tp_decode_step`` under ``wrap_spmd``
on two CPU devices, the parameters ``split_params``' parts stacked by
``mp_stack``, the cache at half the kv heads.

Tiny fp32 GPT-2 and Llama (4 heads over 2 kv heads), weights of the
reference's init carried over with ``models/convert.py``; batch 2, a cache
of 8 positions. On a spawned two-rank gloo world
(``HOROVOD_MESH=dp1xmp2``), each rank with its part and its half of the kv
heads:

* three decode steps (positions 0-2) and then one verify call of three
  tokens from position 3 (``wrap_spmd`` over the mesh): the greedy tokens
  equal the reference's and the logits (every step's, and the verify
  call's first) are within atol 1e-5 of its whole gathered logits (the
  row-parallel sums are taken in another order);
* over a one-rank set (the rank's dp line) ``tp_decode_step`` on the whole
  parameters equals ``decode_step`` on the model bit for bit, logits and
  cache, for the three steps.
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

from horovod_tpu.models import generate as jgen
from horovod_tpu.models import gpt2 as jgpt2
from horovod_tpu.models import llama as jllama
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import mp as jmp

from horovod_tpu_torch.models import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("gpt2", "llama")
B, T, STEPS, K = 2, 8, 3, 3
LOGIT_TOL = dict(rtol=0, atol=1e-5)


def _jcfg(fam):
    return (jgpt2.GPT2Config.tiny(dtype=jnp.float32) if fam == "gpt2"
            else jllama.LlamaConfig.tiny(dtype=jnp.float32))


def _inputs():
    g = np.random.default_rng(11)
    return {"toks": g.integers(0, 256, (STEPS, B)).astype(np.int32),
            "vtoks": g.integers(0, 256, (K, B)).astype(np.int32)}


@pytest.fixture(scope="module")
def params():
    out = {}
    for fam in FAMILIES:
        model = (jgpt2.GPT2 if fam == "gpt2" else jllama.Llama)(_jcfg(fam))
        p = model.init(jax.random.PRNGKey(5), jnp.ones((1, 4), jnp.int32))
        out[fam] = jax.tree_util.tree_map(np.asarray, p["params"])
    return out


@pytest.fixture(scope="module")
def reference(params):
    """Per family: each step's gathered logits and greedy tokens, then the
    verify call's first logits and greedy chain."""
    d = _inputs()
    mdev = jmesh.make_mesh2d(1, 2, jax.devices()[:2])
    out = {}
    for fam in FAMILIES:
        cfg = _jcfg(fam)
        fam_ = jgen.decode_family(cfg)
        kvh, hd = fam_.kv_heads(cfg), cfg.d_model // cfg.num_heads
        cache = {i: {"k": jnp.zeros((B, T, kvh // 2, hd), jnp.float32),
                     "v": jnp.zeros((B, T, kvh // 2, hd), jnp.float32)}
                 for i in range(cfg.num_layers)}
        step = jmp.tp_decode_step(cfg)
        prog = jax.jit(jmp.wrap_spmd(
            lambda p, c, t, i, step=step: step(p, c, t, i), mdev))
        pstk = jmp.mp_stack(
            lambda r, cfg=cfg, fam=fam: jmp.split_params(cfg, params[fam], 2,
                                                         r), mdev)
        cstk = jmp.mp_broadcast(cache, mdev)
        logits, greedy = [], []
        for j in range(STEPS):
            cstk, lg = prog(pstk, cstk, jmp.mp_broadcast(d["toks"][j], mdev),
                            jmp.mp_broadcast(np.int32(j), mdev))
            lg = jmp.mp_fetch(lg)
            logits.append(lg)
            greedy.append(np.asarray(jgen.greedy_token(jnp.asarray(lg))))
        verify = jmp.tp_decode_verify_step(cfg)
        vprog = jax.jit(jmp.wrap_spmd(
            lambda p, c, t, i, verify=verify: verify(p, c, t, i), mdev))
        _, first, vgreedy = vprog(pstk, cstk,
                                  jmp.mp_broadcast(d["vtoks"], mdev),
                                  jmp.mp_broadcast(np.int32(STEPS), mdev))
        out[fam] = (np.stack(logits), np.stack(greedy),
                    jmp.mp_fetch(first), jmp.mp_fetch(vgreedy))
    return out


_WORKER = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import convert
    from horovod_tpu_torch.models import generate as G
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig
    from horovod_tpu_torch.parallel import mp

    B, T = 2, 8
    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = hvd.mesh2d()
    d = dict(np.load(sys.argv[2] + ".in.npz"))
    toks = torch.tensor(d["toks"]).long()
    vtoks = torch.tensor(d["vtoks"]).long()
    out, info = {}, {}
    for fam in ("gpt2", "llama"):
        cfg = (GPT2Config.tiny(dtype=torch.float32) if fam == "gpt2"
               else LlamaConfig.tiny(dtype=torch.float32))
        state = convert.gpt2_params_from_jax(
            dict(np.load(sys.argv[2] + f".{fam}.npz")))
        part = mp.split_params(cfg, state, hvd.mp_size(), hvd.mp_rank())
        kvh = G.decode_family(cfg).kv_heads(cfg)
        hd = cfg.d_model // cfg.num_heads

        def cache(heads):
            return {i: {"k": torch.zeros(B, T, heads, hd),
                        "v": torch.zeros(B, T, heads, hd)}
                    for i in range(cfg.num_layers)}
        c = cache(kvh // hvd.mp_size())
        step = mp.tp_decode_step(cfg)
        logits = []
        for j in range(toks.shape[0]):
            c, lg = step(part, c, toks[j], j)
            logits.append(lg.numpy())
        out[fam + ":logits"] = np.stack(logits)
        verify = mp.wrap_spmd(mp.tp_decode_verify_step(cfg), mesh)
        _, first, greedy = verify(part, c, vtoks, toks.shape[0])
        out[fam + ":first"], out[fam + ":vgreedy"] = (first.numpy(),
                                                      greedy.numpy())
        # mp 1: the whole parameters over this rank's one-rank dp line.
        model = (GPT2 if fam == "gpt2" else Llama)(cfg)
        model.load_state_dict(state)
        dense, one = G.decode_step(cfg), mp.tp_decode_step(
            cfg, process_set=mesh.process_set("dp"))
        ca, cb, same = cache(kvh), cache(kvh), True
        for j in range(toks.shape[0]):
            ca, la = dense(model, ca, toks[j], j)
            cb, lb = one(state, cb, toks[j], j)
            same = same and torch.equal(la, lb) and all(
                torch.equal(ca[i][k], cb[i][k]) for i in ca for k in "kv")
        info[fam + ":mp1_bit_equal"] = same
    np.savez(sys.argv[2] + f".rank{r}.npz", **out)
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
''')


@pytest.fixture(scope="module")
def world(tmp_path_factory, params):
    tmp = tmp_path_factory.mktemp("tp_decode")
    np.savez(tmp / "out.in.npz", **_inputs())
    for fam in FAMILIES:
        np.savez(tmp / f"out.{fam}.npz", **convert.flatten_tree(params[fam]))
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", HOROVOD_MESH="dp1xmp2")
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "120", str(script), REPO, str(tmp / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=180)
    assert p.returncode == 0, p.stderr[-4000:]
    return [(dict(np.load(tmp / f"out.rank{r}.npz")),
             json.load(open(tmp / f"out.rank{r}.json"))) for r in range(2)]


@pytest.mark.parametrize("fam", FAMILIES)
def test_decode_steps_match_reference(world, reference, fam):
    logits, greedy, _, _ = reference[fam]
    for arrs, _ in world:
        np.testing.assert_allclose(arrs[fam + ":logits"], logits,
                                   **LOGIT_TOL)
        got = np.stack([np.asarray(jgen.greedy_token(jnp.asarray(lg)))
                        for lg in arrs[fam + ":logits"]])
        np.testing.assert_array_equal(got, greedy)


@pytest.mark.parametrize("fam", FAMILIES)
def test_verify_call_matches_reference(world, reference, fam):
    _, _, first, vgreedy = reference[fam]
    for arrs, _ in world:
        np.testing.assert_allclose(arrs[fam + ":first"], first, **LOGIT_TOL)
        np.testing.assert_array_equal(arrs[fam + ":vgreedy"], vgreedy)


@pytest.mark.parametrize("fam", FAMILIES)
def test_one_rank_step_is_decode_step_bit_for_bit(world, fam):
    for _, info in world:
        assert info[fam + ":mp1_bit_equal"]
