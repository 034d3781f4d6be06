"""horovod_tpu_torch GPT-2, Llama and BERT under sequence parallelism ==
horovod_tpu's: forward logits (BERT's MLM and NSP heads) on the rings and
Ulysses, and one data-parallel step of GPT-2 under ``striped_lm_loss``.

Tiny one-layer fp32 models are initialised by the JAX package and carried
to the port with the ``*_params_from_jax`` converters. Spawned gloo worlds
of 2, 3 and 4 ranks (started together, shared by the module) run each case
of their size with rank r feeding columns ``[r * t_local, (r + 1) *
t_local)`` of the same numpy tokens; the reference runs the same model with
``use_ring_attention=True`` under ``hvd.init(devices=jax.devices()[:n],
axis_name="sp")`` and ``hvd.spmd`` (Pallas in interpret mode). Striped
cases feed both sides the tokens in striped order. The port's models shard
over the global process set, where the reference's name the axis "sp".

The step is SGD (its update is the averaged gradient itself) on two ranks,
under the "dots" remat on both sides:
``striped_lm_loss`` gives each rank n times its share of the gradient, as
the reference's ``psum`` does under ``shard_map``, and
``DistributedOptimizer``'s average cancels the n on both sides.

Tolerances (fp32, sums in other orders): logits rtol 1e-4, atol 2e-5, as
the port's single-rank model tests; parameters after the step atol 2e-5.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models.bert import Bert as JBert
from horovod_tpu.models.bert import BertConfig as JBertConfig
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JGPT2Config
from horovod_tpu.models.gpt2 import striped_lm_loss as jstriped_lm_loss
from horovod_tpu.models.llama import Llama as JLlama
from horovod_tpu.models.llama import LlamaConfig as JLlamaConfig
from horovod_tpu.ops.attention import packed_positions as jpacked_positions

from horovod_tpu_torch.models.convert import (bert_params_from_jax,
                                              gpt2_params_from_jax,
                                              llama_params_from_jax)
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 2, 48
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
STEP_TOL = dict(rtol=0, atol=2e-5)
LR = 0.5

# name -> (ranks, model, sp fields, packed / masked input)
CASES = {
    "gpt2_ring_flash_contig_n2": (2, "gpt2", ("ring", "contiguous",
                                              "flash"), None),
    "gpt2_ring_dense_striped_n4": (4, "gpt2", ("ring", "striped", "dense"),
                                   None),
    "gpt2_ulysses_flash_n3": (3, "gpt2", ("ulysses", "contiguous", "flash"),
                              None),
    "gpt2_packed_ring_flash_n2": (2, "gpt2", ("ring", "contiguous",
                                              "flash"), "packed"),
    "llama_ring_flash_striped_n2": (2, "llama", ("ring", "striped",
                                                 "flash"), None),
    "llama_ulysses_dense_n4": (4, "llama", ("ulysses", "contiguous",
                                            "dense"), None),
    "bert_ring_flash_mask_n2": (2, "bert", ("ring", "contiguous", "flash"),
                                "mask"),
    "bert_ulysses_dense_mask_n3": (3, "bert", ("ulysses", "contiguous",
                                               "dense"), "mask"),
}
STEP_CASE = "gpt2_striped_step_n2"
STEP = (2, "gpt2", ("ring", "striped", "flash"), "step")

JAX_MODELS = {"gpt2": (JGPT2, JGPT2Config), "llama": (JLlama, JLlamaConfig),
              "bert": (JBert, JBertConfig)}
CONVERT = {"gpt2": gpt2_params_from_jax, "llama": llama_params_from_jax,
           "bert": bert_params_from_jax}


def _all_cases():
    return dict(CASES, **{STEP_CASE: STEP})


def _jcfg(model, sp=None):
    cfg = dataclasses.replace(JAX_MODELS[model][1].tiny(),
                              dtype=jnp.float32, num_layers=1)
    if sp is None:
        return cfg
    sp_impl, layout, attention = sp
    return dataclasses.replace(cfg, use_ring_attention=True, sp_impl=sp_impl,
                               ring_layout=layout, attention=attention)


def _inputs(name):
    n, model, _, extra = _all_cases()[name]
    g = np.random.default_rng(sum(map(ord, name)))
    tokens = g.integers(0, 256, (B, T)).astype(np.int32)
    out = {"tokens": tokens}
    if extra == "packed":
        seg = np.cumsum(g.random((B, T)) < 0.15, axis=1).astype(np.int32)
        out["segment_ids"] = seg
        out["positions"] = np.asarray(jpacked_positions(jnp.asarray(seg)))
    if extra == "mask":
        out["attention_mask"] = np.arange(T)[None, :] < np.array(
            [[T - 5], [T - 19]])
    return out


@pytest.fixture(scope="module")
def jax_params():
    """One-layer tiny parameters of each model, from the reference."""
    tok = jnp.zeros((B, 8), jnp.int32)
    out = {}
    for model, (cls, _) in JAX_MODELS.items():
        p = cls(_jcfg(model)).init(jax.random.PRNGKey(0), tok)["params"]
        out[model] = jax.tree_util.tree_map(np.asarray, p)
    return out


_WORKER = textwrap.dedent("""
    import dataclasses
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.bert import Bert, BertConfig
    from horovod_tpu_torch.models import striped_lm_loss
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from horovod_tpu_torch.models.llama import Llama, LlamaConfig

    MODELS = {"gpt2": (GPT2, GPT2Config), "llama": (Llama, LlamaConfig),
              "bert": (Bert, BertConfig)}
    hvd.init(device="cpu")
    n, r = hvd.size(), hvd.rank()
    data = np.load(sys.argv[2])
    out = {}
    for name in data["names"]:
        name = str(name)
        want_n, model, sp_impl, layout, attention, extra = \\
            data[name + ":cfg"].tolist()
        if int(want_n) != n:
            continue
        cls, cfg_cls = MODELS[model]
        # The step runs under the "dots" remat: the recompute issues the
        # ring's exchanges again.
        remat = dict(remat=True, remat_policy="dots") if extra == "step" \
            else {}
        m = cls(dataclasses.replace(
            cfg_cls.tiny(), dtype=torch.float32, num_layers=1,
            use_ring_attention=True, sp_impl=sp_impl, ring_layout=layout,
            attention=attention, **remat))
        m.load_state_dict({k.split(":", 2)[2]: torch.tensor(data[k])
                           for k in data.files
                           if k.startswith(name + ":p:")})
        t = data[name + ":tokens"].shape[1] // n
        cols = slice(r * t, (r + 1) * t)
        shard = {k: torch.tensor(data[f"{name}:{k}"][:, cols])
                 for k in ("tokens", "segment_ids", "positions",
                           "attention_mask")
                 if f"{name}:{k}" in data.files}
        tok = shard.pop("tokens")
        if extra == "step":
            opt = hvd.DistributedOptimizer(
                torch.optim.SGD(m.parameters(), lr=float(sys.argv[4])))
            opt.zero_grad()
            striped_lm_loss(m(tok), tok).backward()
            opt.step()
            for k, p in m.named_parameters():
                out[f"{name}:p:{k}"] = p.detach().numpy()
            continue
        with torch.no_grad():
            got = m(tok, **shard)
        if model == "bert":
            out[name + ":logits"] = got[0].numpy()
            out[name + ":nsp"] = got[1].numpy()
        else:
            out[name + ":logits"] = got.numpy()
    np.savez(sys.argv[3] + f".rank{r}.npz", **out)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("sp_models")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    arrays = {"names": np.array(sorted(_all_cases()))}
    for name, (n, model, sp, extra) in _all_cases().items():
        arrays[name + ":cfg"] = np.array([n, model, *sp, extra or "none"])
        arrays.update({f"{name}:{k}": v for k, v in _inputs(name).items()})
        for k, v in CONVERT[model](jax_params[model]).items():
            arrays[f"{name}:p:{k}"] = v.numpy()
    data = tmp / "data.npz"
    np.savez(data, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "--timeout", "240", str(script), REPO, str(data),
         str(tmp / f"out{n}"), str(LR)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in (2, 3, 4)}
    out = {}
    for n, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        out[n] = [dict(np.load(tmp / f"out{n}.rank{r}.npz"))
                  for r in range(n)]
    return out


def _port(worlds, name, key, axis=1):
    n = _all_cases()[name][0]
    parts = [worlds[n][r][f"{name}:{key}"] for r in range(n)]
    return np.concatenate(parts, axis=axis) if axis is not None else parts


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_parallel_forward_matches_jax(worlds, jax_params, name):
    n, model, sp, extra = CASES[name]
    x = _inputs(name)
    jm = JAX_MODELS[model][0](_jcfg(model, sp))
    keys = [k for k in ("segment_ids", "positions", "attention_mask")
            if k in x]
    jhvd.init(devices=jax.devices()[:n], axis_name="sp")
    try:
        def body(p, tok, *rest):
            return jm.apply({"params": p}, tok, **dict(zip(keys, rest)))
        spec = P(None, "sp")
        outs = (spec, P()) if model == "bert" else spec
        fn = jhvd.spmd(body, in_specs=(P(), spec) + (spec,) * len(keys),
                       out_specs=outs)
        want = fn(jax_params[model], jnp.asarray(x["tokens"]),
                  *(jnp.asarray(x[k]) for k in keys))
    finally:
        jhvd.init()
    if model == "bert":
        want, want_nsp = want
        # Every rank's NSP head reads rank 0's [CLS].
        for nsp in _port(worlds, name, "nsp", axis=None):
            np.testing.assert_allclose(nsp, np.asarray(want_nsp),
                                       **LOGIT_TOL)
    np.testing.assert_allclose(_port(worlds, name, "logits"),
                               np.asarray(want), err_msg=name, **LOGIT_TOL)


def test_striped_loss_step_matches_jax(worlds, jax_params):
    n, model, sp, _ = STEP
    tokens = _inputs(STEP_CASE)["tokens"]
    jm = JGPT2(dataclasses.replace(_jcfg(model, sp), remat=True,
                                   remat_policy="dots"))
    jhvd.init(devices=jax.devices()[:n], axis_name="sp")
    try:
        opt = jhvd.DistributedOptimizer(optax.sgd(LR))
        params = jax.tree_util.tree_map(jnp.asarray, jax_params[model])
        state = opt.init(params)

        def step(p, s, tok):
            g = jax.grad(lambda p: jstriped_lm_loss(
                jm.apply({"params": p}, tok), tok, "sp"))(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s

        new, _ = jhvd.spmd(step, in_specs=(P(), P(), P(None, "sp")),
                           out_specs=(P(), P()))(params, state,
                                                 jnp.asarray(tokens))
    finally:
        jhvd.init()
    want = gpt2_params_from_jax(jax.tree_util.tree_map(np.asarray, new))
    ranks = worlds[n]
    prefix = STEP_CASE + ":p:"
    got = {k[len(prefix):]: v for k, v in ranks[0].items()
           if k.startswith(prefix)}
    assert set(got) == set(want)
    for k in got:           # every rank took the same step
        np.testing.assert_array_equal(ranks[1][prefix + k], got[k])
        np.testing.assert_allclose(got[k], want[k].numpy(), err_msg=k,
                                   **STEP_TOL)
    before = gpt2_params_from_jax(jax_params[model])
    assert not np.allclose(got["wte"], before["wte"].numpy(), **STEP_TOL)


def test_packed_shards_need_positions():
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, use_ring_attention=True))
    tok = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="need explicit positions="):
        m(tok, segment_ids=torch.zeros_like(tok))
