"""horovod_tpu_torch's functional step == horovod_tpu's: ``grad``,
``value_and_grad``, ``DistributedGradientTape``, ``grad(overlap=True)``
(the backward taps of ``overlap.py``), ``broadcast_variables`` and
``accumulation_has_updated``.

A tiny fp32 GPT-2 (``GPT2Config.tiny``, dense attention) is initialised by
the JAX package and carried to the port (``gpt2_params_from_jax``). On a
spawned four-rank gloo world of the port, rank r takes rows 2r..2r+1 of an
8-row batch and differentiates ``loss_fn`` over
``torch.func.functional_call(model, params, ...)`` with respect to the
``dict`` of parameters; the reference runs the same under ``hvd.spmd`` on
its 8-device CPU mesh with the four ranks' batches on devices 0-3 and the
process set {0, 1, 2, 3}. Gradients must equal the reference's within the
GPT-2 test's ``GRAD_TOL`` (rtol 1e-3, atol 1e-6), values within rtol
1e-5, atol 1e-6.

The two traps, each pinned by a check that fails on the other choice:
* the value: the reference averages it over the set only inside its SPMD
  context; the port's processes are that context, so every rank's value is
  the average (and not its own loss, which differs);
* the tap: the reference's tap is an identity outside SPMD; the port's
  reduces whenever ``hvd`` is initialised, so ``grad(overlap=True)``
  gives the averaged gradients (not the rank's own).

Round counter: ``grad``, ``value_and_grad`` and the tape take one
negotiation round (the gradients' fused allreduce); ``grad(overlap=True)``
takes none, its taps being in-step allreduces (counted by
``collective_traced_total``): one a bucket of leaves, in registration
order, of at most the fusion threshold: one for the whole tiny model at
the default 64 MB, flat or in two groups; at a threshold the size of the
largest tensor, as many as a greedy cut of the tensors' sizes gives, and
the gradients are the plain ones. The value's average is one more
in-step allreduce.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JConfig
from horovod_tpu.models.gpt2 import loss_fn as jloss_fn

from horovod_tpu_torch.models.convert import gpt2_params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B, T = 4, 2, 32
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
VALUE_TOL = dict(rtol=1e-5, atol=1e-6)


def _tokens():
    return np.random.default_rng(31).integers(0, 256, (N * B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_params():
    params = JGPT2(JConfig.tiny(dtype=jnp.float32)).init(
        jax.random.PRNGKey(5), jnp.asarray(_tokens()[:B]))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from torch.func import functional_call
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn

    hvd.init(device="cpu")
    r = hvd.rank()
    d = np.load(sys.argv[2])
    B = int(sys.argv[4])
    m = GPT2(GPT2Config.tiny(dtype=torch.float32))
    m.load_state_dict({k[2:]: torch.tensor(d[k]) for k in d.files
                       if k.startswith("p:")})
    params = {k: v.detach() for k, v in m.named_parameters()}
    tok = torch.tensor(d["tok"][r * B:(r + 1) * B])

    def f(p, t):
        return loss_fn(functional_call(m, p, (t,)), t)

    def f2(blocks, rest, t):
        return f({**blocks, **rest}, t)

    def count(name):
        return sum(s["value"] for s in
                   hvd.metrics()["counters"].get(name, []))

    out, info = {}, {"params": len(params)}

    def run(tag, fn):
        r0 = sum(C.negotiation_stats().values())
        t0 = count("collective_traced_total")
        res = fn()
        info[tag] = {"rounds": sum(C.negotiation_stats().values()) - r0,
                     "traced": count("collective_traced_total") - t0}
        return res

    for k, g in run("grad", lambda: hvd.grad(f)(params, tok)).items():
        out["grad:" + k] = g
    v, g = run("value_and_grad", lambda: hvd.value_and_grad(f)(params, tok))
    out["vg_value"] = v
    for k, x in g.items():
        out["vg:" + k] = x
    (v, aux), _ = hvd.value_and_grad(lambda p, t: (f(p, t), 2 * f(p, t)),
                                     has_aux=True)(params, tok)
    out["aux_value"], out["aux_aux"] = v, aux
    tape = hvd.DistributedGradientTape()
    for k, x in run("tape", lambda: tape.gradient(f, params, tok)).items():
        out["tape:" + k] = x
    ov = run("overlap", lambda: hvd.grad(f, overlap=True)(params, tok))
    for k, x in ov.items():
        out["ov:" + k] = x
    blocks = {k: v for k, v in params.items() if k.startswith("h.")}
    rest = {k: v for k, v in params.items() if not k.startswith("h.")}
    # One tap a top-level group: two groups here.
    nested = run("overlap_nested", lambda: hvd.grad(
        lambda p, t: f({**p["h"], **p["rest"]}, t), overlap=True)(
            {"h": blocks, "rest": rest}, tok))
    for k, x in {**nested["h"], **nested["rest"]}.items():
        out["nested:" + k] = x
    # Buckets of at most the largest tensor's bytes.
    from horovod_tpu_torch import overlap as O
    info["sizes"] = [p.numel() * p.element_size() for p in params.values()]
    info["small"] = max(info["sizes"])

    def bucketed():
        xs = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        v = f(O.tap_params(xs, fusion_threshold_bytes=info["small"]), tok)
        return dict(zip(xs, torch.autograd.grad(v, list(xs.values()))))
    for k, x in run("overlap_buckets", bucketed).items():
        out["bk:" + k] = x
    ga, gb = hvd.grad(f2, argnums=(0, 1))(blocks, rest, tok)
    for k, x in {**ga, **gb}.items():
        out["argnums:" + k] = x
    out["local_value"] = f(params, tok).detach()
    m.zero_grad()
    loss_fn(m(tok), tok).backward()
    for k, p in m.named_parameters():
        out["local:" + k] = p.grad

    bv = {"a": torch.full((3,), float(r)), "b": torch.full((2, 2), 10.0 + r)}
    back = hvd.broadcast_variables(bv, root_rank=1)
    info["broadcast_returns_input"] = back is bv
    out["bv_a"], out["bv_b"] = bv["a"], bv["b"]

    w = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   backward_passes_per_step=2)
    flags = []
    for i in range(4):
        w.grad = torch.ones(3)
        opt.step()
        flags.append(hvd.accumulation_has_updated(opt))
    info["has_updated"] = flags
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.detach().numpy() for k, v in out.items()})
    with open(sys.argv[3] + f".rank{r}.json", "w") as fh:
        json.dump(info, fh)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("grad")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    sd = gpt2_params_from_jax(jax_params)
    np.savez(data, tok=_tokens(),
             **{f"p:{k}": v.numpy() for k, v in sd.items()})
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(N),
         "--timeout", "240", str(script), REPO, str(data), str(out), str(B)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [(dict(np.load(f"{out}.rank{i}.npz")),
             json.load(open(f"{out}.rank{i}.json"))) for i in range(N)]


@pytest.fixture(scope="module")
def reference(jax_params):
    """The reference's results per device 0-3 under ``hvd.spmd`` over the
    process set {0, 1, 2, 3} of its 8-device mesh."""
    jm = JGPT2(JConfig.tiny(dtype=jnp.float32))
    tok = _tokens()
    # Devices 4-7 (outside the set) repeat the four ranks' batches.
    batch = jnp.asarray(np.concatenate([tok, tok]))
    params = jax.tree_util.tree_map(jnp.asarray, jax_params)
    ps = jhvd.add_process_set([0, 1, 2, 3])

    def f(p, t):
        return jloss_fn(jm.apply({"params": p}, t), t)

    def stack(x):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], x)

    def body(p, t):
        out = {"grad": jhvd.grad(f, process_set=ps)(p, t),
               "overlap": jhvd.grad(f, process_set=ps, overlap=True)(p, t),
               "tape": jhvd.DistributedGradientTape(
                   process_set=ps).gradient(f, p, t),
               "local": jax.grad(f)(p, t)}
        v, g = jhvd.value_and_grad(f, process_set=ps)(p, t)
        out.update(vg=g, vg_value=v)
        (v, aux), _ = jhvd.value_and_grad(
            lambda p, t: (f(p, t), 2 * f(p, t)), process_set=ps,
            has_aux=True)(p, t)
        out.update(aux_value=v, aux_aux=aux, local_value=f(p, t))
        return stack(out)

    try:
        res = jhvd.spmd(body, in_specs=(P(), P("hvd")),
                        out_specs=P("hvd"))(params, batch)
    finally:
        jhvd.remove_process_set(ps)
    res = jax.tree_util.tree_map(np.asarray, res)
    out = []
    for r in range(N):
        row = jax.tree_util.tree_map(lambda a: a[r], res)
        flat = {}
        for tag in ("grad", "overlap", "tape", "vg", "local"):
            for k, v in gpt2_params_from_jax(row[tag]).items():
                flat[f"{tag}:{k}"] = v.numpy()
        for tag in ("vg_value", "aux_value", "aux_aux", "local_value"):
            flat[tag] = row[tag]
        out.append(flat)
    return out


def _grads(res, tag):
    return {k.split(":", 1)[1]: v for k, v in res.items()
            if k.startswith(tag + ":")}


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("tag,ref_tag", [("grad", "grad"), ("vg", "vg"),
                                         ("tape", "tape"), ("ov", "overlap"),
                                         ("argnums", "grad"),
                                         ("nested", "overlap"),
                                         ("local", "local")])
def test_gradients_equal_the_reference(world, reference, rank, tag,
                                       ref_tag):
    got, want = _grads(world[rank][0], tag), _grads(reference[rank], ref_tag)
    assert set(got) == set(want) and len(got) == world[0][1]["params"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{tag} {k}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("rank", range(N))
def test_value_is_averaged_over_the_set(world, reference, rank):
    res, want = world[rank][0], reference[rank]
    for tag in ("vg_value", "aux_value", "aux_aux", "local_value"):
        np.testing.assert_allclose(res[tag], want[tag], err_msg=tag,
                                   **VALUE_TOL)
    # The trap: the rank's own loss is not the average.
    assert not np.allclose(res["local_value"], res["vg_value"], **VALUE_TOL)
    np.testing.assert_allclose(
        res["vg_value"], np.mean([w[0]["local_value"] for w in world]),
        **VALUE_TOL)


@pytest.mark.parametrize("rank", range(N))
def test_taps_reduce_in_the_ports_world(world, rank):
    res = world[rank][0]
    ov, local, plain = (_grads(res, t) for t in ("ov", "local", "grad"))
    # The trap: an identity tap would give the rank's own gradients.
    assert any(not np.allclose(ov[k], local[k], **GRAD_TOL) for k in ov)
    for k in ov:
        np.testing.assert_allclose(ov[k], plain[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_round_counter_under_the_taps(world):
    for _, info in world:
        n = info["params"]
        assert info["grad"] == {"rounds": 1, "traced": 0}
        assert info["tape"] == {"rounds": 1, "traced": 0}
        assert info["value_and_grad"] == {"rounds": 1, "traced": 1}
        assert info["overlap"] == {"rounds": 0, "traced": 1}
        assert info["overlap_nested"] == {"rounds": 0, "traced": 1}
        buckets, size = 1, 0
        for b in info["sizes"]:
            if size and size + b > info["small"]:
                buckets, size = buckets + 1, 0
            size += b
        assert len(info["sizes"]) == n and 1 < buckets < n
        assert info["overlap_buckets"] == {"rounds": 0, "traced": buckets}


@pytest.mark.parametrize("rank", range(N))
def test_bucketed_taps_give_the_plain_gradients(world, rank):
    res = world[rank][0]
    bk, plain = _grads(res, "bk"), _grads(res, "grad")
    assert bk.keys() == plain.keys()
    for k in bk:
        np.testing.assert_allclose(bk[k], plain[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_broadcast_variables_gives_the_roots_values(world):
    for res, info in world:
        assert info["broadcast_returns_input"] is True
        np.testing.assert_array_equal(res["bv_a"], np.full(3, 1.0))
        np.testing.assert_array_equal(res["bv_b"], np.full((2, 2), 11.0))


def test_accumulation_has_updated_as_the_reference(world):
    opt = jhvd.DistributedOptimizer(optax.sgd(0.1),
                                    backward_passes_per_step=2)
    state = opt.init(jnp.zeros(3))
    want = []
    for _ in range(4):
        _, state = opt.update(jnp.ones(3), state, jnp.zeros(3))
        want.append(bool(jhvd.accumulation_has_updated(state)))
    assert want == [False, True, False, True]
    for _, info in world:
        assert info["has_updated"] == want


def test_unsupported_gradient_options_raise():
    import horovod_tpu_torch as hvd
    with pytest.raises(TypeError, match="has_aux only"):
        hvd.grad(lambda p: p, holomorphic=True)
    with pytest.raises(ValueError, match="unknown allreduce algorithm"):
        hvd.grad(lambda p: p, overlap=True, algorithm="nope")
