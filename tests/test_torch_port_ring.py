"""horovod_tpu_torch sequence-parallel attention == horovod_tpu's: the dense
ring, the flash ring and Ulysses (dense and flash), forward and the
gradient of every input, and the flash kernels' plain versions with
separate query and key segment ids.

Three spawned gloo worlds of the port (2, 3 and 4 ranks, started together
and shared by the module) each run the cases of their size: rank r holds
rows ``[r * t_local, (r + 1) * t_local)`` of the global (B, T, H, D)
arrays, runs the op over the global process set, and backpropagates
``sum(o * w)`` for a seeded ``w``. The reference runs the same cases with
``hvd.init(devices=jax.devices()[:n], axis_name="sp")`` and ``hvd.spmd``
(Pallas in interpret mode) on the same numpy inputs; the per-rank outputs
and gradients, laid side by side, must equal its sharded results. Under the
striped layout the arrays hold the tokens in striped order, as the
reference's tests feed them. Three ranks with four heads pad Ulysses' heads
to six.

Tolerances: both sides compute in fp32 and sum in different orders (the
plain flash versions tile by 128, the reference's kernels by its tile
table): rtol 1e-4 and atol 2e-5 for outputs and gradients, as the
reference's own ring tests hold a ring to dense attention.
"""

import importlib
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as jhvd
from horovod_tpu.ops.flash_attention import _bwd as jbwd
from horovod_tpu.ops.flash_attention import _fwd as jfwd
from horovod_tpu.ops.ring_attention import ring_attention as jring
from horovod_tpu.ops.ring_flash import _pack as jpack
from horovod_tpu.ops.ring_flash import _ring as jring_raw
from horovod_tpu.ops.ring_flash import ring_flash_attention as jring_flash
from horovod_tpu.ops.sequence import ulysses_attention as julysses

pfa = importlib.import_module("horovod_tpu_torch.ops.flash_attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, D = 2, 48, 4, 16
TOL = dict(rtol=1e-4, atol=2e-5)

# name -> (ranks, op, layout, causal, mask)
CASES = {
    "ring_contig_causal_n2": (2, "ring", "contiguous", True, None),
    "ring_striped_keymask_n2": (2, "ring", "striped", True, "key_mask"),
    "ring_full_seg_n4": (4, "ring", "contiguous", False, "segment_ids"),
    "ring_striped_seg_n3": (3, "ring", "striped", True, "segment_ids"),
    "flash_contig_causal_seg_n2": (2, "flash", "contiguous", True,
                                   "segment_ids"),
    "flash_striped_causal_n2": (2, "flash", "striped", True, None),
    "flash_full_keymask_n2": (2, "flash", "contiguous", False, "key_mask"),
    "flash_contig_keymask_n4": (4, "flash", "contiguous", True, "key_mask"),
    "flash_striped_seg_n4": (4, "flash", "striped", True, "segment_ids"),
    "flash_striped_keymask_n3": (3, "flash", "striped", True, "key_mask"),
    "ulysses_dense_keymask_n3": (3, "ulysses_dense", "contiguous", True,
                                 "key_mask"),
    "ulysses_flash_seg_n3": (3, "ulysses_flash", "contiguous", True,
                             "segment_ids"),
    "ulysses_dense_full_seg_n2": (2, "ulysses_dense", "contiguous", False,
                                  "segment_ids"),
    "ulysses_flash_full_keymask_n4": (4, "ulysses_flash", "contiguous",
                                      False, "key_mask"),
}
# The flash ring's key-bias cotangent riding home with dK/dV
# (``want_dbias``), against the reference's ``_ring``.
DBIAS_CASE = "flash_dbias_n2"


def _inputs(name):
    g = np.random.default_rng(sum(map(ord, name)))
    q, k, v, w = (g.standard_normal((B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    km = g.random((B, T)) > 0.3
    seg = np.sort(g.integers(0, 3, (B, T)), axis=1).astype(np.int32)
    bias = np.where(km, 0.0, -1e30).astype(np.float32)
    bias[:, ::5] += g.standard_normal((B, (T + 4) // 5)).astype(np.float32)
    return dict(q=q, k=k, v=v, w=w, key_mask=km, segment_ids=seg,
                bias=bias)


_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import (ring_attention,
                                       ring_flash_attention,
                                       ulysses_attention)
    from horovod_tpu_torch.ops import ring_flash
    from horovod_tpu_torch.ops.ring_attention import Ring

    SUBSET_CASES = {
        "flash_contig_causal_seg_n2": lambda q, k, v, ps, seg:
            ring_flash_attention(q, k, v, process_set=ps, causal=True,
                                 segment_ids=seg),
        "ulysses_dense_full_seg_n2": lambda q, k, v, ps, seg:
            ulysses_attention(q, k, v, process_set=ps, causal=False,
                              segment_ids=seg),
    }
    hvd.init(device="cpu")
    n, r = hvd.size(), hvd.rank()
    data = np.load(sys.argv[2])
    out = {}
    for name in data["names"]:
        name = str(name)
        want_n, op, layout, causal, mask = data[name + ":cfg"].tolist()
        if int(want_n) != n:
            continue
        causal = bool(int(causal))
        t = data[name + ":q"].shape[1] // n
        rows = slice(r * t, (r + 1) * t)
        q, k, v = (torch.tensor(data[f"{name}:{x}"][:, rows],
                                requires_grad=True) for x in "qkv")
        w = torch.tensor(data[name + ":w"][:, rows])
        kw = {}
        if mask != "none":
            kw[mask] = torch.tensor(data[f"{name}:{mask}"][:, rows])
        if op == "ring":
            o = ring_attention(q, k, v, causal=causal, layout=layout, **kw)
        elif op == "flash":
            o = ring_flash_attention(q, k, v, causal=causal, layout=layout,
                                     **kw)
        elif op == "dbias":
            bias = torch.tensor(data[name + ":bias"][:, rows],
                                requires_grad=True)
            b, _, h, d = q.shape
            o = ring_flash._RingFlash.apply(
                ring_flash._pack(q), ring_flash._pack(k),
                ring_flash._pack(v), bias, None, Ring(), causal,
                d ** -0.5, (None, None), layout == "striped", h, True)
            o = ring_flash._unpack(o, b, h)
        else:
            o = ulysses_attention(q, k, v, causal=causal,
                                  impl=op.split("_")[1], **kw)
        (o * w).sum().backward()
        out[name + ":o"] = o.detach().numpy()
        for x, tensor in zip("qkv", (q, k, v)):
            out[f"{name}:d{x}"] = tensor.grad.numpy()
        if op == "dbias":
            out[name + ":dbias"] = bias.grad.numpy()
    if n == 4:
        # The pairs {0, 1} and {2, 3} each run two-rank cases over their
        # own process set.
        pairs = [hvd.add_process_set([0, 1]), hvd.add_process_set([2, 3])]
        ps, pr = pairs[r // 2], r % 2
        for name, fn in SUBSET_CASES.items():
            t = data[name + ":q"].shape[1] // 2
            rows = slice(pr * t, (pr + 1) * t)
            q, k, v = (torch.tensor(data[f"{name}:{x}"][:, rows],
                                    requires_grad=True) for x in "qkv")
            seg = torch.tensor(data[name + ":segment_ids"][:, rows])
            o = fn(q, k, v, ps, seg)
            (o * torch.tensor(data[name + ":w"][:, rows])).sum().backward()
            out[f"set:{name}:o"] = o.detach().numpy()
            for x, tensor in zip("qkv", (q, k, v)):
                out[f"set:{name}:d{x}"] = tensor.grad.numpy()
    np.savez(sys.argv[3] + f".rank{r}.npz", **out)
    hvd.shutdown()
""")


def _all_cases():
    cases = {n: c for n, c in CASES.items()}
    cases[DBIAS_CASE] = (2, "dbias", "striped", True, None)
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{ranks: [rank r's outputs]} of the three worlds, run together."""
    tmp = tmp_path_factory.mktemp("ring")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    arrays = {"names": np.array(sorted(_all_cases()))}
    for name, (n, op, layout, causal, mask) in _all_cases().items():
        arrays[name + ":cfg"] = np.array(
            [n, op, layout, int(causal), mask or "none"])
        for key, val in _inputs(name).items():
            arrays[f"{name}:{key}"] = val
    np.savez(data, **arrays)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "--timeout", "240", str(script), REPO, str(data),
         str(tmp / f"out{n}")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for n in (2, 3, 4)}
    out = {}
    for n, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        out[n] = [dict(np.load(tmp / f"out{n}.rank{r}.npz"))
                  for r in range(n)]
    return out


def _reference(name):
    """The reference's (o, dq, dk, dv[, dbias]) of one case over n
    devices of the CPU mesh."""
    n, op, layout, causal, mask = _all_cases()[name]
    x = _inputs(name)
    jhvd.init(devices=jax.devices()[:n], axis_name="sp")
    try:
        def body(q, k, v, w, km, seg, bias):
            kw = {}
            if mask == "key_mask":
                kw["key_mask"] = km
            elif mask == "segment_ids":
                kw["segment_ids"] = seg

            def f(q, k, v, bias):
                if op == "ring":
                    o = jring(q, k, v, axis_name="sp", causal=causal,
                              layout=layout, **kw)
                elif op == "flash":
                    o = jring_flash(q, k, v, axis_name="sp", causal=causal,
                                    layout=layout, **kw)
                elif op == "dbias":
                    b, _, h, d = q.shape
                    o = jring_raw(jpack(q), jpack(k), jpack(v),
                                  bias[..., None], None, "sp", causal,
                                  d ** -0.5, 128, 128, layout == "striped",
                                  h, True)
                    o = o.reshape(b, h, -1, d).transpose(0, 2, 1, 3)
                else:
                    o = julysses(q, k, v, axis_name="sp", causal=causal,
                                 impl=op.split("_")[1], **kw)
                return jnp.sum(o * w), o
            (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                           has_aux=True)(q, k, v, bias)
            return (o,) + g
        spec = P(None, "sp")
        fn = jhvd.spmd(body, in_specs=(spec,) * 7, out_specs=(spec,) * 5)
        return [np.asarray(a) for a in fn(
            x["q"], x["k"], x["v"], x["w"], jnp.asarray(x["key_mask"]),
            jnp.asarray(x["segment_ids"]), x["bias"])]
    finally:
        jhvd.init()


def _port(worlds, name, key):
    n = _all_cases()[name][0]
    return np.concatenate([worlds[n][r][f"{name}:{key}"] for r in range(n)],
                          axis=1)


@pytest.mark.parametrize("name", sorted(CASES) + [DBIAS_CASE])
def test_sequence_parallel_attention_matches_jax(worlds, name):
    want = _reference(name)
    keys = ["o", "dq", "dk", "dv"] + (["dbias"] if name == DBIAS_CASE
                                      else [])
    for key, w in zip(keys, want):
        np.testing.assert_allclose(_port(worlds, name, key), w,
                                   err_msg=f"{name} {key}", **TOL)


@pytest.mark.parametrize("name", ["flash_contig_causal_seg_n2",
                                  "ulysses_dense_full_seg_n2"])
def test_process_set_takes_the_place_of_axis_name(worlds, name):
    """``process_set=`` (the port's divergence from ``axis_name``): in a
    four-rank world the pairs {0, 1} and {2, 3} each run a two-rank case
    over their own set and each pair gives the reference's two-device
    result."""
    want = _reference(name)
    for pair in ((0, 1), (2, 3)):
        for key, w in zip(["o", "dq", "dk", "dv"], want):
            got = np.concatenate([worlds[4][r][f"set:{name}:{key}"]
                                  for r in pair], axis=1)
            np.testing.assert_allclose(got, w, err_msg=f"{pair} {key}",
                                       **TOL)


def test_every_rank_ran_its_cases(worlds):
    for name, (n, *_) in _all_cases().items():
        for r in range(n):
            assert f"{name}:o" in worlds[n][r], (name, r)


# ------------------------------------------- the plain twins under B1

# mode -> (causal, causal_offset)
MODES = {"full": (False, 0), "causal": (True, 0), "strict": (True, -1)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_plain_twins_with_separate_key_segments_match_jax(mode):
    """The three plain versions with seg_q != seg_k (packed query ids, the
    neighbour shard's key ids) and a key bias == the reference's ``_fwd``
    and ``_bwd`` given an outside delta, as a ring hop calls them."""
    causal, offset = MODES[mode]
    b, t, h, d = 2, 40, 2, 16
    g = np.random.default_rng(7 + offset)
    q, k, v, do = (g.standard_normal((b * h, t, d)).astype(np.float32)
                   for _ in range(4))
    bias = np.where(g.random((b, t)) > 0.2, 0.0, -1e30).astype(np.float32)
    seg_q = np.sort(g.integers(0, 3, (b, t)), axis=1).astype(np.int32)
    seg_k = np.sort(g.integers(1, 4, (b, t)), axis=1).astype(np.int32)
    scale = d ** -0.5
    o_j, lse_j = jfwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(bias[..., None]),
                      jnp.asarray(seg_q[..., None]),
                      jnp.asarray(seg_k[..., None]), h, scale, causal, 16,
                      16, offset=offset)
    delta = (do * np.asarray(o_j)).sum(-1, keepdims=True)
    dq_j, dk_j, dv_j, db_j = jbwd(
        h, scale, causal, 16, 16,
        (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
         jnp.asarray(bias[..., None]), jnp.asarray(seg_q[..., None]),
         jnp.asarray(seg_k[..., None]), o_j, lse_j), jnp.asarray(do),
        delta=jnp.asarray(delta), offset=offset)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    tb, sq, sk = torch.tensor(bias), torch.tensor(seg_q), torch.tensor(seg_k)
    o, lse = pfa.flash_fwd(tq, tk, tv, tb, sq, sk, h, scale, causal, offset,
                           block_q=16, block_k=16)
    lse_w = np.asarray(lse_j)[..., 0]
    live = lse_w > -1e29
    np.testing.assert_array_equal(lse.numpy() > -1e29, live)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy()[live], lse_w[live], **TOL)
    lse_t = torch.tensor(lse_w)
    tdelta = torch.tensor(delta[..., 0])
    dq = pfa.flash_bwd_dq(tq, tk, tv, tb, sq, sk, tdo, lse_t, tdelta, h,
                          scale, causal, offset, block_q=16, block_k=16)
    dk, dv, db = pfa.flash_bwd_dkv(tq, tk, tv, tb, sq, sk, tdo, lse_t,
                                   tdelta, h, scale, causal, offset,
                                   block_q=16, block_k=16)
    for name, got, want in (("dq", dq, dq_j), ("dk", dk, dk_j),
                            ("dv", dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(db.view(b, h, t).sum(1).numpy(),
                               np.asarray(db_j)[..., 0], **TOL)
    # The keys' own ids matter: the queries' ids in their place differ.
    o_same, _ = pfa.flash_fwd(tq, tk, tv, tb, sq, sq, h, scale, causal,
                              offset, block_q=16, block_k=16)
    assert not np.allclose(o_same.numpy(), np.asarray(o_j), **TOL)


def test_segment_ids_come_in_pairs():
    x = torch.zeros(2, 8, 8)
    seg = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="together or not at all"):
        pfa.flash_fwd(x, x, x, None, seg, None, 1, 1.0, False)
    with pytest.raises(ValueError, match=r"seg_q must be \(B, Tq\)"):
        pfa.flash_fwd(x, x, x, None, seg, seg[:, :4], 1, 1.0, False)
