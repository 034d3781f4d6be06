"""horovod_tpu_torch's sharding rules (``parallel/sharding.py``) ==
horovod_tpu's.

In one process: ``PartitionRules`` (first match wins, replication by
default) and ``apply_rules`` over a tree of nested dicts and a list give
the reference's spec for every leaf path ("a/b/0/c").

On a spawned four-rank gloo world, ``shard_pytree`` of the same seeded
leaves over three meshes (``make_mesh2d(2, 2)``, ``make_mesh({"a": 4})``
and ``make_mesh({"x": 2, "y": 2})`` over a permuted rank order), with
specs that split one dim, two dims, one dim over two axes and none
("b", the second axis, is no axis on the flat mesh), gives
on rank r exactly the data of the reference's shard on device r of the
same mesh over devices 0-3 of its CPU mesh. A dim that does not split
evenly raises.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import sharding as jsharding

from horovod_tpu_torch.parallel import sharding as psharding
from horovod_tpu_torch.parallel.sharding import P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (pattern, spec entries) in order: "a" names the first mesh axis, "b" the
# second; the worker and the reference substitute each mesh's axis names.
RULES = [("attn/qkv", ("b", None)), ("mlp/.*/w", (None, "b")),
         ("both", ("a", "b")), ("joint", (("a", "b"),)),
         ("attn", ("a",))]
SHAPES = {"attn/qkv/w": (8, 6), "attn/out/w": (4, 6),
          "mlp/fc/w": (6, 8), "mlp/fc/b": (8,), "both": (4, 6),
          "joint": (8, 3), "ln/scale": (6,)}
MESHES = {"mesh2d": (("dp", "mp"), (2, 2), [0, 1, 2, 3]),
          "flat": (("a",), (4,), [0, 1, 2, 3]),
          "permuted": (("x", "y"), (2, 2), [3, 1, 0, 2])}


def _nest(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _leaves():
    g = np.random.default_rng(5)
    return {k: g.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _rules(names, spec_cls):
    def sub(e):
        if e is None:
            return None
        if isinstance(e, tuple):
            axes = tuple(x for x in map(sub, e) if x is not None)
            return axes or None
        return {"a": names[0], "b": names[1] if len(names) > 1 else None}[e]
    return [(pat, spec_cls(*[sub(e) for e in spec]))
            for pat, spec in RULES]


def test_first_match_wins_and_default_replicates():
    for cls, mod in ((P, psharding), (JP, jsharding)):
        rules = mod.PartitionRules([("w", cls("x")), ("w$", cls(None, "y"))])
        assert tuple(rules.spec_for("a/w")) == ("x",)
        assert tuple(rules.spec_for("ln/scale")) == ()
        assert rules.spec_for("ln/scale") == cls()


def test_apply_rules_paths_as_reference():
    tree = _nest({k: np.zeros(s, np.float32) for k, s in SHAPES.items()})
    tree["layers"] = [{"attn": np.zeros(2)}, {"w": np.zeros(2)}]
    got = psharding.apply_rules(tree, psharding.PartitionRules(
        _rules(("dp", "mp"), P) + [("layers/1", P("dp"))]))
    want = jsharding.apply_rules(tree, jsharding.PartitionRules(
        _rules(("dp", "mp"), JP) + [("layers/1", JP("dp"))]))
    flat_got = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, P))
    flat_want = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, JP))
    assert [tuple(x) for x in flat_got] == [tuple(x) for x in flat_want]
    assert got["layers"][1]["w"] == P("dp")
    assert got["attn"]["qkv"]["w"] == P("mp", None)


_WORKER = textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import mesh as pmesh
    from horovod_tpu_torch.parallel import sharding as S

    RULES = json.loads(sys.argv[3])
    MESHES = json.loads(sys.argv[4])
    hvd.init(device="cpu")
    r = hvd.rank()
    d = np.load(sys.argv[2] + ".in.npz")

    def rules(names):
        def sub(e):
            if e is None:
                return None
            if isinstance(e, list):
                axes = tuple(x for x in map(sub, e) if x is not None)
                return axes or None
            return {"a": names[0],
                    "b": names[1] if len(names) > 1 else None}[e]
        return S.PartitionRules([(p, S.P(*[sub(e) for e in spec]))
                                 for p, spec in RULES])

    def nest(flat):
        out = {}
        for key, v in flat.items():
            *path, leaf = key.split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return out

    out, info = {}, {}
    tree = nest({k: torch.from_numpy(d[k]) for k in d.files})
    for name, (names, sizes, devs) in MESHES.items():
        m = pmesh.make_mesh(dict(zip(names, sizes)), devices=devs)
        blocks = S.shard_pytree(tree, m, rules(names))

        def walk(t, prefix=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from walk(v, prefix + k + "/")
                else:
                    yield prefix + k, v
        for k, v in walk(blocks):
            out[name + ":" + k] = v.numpy()
    try:
        S.shard_pytree({"w": torch.zeros(3, 2)},
                       pmesh.make_mesh({"a": 4}), S.PartitionRules(
                           [("w", S.P("a"))]))
    except ValueError as e:
        info["uneven"] = str(e)
    np.savez(sys.argv[2] + f".rank{r}.npz", **out)
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(info, f)
    hvd.shutdown()
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharding")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    np.savez(tmp / "out.in.npz", **_leaves())
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
         "--timeout", "240", str(script), REPO, str(tmp / "out"),
         json.dumps(RULES), json.dumps(MESHES)], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return [(dict(np.load(tmp / f"out.rank{r}.npz")),
             json.load(open(tmp / f"out.rank{r}.json"))) for r in range(4)]


@pytest.mark.parametrize("name", list(MESHES))
def test_local_block_is_the_reference_shard_of_the_rank(world, name):
    names, sizes, devs = MESHES[name]
    mesh = jmesh.make_mesh(dict(zip(names, sizes)),
                           [jax.devices()[i] for i in devs])
    leaves = _leaves()
    tree = _nest({k: jax.numpy.asarray(v) for k, v in leaves.items()})
    sharded = jsharding.shard_pytree(tree, mesh, jsharding.PartitionRules(
        _rules(names, JP)))
    for key in SHAPES:
        arr = sharded
        for p in key.split("/"):
            arr = arr[p]
        by_device = {s.device.id: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for r, (res, _) in enumerate(world):
            np.testing.assert_array_equal(res[f"{name}:{key}"], by_device[r],
                                          err_msg=f"{name} {key} rank {r}")


def test_uneven_split_raises(world):
    for _, info in world:
        assert "does not split evenly" in info["uneven"]
