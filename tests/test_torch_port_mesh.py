"""horovod_tpu_torch's named meshes (``parallel/mesh.py``, ``HOROVOD_MESH``)
== horovod_tpu's.

In one process: ``parse_mesh`` / ``format_mesh``, ``validate_mesh`` (with
topologies), ``make_mesh``'s errors (two ``-1`` axes, an axis that cannot
be inferred, a mesh that needs more devices), ``parse_topology``,
``detect_topology``'s override and ``torus_groups`` give the reference's
values and messages, and a ``HOROVOD_MESH`` that does not factor the
world raises at ``init`` with the reference's message.

On a spawned four-rank gloo world: ``make_mesh2d(2, 2)``, ``make_mesh``
with an inferred axis and ``make_mesh`` over a permuted rank order lay the
ranks out as the reference lays out devices 0-3 of its CPU mesh
(``mesh.devices``), and each rank's process set along every axis is the
row or column of that array holding it: the orientation trap (rank r sits
at dp = r // mp, mp = r % mp; swapped sets still run every collective). A
Sum over each rank's set along every axis (one-rank lines included: they
get a group of their own) equals the sum over that line. ``HOROVOD_MESH=dp2xmp2`` gives the reference's ``mesh_spec``,
``dp_size``, ``mp_size``, ``dp_rank``, ``mp_rank`` and
``config_mesh_dp`` / ``config_mesh_mp`` gauges on four devices, and an
elastic re-init without it gives dp4xmp1 with no stale gauge. All
comparisons are exact.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu import metrics as jmetrics
from horovod_tpu.parallel import mesh as jmesh

from horovod_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (axes, device order) of the meshes the four-rank world builds.
MESHES = {
    "mesh2d": ({"dp": 2, "mp": 2}, [0, 1, 2, 3]),
    "inferred": ({"a": -1, "b": 2}, [0, 1, 2, 3]),
    "permuted": ({"x": 2, "y": 2}, [3, 1, 0, 2]),
    "line": ({"dp": 1, "mp": 4}, [0, 1, 2, 3]),
}


def _raises(fn, *a, **kw):
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return str(e.value)


@pytest.mark.parametrize("spec", ["dp2xmp4", " DP1xMP8 ", "dp8xmp1"])
def test_parse_and_format_as_reference(spec):
    assert pmesh.parse_mesh(spec) == jmesh.parse_mesh(spec)
    assert pmesh.format_mesh(*pmesh.parse_mesh(spec)) == \
        jmesh.format_mesh(*jmesh.parse_mesh(spec))


@pytest.mark.parametrize("bad", ["", "dp2", "mp2xdp2", "dp0xmp2",
                                 "dpxmp2", "dp2xmp2x"])
def test_parse_rejects_as_reference(bad):
    assert _raises(pmesh.parse_mesh, bad) == _raises(jmesh.parse_mesh, bad)


@pytest.mark.parametrize("dp,mp,world,topo", [
    (2, 4, 8, None), (4, 2, 8, (2, 4)), (2, 4, 8, (2, 4)),
    (1, 8, 8, (2, 4)), (8, 1, 8, (2, 2, 2)), (2, 2, 4, (4,))])
def test_validate_accepts_as_reference(dp, mp, world, topo):
    assert pmesh.validate_mesh(dp, mp, world, topo) == \
        jmesh.validate_mesh(dp, mp, world, topo) == (dp, mp)


@pytest.mark.parametrize("dp,mp,world,topo", [
    (2, 2, 8, None), (3, 1, 4, None), (4, 3, 12, (3, 4)),
    (2, 6, 12, (3, 4))])
def test_validate_rejects_as_reference(dp, mp, world, topo):
    assert _raises(pmesh.validate_mesh, dp, mp, world, topo) == \
        _raises(jmesh.validate_mesh, dp, mp, world, topo)


@pytest.mark.parametrize("axes,count", [
    ({"a": -1, "b": -1}, 4), ({"a": 3, "b": -1}, 4), ({"a": 2, "b": 4}, 4),
    ({"a": 4}, 2)])
def test_make_mesh_errors_as_reference(axes, count):
    got = _raises(pmesh.make_mesh, dict(axes), devices=list(range(count)))
    want = _raises(jmesh.make_mesh, dict(axes),
                   devices=jax.devices()[:count])
    assert got == want


@pytest.mark.parametrize("dims", [(2, 2), (4, 2), (2, 2, 2), (8,), (2, 3)])
def test_torus_groups_as_reference(dims):
    assert pmesh.torus_groups(dims) == jmesh.torus_groups(dims)


@pytest.mark.parametrize("spec,world", [("2x2", 4), ("4x2", 8), ("8", 8)])
def test_topology_override_as_reference(spec, world):
    assert pmesh.parse_topology(spec) == jmesh.parse_topology(spec)
    assert pmesh.detect_topology(world, override=spec) == \
        jmesh.detect_topology(world, override=spec)


def test_mesh_that_does_not_factor_the_world_raises_at_init(monkeypatch):
    import horovod_tpu_torch as hvd
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_SIZE",
              "MASTER_ADDR", "MASTER_PORT", "HOROVOD_TOPOLOGY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_MESH", "dp2xmp1")
    with pytest.raises(ValueError) as got:
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    assert str(got.value) == _raises(jmesh.validate_mesh, 2, 1, 1, (1,))
    monkeypatch.setenv("HOROVOD_MESH", "dp1xmp2x")
    with pytest.raises(ValueError, match="invalid HOROVOD_MESH"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


_WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, sys.argv[1])
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import collective as C
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.parallel import mesh as pmesh

    MESHES = json.loads(sys.argv[3])
    out = {}

    def gauges():
        g = metrics.snapshot()["gauges"]
        return {k: g[k][0]["value"] for k in ("config_mesh_dp",
                                              "config_mesh_mp")}

    def accessors():
        return dict(spec=hvd.mesh_spec(), dp_size=hvd.dp_size(),
                    mp_size=hvd.mp_size(), dp_rank=hvd.dp_rank(),
                    mp_rank=hvd.mp_rank(), gauges=gauges(),
                    mesh2d=hvd.mesh2d().devices.tolist())

    os.environ["HOROVOD_MESH"] = "dp2xmp2"
    hvd.init(device="cpu")
    r = hvd.rank()
    out["env"] = accessors()
    for name, (axes, devs) in MESHES.items():
        m = pmesh.make_mesh(axes, devices=devs) if name != "mesh2d" else \\
            pmesh.make_mesh2d(2, 2)
        row = {"devices": m.devices.tolist(), "shape": m.shape,
               "names": list(m.axis_names), "sets": {}, "sums": {}}
        for ax in m.axis_names:
            ps = m.process_set(ax)
            row["sets"][ax] = sorted(ps.ranks) if ps.ranks is not None \\
                else list(range(hvd.size()))
            row["sums"][ax] = C._in_step_allreduce(
                torch.tensor([float(r + 1)]), C.Sum, ps).item()
        out[name] = row
    # The env mesh's sets are the mesh2d sets.
    out["env_sets"] = {ax: sorted(hvd.mesh2d().process_set(ax).ranks)
                       for ax in ("dp", "mp")}
    # The re-init rendezvous on a fresh port (the old store keeps the old
    # world's addresses).
    def free_port():
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    port = C.broadcast_object(free_port() if r == 0 else None, 0)
    hvd.shutdown()
    os.environ["MASTER_PORT"] = str(port)
    del os.environ["HOROVOD_MESH"]
    hvd.init(device="cpu")
    out["reinit"] = accessors()
    hvd.shutdown()
    with open(sys.argv[2] + f".rank{r}.json", "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "HOROVOD_MESH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "4",
         "--timeout", "240", str(script), REPO, str(tmp / "out"),
         json.dumps(MESHES)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.load(open(tmp / f"out.rank{r}.json")) for r in range(4)]


def _reference_mesh(name):
    axes, devs = MESHES[name]
    if name == "mesh2d":
        return jmesh.make_mesh2d(2, 2, jax.devices()[:4])
    return jmesh.make_mesh(dict(axes), [jax.devices()[i] for i in devs])


@pytest.mark.parametrize("name", list(MESHES))
def test_rank_layout_is_the_reference_device_layout(world, name):
    ref = _reference_mesh(name)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for out in world:
        got = out[name]
        assert got["devices"] == ids.tolist()
        assert got["names"] == list(ref.axis_names)
        assert got["shape"] == dict(ref.shape)


@pytest.mark.parametrize("name", list(MESHES))
def test_each_ranks_sets_are_its_rows_and_columns(world, name):
    """The orientation trap: rank r's set along an axis is the line of
    the reference's device array through r along that axis."""
    ref = _reference_mesh(name)
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    for r, out in enumerate(world):
        at = [int(i) for i in np.argwhere(ids == r)[0]]
        for j, ax in enumerate(ref.axis_names):
            idx = list(at)
            idx[j] = slice(None)
            line = sorted(int(x) for x in ids[tuple(idx)].ravel())
            assert out[name]["sets"][ax] == line, (r, ax)
            assert out[name]["sums"][ax] == float(sum(x + 1 for x in line))


def test_mesh2d_orientation_pinned():
    """dp = r // mp, mp = r % mp: the mp sets are contiguous runs."""
    ref = jmesh.make_mesh2d(2, 2, jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    assert ids.tolist() == [[0, 1], [2, 3]]
    assert ref.axis_names == ("dp", "mp")


def _reference_env(spec):
    old = os.environ.get("HOROVOD_MESH")
    os.environ["HOROVOD_MESH"] = spec
    try:
        jhvd.init(devices=jax.devices()[:4])
        snap = jmetrics.snapshot()["gauges"]
        return dict(spec=jhvd.mesh_spec(), dp_size=jhvd.dp_size(),
                    mp_size=jhvd.mp_size(),
                    gauges={k: snap[k][0]["value"]
                            for k in ("config_mesh_dp", "config_mesh_mp")},
                    mesh2d=np.vectorize(lambda d: d.id)(
                        jhvd.mesh2d().devices).tolist())
    finally:
        if old is None:
            del os.environ["HOROVOD_MESH"]
        else:
            os.environ["HOROVOD_MESH"] = old
        jhvd.init()


@pytest.mark.parametrize("key,spec", [("env", "dp2xmp2"),
                                      ("reinit", "dp4xmp1")])
def test_horovod_mesh_accessors_and_gauges_as_reference(world, key, spec):
    ref = _reference_env(spec)
    dp, mp = jmesh.parse_mesh(spec)
    for r, out in enumerate(world):
        got = out[key]
        assert got["spec"] == ref["spec"] == spec
        assert (got["dp_size"], got["mp_size"]) == (ref["dp_size"],
                                                    ref["mp_size"])
        assert got["gauges"] == ref["gauges"]
        assert got["mesh2d"] == ref["mesh2d"]
        # The reference's host-side coordinates of device r.
        assert (got["dp_rank"], got["mp_rank"]) == (r // mp, r % mp)


def test_env_mesh_sets_are_mesh2d_rows_and_columns(world):
    for r, out in enumerate(world):
        assert out["env_sets"]["mp"] == [r // 2 * 2, r // 2 * 2 + 1]
        assert out["env_sets"]["dp"] == [r % 2, r % 2 + 2]
