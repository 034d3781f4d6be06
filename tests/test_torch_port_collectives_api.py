"""The rest of Horovod's eager collective API in horovod_tpu_torch ==
horovod_tpu's eager results.

Two spawned gloo worlds of the port (``python -m horovod_tpu_torch.runner``):
two ranks for reducescatter, alltoall (even and with splits), ragged and
grouped allgather, grouped reducescatter, allgather_object, the in-place
and async forms (handles synchronized out of issue order, ``poll``), and
three ranks for a subset process set {0, 2}. The JAX package computes the
same collectives eagerly under its ``tensor[r]`` = rank r convention over a
process set of the same ranks of the 8-device CPU mesh, so both reduce the
same values; rows of ranks outside the set give what the reference gives
them. Integer and fp32 data: results agree exactly, or to 1e-6 where a sum
is divided.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

import horovod_tpu as jhvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)
SUM, AVERAGE = 1, 0

# Rows sent by each rank of the two-rank world with splits, per member.
SPLITS = [[1, 3], [2, 0]]
# Rows of each rank's tensor for ragged_allgather.
RAGGED_ROWS = [3, 1, 2]


def _inputs():
    g = np.random.default_rng(21)
    return {
        "x": g.standard_normal((3, 4, 3)).astype(np.float32),
        "xi": g.integers(-20, 20, (3, 6, 2)).astype(np.int32),
        "g0": g.standard_normal((3, 2, 5)).astype(np.float32),
        "g1": g.standard_normal((3, 6)).astype(np.float32),
        "s0": g.standard_normal((3, 4, 2)).astype(np.float32),
        "s1": g.standard_normal((3, 2)).astype(np.float32),
        "a2a": g.standard_normal((3, 4, 2)).astype(np.float32),
        "ragged": g.standard_normal((3, 3, 2)).astype(np.float32),
    }


_WORKER = textwrap.dedent("""
    import sys, time
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    data = {k: torch.tensor(v[r]) for k, v in np.load(sys.argv[2]).items()}
    splits = [[1, 3], [2, 0]]
    ragged_rows = [3, 1, 2]
    out = {}
    x = data["x"]

    def flag(name, ok):
        out["flag:" + name] = torch.tensor(bool(ok))

    def raises(exc, fn):
        try:
            fn()
        except exc:
            return True
        return False

    if n == 2:
        for name, op in (("sum", hvd.Sum), ("average", hvd.Average)):
            out["rs_" + name] = hvd.reducescatter(x, op=op)
            out["grs_" + name + "_0"], out["grs_" + name + "_1"] = \\
                hvd.grouped_reducescatter([data["s0"], data["s1"]], op=op)
        out["rs_int"] = hvd.reducescatter(data["xi"], op=hvd.Average)
        out["a2a"] = hvd.alltoall(data["a2a"])
        rows = data["a2a"][:sum(splits[r])]
        recv, rsplits = hvd.alltoall(rows, splits=splits[r])
        out["a2a_splits"], out["a2a_rsplits"] = recv, rsplits
        out["a2a_splits_tensor"], _ = hvd.alltoall(
            rows, splits=torch.tensor(splits[r]))
        out["ragged"] = hvd.ragged_allgather(
            data["ragged"][:ragged_rows[r]])
        out["gag_0"], out["gag_1"] = hvd.grouped_allgather(
            [data["g0"], data["g1"]])
        objs = hvd.allgather_object({"rank": r, "tag": "x" * (r + 1)})
        flag("allgather_object", objs == [{"rank": 0, "tag": "x"},
                                          {"rank": 1, "tag": "xx"}])
        y = x.clone()
        res = hvd.allreduce_(y, op=hvd.Sum)
        flag("allreduce_inplace", res is y)
        out["allreduce_"] = y

        # Async: every form issued, then synchronized in reverse order.
        z, b = x.clone(), x.clone()
        handles = {
            "h_allreduce": hvd.allreduce_async(x, op=hvd.Average),
            "h_allreduce_": hvd.allreduce_async_(z, op=hvd.Sum),
            "h_grouped_allreduce": hvd.grouped_allreduce_async(
                [data["g0"], data["g1"]], op=hvd.Sum),
            "h_allgather": hvd.allgather_async(x),
            "h_broadcast": hvd.broadcast_async(x, 1),
            "h_broadcast_": hvd.broadcast_async_(b, 1),
            "h_alltoall": hvd.alltoall_async(data["a2a"]),
            "h_alltoall_splits": hvd.alltoall_async(rows, splits[r]),
            "h_reducescatter": hvd.reducescatter_async(x, op=hvd.Sum),
            "h_grouped_allgather": hvd.grouped_allgather_async(
                [data["g0"], data["g1"]]),
            "h_grouped_reducescatter": hvd.grouped_reducescatter_async(
                [data["s0"], data["s1"]], op=hvd.Average),
        }
        h = handles["h_allreduce"]
        deadline = time.monotonic() + 60
        while not hvd.poll(h) and time.monotonic() < deadline:
            time.sleep(0.001)
        flag("poll_turns_true", hvd.poll(h))
        for name in reversed(list(handles)):
            res = hvd.synchronize(handles[name])
            if isinstance(res, tuple):
                out[name], out[name + "_rsplits"] = res
            elif isinstance(res, list):
                for i, t in enumerate(res):
                    out[f"{name}_{i}"] = t
            else:
                out[name] = res
        flag("async_inplace", handles["h_allreduce_"].synchronize() is z
             and handles["h_broadcast_"].synchronize() is b)
        flag("poll_after_sync", all(h.poll() for h in handles.values()))
        flag("errors", all([
            raises(ValueError, lambda: hvd.reducescatter(x, op=hvd.Min)),
            raises(ValueError, lambda: hvd.reducescatter(x[:3])),
            raises(ValueError, lambda: hvd.alltoall(x[:3])),
            raises(ValueError, lambda: hvd.alltoall(rows, splits=[1])),
            raises(ValueError, lambda: hvd.alltoall(rows, splits=[9, 9])),
        ]))
    else:
        ps = hvd.add_process_set([2, 0])
        member = r in (0, 2)
        flag("ids", hvd.get_process_set_ids_and_ranks() == {0: None,
                                                            1: [0, 2]})
        flag("included", ps.included() == member and ps.size() == 2)
        flag("set_rank", ps.rank() == {0: 0, 2: 1}[r] if member
             else raises(ValueError, ps.rank))
        out["sub_allreduce"] = hvd.allreduce(x, op=hvd.Sum, process_set=ps)
        out["sub_allgather"] = hvd.allgather(x, process_set=ps)
        out["sub_broadcast"] = hvd.broadcast(x, 2, process_set=ps)
        out["sub_alltoall"] = hvd.alltoall(x, process_set=ps)
        out["sub_reducescatter"] = hvd.reducescatter(x, op=hvd.Sum,
                                                     process_set=ps)
        sp = {0: [1, 2], 2: [3, 0]}.get(r, [0, 0])
        recv, rsplits = hvd.alltoall(data["a2a"][:sum(sp)], splits=sp,
                                     process_set=ps)
        out["sub_a2a_splits"], out["sub_a2a_rsplits"] = recv, rsplits
        out["sub_ragged"] = hvd.ragged_allgather(
            data["ragged"][:ragged_rows[r]], process_set=ps)
        h = hvd.allreduce_async(x, op=hvd.Average, process_set=ps)
        out["sub_allreduce_async"] = hvd.synchronize(h)
        flag("broadcast_root_outside", raises(
            ValueError, lambda: hvd.broadcast(x, 1, process_set=ps)))
        hvd.barrier(process_set=ps)
        flag("remove", hvd.remove_process_set(ps)
             and not hvd.remove_process_set(hvd.global_process_set())
             and hvd.get_process_set_ids_and_ranks() == {0: None})
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.numpy() for k, v in out.items()})
    hvd.shutdown()
""")


def _world(tmp_path_factory, nranks):
    tmp = tmp_path_factory.mktemp(f"collectives_api_{nranks}")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, **_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
         str(nranks), "--timeout", "240", str(script), REPO, str(data),
         str(out)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return [dict(np.load(f"{out}.rank{i}.npz")) for i in range(nranks)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _world(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    return _world(tmp_path_factory, 3)


@pytest.fixture(scope="module")
def sets():
    pair, sub = jhvd.add_process_set([0, 1]), jhvd.add_process_set([0, 2])
    yield {"pair": pair, "sub": sub}
    jhvd.remove_process_set(pair)
    jhvd.remove_process_set(sub)


def _stack8(rows):
    """JAX eager input: row r is rank r's tensor; rows past the port's
    ranks belong to ranks outside every set."""
    pad = np.ones((8 - rows.shape[0],) + rows.shape[1:], rows.dtype)
    return jnp.asarray(np.concatenate([rows, pad]))


def _per_rank(arrs):
    """JAX eager per-rank list: the port's ranks, then padding ranks."""
    return list(arrs) + [np.zeros((1,) + arrs[0].shape[1:], arrs[0].dtype)
                         for _ in range(8 - len(arrs))]


def _check(got, want, n):
    want = np.asarray(want)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], err_msg=f"rank {r}",
                                   **TOL)


def _two(d, key):
    return d[key][:2]


@pytest.mark.parametrize("op", ["sum", "average"])
def test_reducescatter_matches_jax(two, sets, op):
    want = jhvd.reducescatter(_stack8(_two(_inputs(), "x")),
                              op=SUM if op == "sum" else AVERAGE,
                              process_set=sets["pair"])
    _check([two[r]["rs_" + op] for r in range(2)], want, 2)


def test_reducescatter_integer_average_floors(two, sets):
    xi = _two(_inputs(), "xi")
    for r in range(2):
        half = xi.sum(0)[3 * r:3 * r + 3]
        np.testing.assert_array_equal(two[r]["rs_int"], half // 2)


@pytest.mark.parametrize("op", ["sum", "average"])
def test_grouped_reducescatter_matches_jax(two, sets, op):
    d = _inputs()
    want = jhvd.grouped_reducescatter(
        [_stack8(_two(d, "s0")), _stack8(_two(d, "s1"))],
        op=SUM if op == "sum" else AVERAGE, process_set=sets["pair"])
    for i, w in enumerate(want):
        _check([two[r][f"grs_{op}_{i}"] for r in range(2)], w, 2)


def test_alltoall_even_matches_jax(two, sets):
    want = jhvd.alltoall(_stack8(_two(_inputs(), "a2a")),
                         process_set=sets["pair"])
    _check([two[r]["a2a"] for r in range(2)], want, 2)


def test_alltoall_with_splits_matches_jax(two, sets):
    a2a = _two(_inputs(), "a2a")
    rows = [a2a[r][:sum(SPLITS[r])] for r in range(2)]
    want = jhvd.alltoall(_per_rank(rows), splits=np.asarray(SPLITS),
                         process_set=sets["pair"])
    for r in range(2):
        np.testing.assert_array_equal(two[r]["a2a_splits"],
                                      np.asarray(want[r]))
        np.testing.assert_array_equal(two[r]["a2a_splits_tensor"],
                                      np.asarray(want[r]))
        np.testing.assert_array_equal(two[r]["a2a_rsplits"],
                                      [SPLITS[0][r], SPLITS[1][r]])


def test_ragged_allgather_matches_jax(two, sets):
    ragged = _two(_inputs(), "ragged")
    rows = [ragged[r][:RAGGED_ROWS[r]] for r in range(2)]
    want = np.asarray(jhvd.ragged_allgather(_per_rank(rows),
                                            process_set=sets["pair"]))
    assert want.shape[0] == RAGGED_ROWS[0] + RAGGED_ROWS[1]
    for r in range(2):
        np.testing.assert_array_equal(two[r]["ragged"], want)


def test_grouped_allgather_matches_jax(two, sets):
    d = _inputs()
    want = jhvd.grouped_allgather([_stack8(_two(d, "g0")),
                                   _stack8(_two(d, "g1"))],
                                  process_set=sets["pair"])
    for i, w in enumerate(want):
        _check([two[r][f"gag_{i}"] for r in range(2)], w, 2)


@pytest.mark.parametrize("name", ["allgather_object", "allreduce_inplace",
                                  "poll_turns_true", "async_inplace",
                                  "poll_after_sync", "errors"])
def test_two_rank_flags(two, name):
    for r in range(2):
        assert two[r]["flag:" + name] == 1, f"rank {r}"


def test_allreduce_inplace_matches_jax(two, sets):
    want = jhvd.allreduce(_stack8(_two(_inputs(), "x")), op=SUM,
                          process_set=sets["pair"])
    _check([two[r]["allreduce_"] for r in range(2)], want, 2)


def _async_refs(sets):
    """handle name -> the JAX package's eager result(s) for it."""
    d = _inputs()
    ps = sets["pair"]
    x, g0, g1 = (_stack8(_two(d, k)) for k in ("x", "g0", "g1"))
    s0, s1 = _stack8(_two(d, "s0")), _stack8(_two(d, "s1"))
    a2a = _two(d, "a2a")
    return {
        "h_allreduce": [jhvd.allreduce(x, op=AVERAGE, process_set=ps)],
        "h_allreduce_": [jhvd.allreduce(x, op=SUM, process_set=ps)],
        "h_grouped_allreduce": jhvd.grouped_allreduce([g0, g1], op=SUM,
                                                      process_set=ps),
        "h_allgather": [jhvd.allgather(x, process_set=ps)],
        "h_broadcast": [jhvd.broadcast(x, 1, process_set=ps)],
        "h_broadcast_": [jhvd.broadcast(x, 1, process_set=ps)],
        "h_alltoall": [jhvd.alltoall(_stack8(a2a), process_set=ps)],
        "h_reducescatter": [jhvd.reducescatter(x, op=SUM, process_set=ps)],
        "h_grouped_allgather": jhvd.grouped_allgather([g0, g1],
                                                      process_set=ps),
        "h_grouped_reducescatter": jhvd.grouped_reducescatter(
            [s0, s1], op=AVERAGE, process_set=ps),
    }


ASYNC = ["h_allreduce", "h_allreduce_", "h_grouped_allreduce",
         "h_allgather", "h_broadcast", "h_broadcast_", "h_alltoall",
         "h_reducescatter", "h_grouped_allgather",
         "h_grouped_reducescatter"]


@pytest.mark.parametrize("name", ASYNC)
def test_async_handle_matches_jax(two, sets, name):
    wants = _async_refs(sets)[name]
    for i, w in enumerate(wants):
        key = name if len(wants) == 1 and name in two[0] else f"{name}_{i}"
        _check([two[r][key] for r in range(2)], w, 2)


def test_async_alltoall_with_splits_matches_sync(two):
    for r in range(2):
        np.testing.assert_array_equal(two[r]["h_alltoall_splits"],
                                      two[r]["a2a_splits"])
        np.testing.assert_array_equal(two[r]["h_alltoall_splits_rsplits"],
                                      two[r]["a2a_rsplits"])


# ------------------------------------------------ subset set {0, 2} of 3

@pytest.mark.parametrize("name", ["ids", "included", "set_rank",
                                  "broadcast_root_outside", "remove"])
def test_subset_flags(three, name):
    for r in range(3):
        assert three[r]["flag:" + name] == 1, f"rank {r}"


def _three(d, key):
    return d[key][:3]


@pytest.mark.parametrize("kind", ["allreduce", "allgather", "broadcast",
                                  "alltoall", "reducescatter",
                                  "allreduce_async"])
def test_subset_collective_matches_jax(three, sets, kind):
    x = _stack8(_three(_inputs(), "x"))
    ps = sets["sub"]
    want = {
        "allreduce": lambda: jhvd.allreduce(x, op=SUM, process_set=ps),
        "allgather": lambda: jhvd.allgather(x, process_set=ps),
        "broadcast": lambda: jhvd.broadcast(x, 2, process_set=ps),
        "alltoall": lambda: jhvd.alltoall(x, process_set=ps),
        "reducescatter": lambda: jhvd.reducescatter(x, op=SUM,
                                                    process_set=ps),
        "allreduce_async": lambda: jhvd.allreduce(x, op=AVERAGE,
                                                  process_set=ps),
    }[kind]()
    # Row 1 is the rank outside the set: its own tensor, or zeros.
    _check([three[r]["sub_" + kind] for r in range(3)], want, 3)


def test_subset_alltoall_with_splits_matches_jax(three, sets):
    a2a = _three(_inputs(), "a2a")
    sp = [[1, 2], [3, 0]]                 # members 0 and 2, set order
    rows = [a2a[0][:3], a2a[1][:0], a2a[2][:3]]
    want = jhvd.alltoall(_per_rank(rows), splits=np.asarray(sp),
                         process_set=sets["sub"])
    assert want[1] is None
    for r, j in ((0, 0), (2, 1)):
        np.testing.assert_array_equal(three[r]["sub_a2a_splits"],
                                      np.asarray(want[r]))
        np.testing.assert_array_equal(three[r]["sub_a2a_rsplits"],
                                      [sp[0][j], sp[1][j]])
    # The rank outside the set: no rows, zero splits (the reference's
    # torch frontend gives the same).
    assert three[1]["sub_a2a_splits"].shape == (0, 2)
    np.testing.assert_array_equal(three[1]["sub_a2a_rsplits"], [0, 0])


def test_subset_ragged_allgather_matches_jax(three, sets):
    ragged = _three(_inputs(), "ragged")
    rows = [ragged[r][:RAGGED_ROWS[r]] for r in range(3)]
    want = np.asarray(jhvd.ragged_allgather(_per_rank(rows),
                                            process_set=sets["sub"]))
    assert want.shape[0] == RAGGED_ROWS[0] + RAGGED_ROWS[2]
    for r in (0, 2):
        np.testing.assert_array_equal(three[r]["sub_ragged"], want)
    # Outside the set: zero rows (the members' rows never reach it).
    assert three[1]["sub_ragged"].shape == (0, 2)
