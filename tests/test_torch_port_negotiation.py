"""horovod_tpu_torch's negotiation and eager join == horovod_tpu's.

In one process, every case of ``tests/test_negotiation.py`` runs against the
port with the same two-process harness: the port's world of one rank is told
it has two (``core.size``/``core.rank`` patched, as the reference's test
patches ``jax.process_count``/``process_index``), and the host round and the
object round return this rank's row with a peer's. The same sequence of
``_negotiate(kind, sig_key)`` calls must hand ``_host_allgather_i32`` the
same int32 rows in both packages (the clock is frozen, so the piggybacked
wait is 0 on both), and ``_harvest_arrivals`` must give the same records
from the same rows.

A spawned two-rank gloo world (``python -m horovod_tpu_torch.runner``) runs
the reference's ``join`` and ``join_service`` scenarios
(``tests/test_multiprocess.py``) with the reference's expected values, an
Adasum and an integer-Average case while a rank is joined, an op a joined
rank cannot service, a mismatch that raises on both ranks, and per-rank
timeline shards (``HOROVOD_TIMELINE``) whose op ids line up.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import collective as JC
from horovod_tpu_torch import collective as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADASUM_TOL = dict(rtol=1e-4, atol=1e-5)      # the reference's Adasum tests'


@pytest.fixture(autouse=True)
def _port_world():
    hvd.init(device="cpu")
    C._reset_negotiation()
    yield
    C._reset_negotiation()
    hvd.shutdown()


def _patch_two_process(monkeypatch, hash_rows=None, peer_sigs=None):
    """The port told it is rank 0 of two: the i32 round returns [mine,
    peer] (peer row from hash_rows or identical), the object round returns
    [mine, peer_sig]."""
    monkeypatch.setattr(C._core, "size", lambda: 2)
    monkeypatch.setattr(C._core, "rank", lambda: 0)
    return _patch_rounds(monkeypatch, C, hash_rows, peer_sigs)


def _patch_rounds(monkeypatch, module, hash_rows=None, peer_sigs=None):
    i32_calls, obj_calls = [], []

    def fake_i32(vec):
        i32_calls.append(np.asarray(vec).copy())
        peer = hash_rows.pop(0) if hash_rows else np.asarray(vec)
        return np.stack([np.asarray(vec), np.asarray(peer)])

    def fake_obj(obj, *args, **kwargs):
        obj_calls.append(obj)
        peer = peer_sigs.pop(0) if peer_sigs else obj
        if isinstance(peer, str):      # shorthand: a peer signature string
            peer = ("active", peer, None)
        return [obj, peer]

    monkeypatch.setattr(module, "_host_allgather_i32", fake_i32)
    monkeypatch.setattr(module, "allgather_object", fake_obj)
    return i32_calls, obj_calls


def _x(*shape):
    return torch.tensor(np.random.default_rng(0).standard_normal(shape),
                        dtype=torch.float32)


# ------------------------------------------- tests/test_negotiation.py cases

def test_single_process_skips_negotiation(monkeypatch):
    calls = []
    monkeypatch.setattr(C, "_host_allgather_i32",
                        lambda v: calls.append(v) or np.asarray([v]))
    hvd.allreduce(_x(4))
    assert not calls   # a world of one rank: no negotiation traffic


def test_first_sighting_full_then_cached_fast_path(monkeypatch):
    i32_calls, obj_calls = _patch_two_process(monkeypatch)
    x = _x(4)
    hvd.allreduce(x)          # cache miss -> full content round
    hvd.allreduce(x + 1)      # same signature -> fast path
    hvd.allreduce(x - 1)
    assert C._NEG_STATS == {"full": 1, "fast": 2}
    assert len(i32_calls) == 3          # every call does the hash round
    assert len(obj_calls) == 1          # only the first does content
    assert obj_calls[0][0] == "active" and obj_calls[0][1].startswith("1|")
    assert obj_calls[0][2] is None      # no joined peer -> no descriptor


def test_distinct_signatures_each_do_full_once(monkeypatch):
    _, obj_calls = _patch_two_process(monkeypatch)
    x = _x(4)
    hvd.allreduce(x)
    hvd.allreduce(torch.cat([x, x]))          # different shape -> new sig
    hvd.allreduce(x)                          # cached again
    assert C._NEG_STATS == {"full": 2, "fast": 1}
    assert len(obj_calls) == 2


def test_peer_needs_full_forces_content_round(monkeypatch):
    x = _x(4)
    _patch_two_process(monkeypatch)
    hvd.allreduce(x)      # warm local cache (full round #1)

    def fake_i32(vec):
        peer = np.asarray(vec).copy()
        peer[4] = 1       # peer cache miss
        return np.stack([np.asarray(vec), peer])

    monkeypatch.setattr(C, "_host_allgather_i32", fake_i32)
    hvd.allreduce(x)
    assert C._NEG_STATS["full"] == 2


def test_mismatched_signatures_raise(monkeypatch):
    _patch_two_process(monkeypatch, peer_sigs=["1|allgather|other-op"])
    with pytest.raises(RuntimeError, match="mismatch across processes"):
        hvd.allreduce(_x(3))


def test_cached_divergence_caught_by_hash_round(monkeypatch):
    """Both signatures cached but the peer issues them in another order:
    the rolling hash differs at the next call and raises before any
    collective is issued."""
    x = _x(4)
    _patch_two_process(monkeypatch)
    hvd.allreduce(x)                          # warm cache sig A
    hvd.allreduce(torch.cat([x, x]))          # warm cache sig B
    issued = []
    monkeypatch.setattr(C, "_issue_reduce",
                        lambda *a: issued.append(a) or [])

    def fake_i32(vec):
        peer = np.asarray(vec).copy()
        peer[0] ^= 0x5A5A                     # peer history hash differs
        return np.stack([np.asarray(vec), peer])

    monkeypatch.setattr(C, "_host_allgather_i32", fake_i32)
    with pytest.raises(RuntimeError, match="hash diverged at op #3"):
        hvd.allreduce(x)
    assert not issued


def test_reinit_restarts_sequence(monkeypatch):
    _, obj_calls = _patch_two_process(monkeypatch)
    x = _x(4)
    hvd.allreduce(x)
    hvd.shutdown()
    hvd.init(device="cpu")  # history and response cache start over
    hvd.allreduce(x)
    assert len(obj_calls) == 2                  # cache was reset: full
    assert obj_calls[0][1].startswith("1|")
    assert obj_calls[1][1].startswith("1|")


def test_mismatch_error_lists_per_process_table(monkeypatch):
    _patch_two_process(monkeypatch, peer_sigs=["1|broadcast|x"])
    with pytest.raises(RuntimeError, match="process 1: 1\\|broadcast"):
        hvd.allreduce(_x(5))


def test_joined_peer_forces_full_round_and_ships_descriptor(monkeypatch):
    """A peer with the joined flag set makes the active side take the full
    object round even on a cache hit and attach the op descriptor."""
    x = _x(4)
    i32_calls, obj_calls = _patch_two_process(monkeypatch)
    hvd.allreduce(x)                   # warm cache (full round #1)
    assert obj_calls[-1][2] is None

    def fake_i32(vec):
        peer = np.asarray(vec).copy()
        peer[4] = 1                    # joined peers always flag need_full
        peer[5] = 1                    # ... and the joined bit
        return np.stack([np.asarray(vec), peer])

    monkeypatch.setattr(C, "_host_allgather_i32", fake_i32)
    joined = C._negotiate("allreduce", (("sig",), (0,)),
                          service_desc=("allreduce", (), 0, 1.0, 1.0,
                                        None, 1))
    assert joined == (1,)
    assert obj_calls[-1][0] == "active"
    assert obj_calls[-1][2] is not None     # descriptor shipped
    assert C._NEG_STATS["full"] >= 2
    # Through an eager op: the descriptor carries what the bucket plan
    # and the wire depend on.
    hvd.allreduce(x, op=hvd.Sum, fusion_threshold_bytes=512,
                  compression=hvd.Compression.fp16, prescale_factor=2.0)
    desc = obj_calls[-1][2]
    assert desc == ("allreduce", (((4,), "float32"),), hvd.Sum, 2.0, 1.0,
                    hvd.Compression.fp16, 512)


def test_neutral_host_elements():
    assert C._neutral_host(C.ReduceOp.Sum, torch.float32) == 0
    assert C._neutral_host(C.ReduceOp.Average, torch.float32) == 0
    assert C._neutral_host(C.ReduceOp.Adasum, torch.float32) == 0
    assert C._neutral_host(C.ReduceOp.Product, torch.float32) == 1
    assert C._neutral_host(C.ReduceOp.Min, torch.float32) == \
        np.finfo(np.float32).max
    assert C._neutral_host(C.ReduceOp.Max, torch.int32) == \
        np.iinfo(np.int32).min
    assert C._neutral_host(C.ReduceOp.Min, torch.bfloat16) == \
        float(jnp.finfo(jnp.bfloat16).max)
    assert C._neutral_host(C.ReduceOp.Max, torch.bfloat16) == \
        float(jnp.finfo(jnp.bfloat16).min)
    for op in (C.ReduceOp.Sum, C.ReduceOp.Min, C.ReduceOp.Max,
               C.ReduceOp.Product):
        for dt, jdt in ((torch.float32, np.float32), (torch.int32, np.int32),
                        (torch.bfloat16, jnp.bfloat16)):
            assert float(C._neutral_host(op, dt)) == float(
                JC._neutral_host(op, np.dtype(jdt))), (op, dt)
    with pytest.raises(RuntimeError, match="neutral"):
        C._neutral_host(999, torch.float32)


def test_join_avg_dtype_check():
    shapes_f = (((2, 4), "float32"),)
    shapes_i = (((2, 4), "int32"),)
    C._check_join_avg_dtypes(C.ReduceOp.Average, shapes_f)   # fine
    C._check_join_avg_dtypes(C.ReduceOp.Sum, shapes_i)       # Sum: fine
    with pytest.raises(RuntimeError, match="integer Average"):
        C._check_join_avg_dtypes(C.ReduceOp.Average, shapes_i)


def test_stall_report_is_empty_without_the_native_core():
    """The reference's native-coordinator case: its stall report is empty
    without the native core, and the port has none yet."""
    saved = JC._NEG_COORD
    JC._NEG_COORD = None
    try:
        assert JC.negotiation_stall_report(0.0) == []
    finally:
        JC._NEG_COORD = saved
    assert C.negotiation_stall_report(0.0) == []


# ------------------------------------------------ the same rows, byte for byte

SEQUENCES = {
    "repeat": [("allreduce", (((8, 4), "float32"), (0, (0, None))))] * 3,
    "mixed": [("allreduce", (((8, 4), "float32"),), (1, 1.0, 1.0)),
              ("broadcast", (((3,), "bfloat16"),), (0, (0, None))),
              ("allgather", (((2, 2), "int32"),), ((1, (0, 1)),)),
              ("allreduce", (((8, 4), "float32"),), (1, 1.0, 1.0))],
    "peer_missed": [("allreduce", (((5,), "float32"),), ()),
                    ("allreduce", (((5,), "float32"),), ())],
}
# Peer rows per sequence (None: identical to ours).
PEERS = {"peer_missed": [None, "need_full"]}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_negotiate_hands_the_reference_the_same_rows(monkeypatch, name):
    monkeypatch.setattr(time, "perf_counter", lambda: 0.0)
    monkeypatch.setattr(JC.jax, "process_count", lambda: 2)
    monkeypatch.setattr(JC.jax, "process_index", lambda: 0)
    JC._reset_negotiation()
    monkeypatch.setattr(JC, "_neg_coordinator", lambda: None)
    rows = {}
    for side, module in (("port", C), ("reference", JC)):
        if side == "port":
            monkeypatch.setattr(C._core, "size", lambda: 2)
            monkeypatch.setattr(C._core, "rank", lambda: 0)
        peers = []
        for p in PEERS.get(name, [None] * len(SEQUENCES[name])):
            peers.append(p)
        calls = []

        def fake_i32(vec, peers=peers, calls=calls):
            vec = np.asarray(vec).copy()
            calls.append(vec)
            peer = vec.copy()
            if peers and peers.pop(0) == "need_full":
                peer[4] = 1
            return np.stack([vec, peer])

        monkeypatch.setattr(module, "_host_allgather_i32", fake_i32)
        monkeypatch.setattr(module, "allgather_object",
                            lambda obj, *a, **k: [obj, obj])
        for kind, *key in SEQUENCES[name]:
            module._negotiate(kind, tuple(key))
        rows[side] = np.stack(calls)
        assert module.negotiation_stats() == (
            C if side == "port" else JC).negotiation_stats()
    JC._reset_negotiation()
    assert rows["port"].dtype == rows["reference"].dtype == np.int32
    np.testing.assert_array_equal(rows["port"], rows["reference"])


HARVEST = {
    "one_active": [[0, 0, 0, 0, 0, 0, 5, 3], [0, 0, 0, 0, 1, 1, 0, 0]],
    "first_round": [[0] * 8, [0] * 8],
    "incoherent": [[0, 0, 0, 0, 0, 0, 5, 3], [0, 0, 0, 0, 0, 0, 9, 4]],
    "noise": [[0, 0, 0, 0, 0, 0, 5, 3], [0, 0, 0, 0, 0, 0, 6, 3]],
    "straggler": [[0, 0, 0, 0, 0, 0, 250, 7], [0, 0, 0, 0, 0, 0, 1, 7],
                  [0, 0, 0, 0, 0, 0, 240, 7], [0, 0, 0, 0, 1, 1, 0, 0]],
}


@pytest.mark.parametrize("name", sorted(HARVEST))
def test_harvest_arrivals_matches_reference(name):
    rows = np.asarray(HARVEST[name], np.int32)
    JC._ARRIVALS.clear()
    C._harvest_arrivals(rows)
    JC._harvest_arrivals(rows)
    got = [{k: v for k, v in r.items() if k != "ts"}
           for r in C.negotiation_arrival_stats()]
    want = [{k: v for k, v in r.items() if k != "ts"}
            for r in JC.negotiation_arrival_stats()]
    JC._ARRIVALS.clear()
    assert got == want
    if name == "straggler":
        assert got[0]["late_processes"] == [1]


# ------------------------------------------------ a two-rank gloo world

_WORKER = textwrap.dedent("""
    import json, sys, time
    sys.path.insert(0, sys.argv[1])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    out, flags = {}, {}

    def expect_raise(tag, fn, *args, **kw):
        try:
            fn(*args, **kw)
            flags[tag] = "no error"
        except RuntimeError as e:
            flags[tag] = str(e)

    for i in range(2):                    # timeline ops on both ranks
        hvd.allreduce(torch.full((3,), float(r)), name=f"warm{i}")
    # the reference's join scenario: the later rank joins last
    if r == 1:
        time.sleep(1.0)
    flags["join_last"] = hvd.join()
    # the reference's join_service scenario
    steps = 3 if r == 0 else 6
    for step in range(steps):
        out[f"avg{step}"] = hvd.allreduce(
            torch.full((4,), float((r + 1) * (step + 1))))
    adasum_x = torch.tensor(np.load(sys.argv[2])["adasum"][r])
    if r == 1:
        out["sum"] = hvd.allreduce(torch.full((2,), 5.0), op=hvd.Sum)
        out["max"] = hvd.allreduce(torch.full((2,), -7.0), op=hvd.Max)
        out["min"] = hvd.allreduce(torch.full((2,), 3.0), op=hvd.Min)
        out["prod"] = hvd.allreduce(torch.full((2,), 3.0), op=hvd.Product)
        out["adasum"] = hvd.allreduce(adasum_x, op=hvd.Adasum,
                                      fusion_threshold_bytes=512)
        out["grouped"] = torch.cat([t.reshape(-1) for t in
                                    hvd.grouped_allreduce(
            [torch.full((3, 2), 4.0), torch.full((5,), 2.0).bfloat16()],
            compression=hvd.Compression.fp16)]).float()
        expect_raise("int_average", hvd.allreduce,
                     torch.arange(4, dtype=torch.int32))
        expect_raise("allgather", hvd.allgather, torch.ones(2))
        # Rank 0 re-entered join() after each error: join last by a margin
        # that no scheduling delay covers.
        time.sleep(0.5)
        flags["join_last_service"] = hvd.join()
    else:
        for tag in ("int_average", "allgather"):
            expect_raise(tag, hvd.join)
        flags["join_last_service"] = hvd.join()
    out["post_join"] = hvd.allreduce(torch.full((2,), float(r)))
    # a mismatch between active ranks raises on both
    if r == 0:
        expect_raise("mismatch", hvd.allreduce, torch.ones(3))
    else:
        expect_raise("mismatch", hvd.allgather, torch.ones(3))
    hvd.shutdown()
    np.savez(sys.argv[3] + f".rank{r}.npz",
             **{k: v.numpy() for k, v in out.items()})
    with open(sys.argv[3] + f".rank{r}.json", "w") as f:
        json.dump(flags, f)
""")


def _adasum_inputs():
    x = np.random.default_rng(5).standard_normal((2, 300)).astype(np.float32)
    x[0] = 0.0                           # rank 0 is joined: contributes 0
    return x


@pytest.fixture(scope="module")
def joined(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("join")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    data = tmp / "data.npz"
    np.savez(data, adasum=_adasum_inputs())
    out = tmp / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               HOROVOD_TIMELINE=str(tmp / "trace.json"))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
         "--timeout", "240", str(script), REPO, str(data), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = []
    for i in range(2):
        with open(f"{out}.rank{i}.json") as f:
            flags = json.load(f)
        with open(tmp / f"trace.rank{i}.json") as f:
            trace = json.load(f)
        ranks.append((dict(np.load(f"{out}.rank{i}.npz")), flags, trace))
    return ranks


def test_join_returns_the_last_joiner(joined):
    for _, flags, _ in joined:
        assert flags["join_last"] == 1
        assert flags["join_last_service"] == 1


@pytest.mark.parametrize("step", range(6))
def test_join_service_averages_over_the_active_ranks(joined, step):
    want = 1.5 * (step + 1) if step < 3 else 2.0 * (step + 1)
    for r, (out, _, _) in enumerate(joined):
        if r == 1 or step < 3:
            np.testing.assert_array_equal(out[f"avg{step}"],
                                          np.full(4, want, np.float32))


@pytest.mark.parametrize("name,want", [("sum", 5.0), ("max", -7.0),
                                       ("min", 3.0), ("prod", 3.0)])
def test_joined_rank_contributes_the_neutral_element(joined, name, want):
    np.testing.assert_array_equal(joined[1][0][name],
                                  np.full(2, want, np.float32))


def test_joined_rank_services_a_grouped_compressed_allreduce(joined):
    np.testing.assert_array_equal(
        joined[1][0]["grouped"],
        np.concatenate([np.full(6, 4.0), np.full(5, 2.0)]).astype(np.float32))


def test_adasum_with_a_joined_rank_is_the_identity(joined):
    """Adasum's zero-norm guards make a zero contribution the identity,
    bucket by bucket (a 512-byte threshold: three buckets), as the
    reference computes it for the same rows."""
    x = _adasum_inputs()
    got = joined[1][0]["adasum"]
    np.testing.assert_array_equal(got, x[1])
    ps = jhvd.add_process_set([0, 1])
    try:
        stacked = np.concatenate([x, np.repeat(x[1:], 6, axis=0)])
        want = np.asarray(jhvd.allreduce(jnp.asarray(stacked), op=5,
                                         process_set=ps,
                                         fusion_threshold_bytes=512))
    finally:
        jhvd.remove_process_set(ps)
    np.testing.assert_allclose(got, want[1], **ADASUM_TOL)


@pytest.mark.parametrize("tag,match", [
    ("int_average", "integer Average"),
    ("allgather", "cannot be serviced|cannot service")])
def test_unserviceable_ops_raise_on_both_ranks(joined, tag, match):
    import re
    for r, (_, flags, _) in enumerate(joined):
        assert re.search(match, flags[tag]), (r, flags[tag])


def test_history_restarts_after_join(joined):
    for out, _, _ in joined:
        np.testing.assert_array_equal(out["post_join"],
                                      np.full(2, 0.5, np.float32))


def test_mismatch_raises_on_both_ranks(joined):
    for _, flags, _ in joined:
        assert "mismatch across processes" in flags["mismatch"]


def test_timeline_shards_line_up(joined):
    """One shard per rank, each valid JSON with its rank's metadata and a
    clock anchor; the ops both ranks issued carry NEGOTIATE, QUEUE and
    EXEC with the same op ids and names on both shards."""
    phases = []
    for r, (_, _, trace) in enumerate(joined):
        evs = trace["traceEvents"]
        names = {e["name"] for e in evs}
        assert {"process_name", "shard_meta", "clock_anchor"} <= names
        meta = next(e for e in evs if e["name"] == "process_name")
        assert meta["args"] == {"name": f"rank {r}"}
        warm = sorted((e["args"]["op_id"], e["args"]["tensor"], e["name"])
                      for e in evs if e.get("cat") == "phase"
                      and e["args"]["tensor"].startswith("warm"))
        phases.append(warm)
    assert phases[0] == phases[1]
    assert phases[0] == sorted((i + 1, f"warm{i}", p) for i in range(2)
                               for p in ("NEGOTIATE", "QUEUE", "EXEC"))


def test_controller_tool_on_gloo():
    """``tools/torch_controller_bench.py`` (run on NCCL by the card tests)
    holds its checks on a two-rank gloo world."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools",
                                      "torch_controller_bench.py"),
         "--np", "2", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["ok"] and not out["failed"]
    assert len(out["negotiation_fast_us"]) == 2
