"""horovod_tpu_torch.timeline and tracing == horovod_tpu's.

One eager allreduce, under each package's timeline, must give the same
events: names, categories, phase types and arguments, the timestamps,
process and thread ids aside. Two differences are by design and asserted
as such: the reference's eager payload is the stacked (8, ...) array of its
``tensor[r]`` convention, so its ``bytes`` on the collective and QUEUE
events is 8 times the port's per-rank payload; and ``epoch`` is each
package's own init count. The reference's ``allreduce_algorithm`` marker
belongs to its algorithm axis (``ROADMAP.md`` section A item 4) and is left
out of that comparison. The profiler's ``recompile`` marker is held
against the reference's on the same call sequence.

The port's timeline always leaves valid JSON: after a flush that raised,
after an argument that cannot be written, and per rank in a world larger
than one (``tests/test_torch_port_negotiation.py`` checks the shards).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import collective as JC
from horovod_tpu import core as JCORE
from horovod_tpu import timeline as JT
from horovod_tpu import tracing as JTR
from horovod_tpu_torch import core as PCORE
from horovod_tpu_torch import timeline as PT
from horovod_tpu_torch import tracing as PTR

N = 8                                  # devices of the reference's mesh
NOT_PORTED = {"allreduce_algorithm"}


def _events(path):
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    out = []
    for e in evs:
        if e["name"] in NOT_PORTED:
            continue
        assert isinstance(e["ts"], float) and isinstance(e["pid"], int)
        out.append({k: v for k, v in e.items()
                    if k not in ("ts", "dur", "pid", "tid")})
    return out


def _norm(evs, epoch, scale):
    """Events with ``epoch`` checked against the package's init count and
    ``bytes`` of the whole payload divided by ``scale``."""
    out = []
    for e in evs:
        args = dict(e["args"])
        if "epoch" in args:
            assert args.pop("epoch") == epoch
        if e["name"] in ("allreduce", "QUEUE"):
            assert args["bytes"] % scale == 0
            args["bytes"] //= scale
        out.append(json.dumps(dict(e, args=args), sort_keys=True))
    return sorted(out)


@pytest.mark.parametrize("shape,threshold", [((41,), None),
                                             ((3, 300), 1024)])
def test_one_allreduce_gives_the_reference_events(tmp_path, shape,
                                                  threshold):
    x = np.random.default_rng(1).standard_normal((N,) + shape).astype(
        np.float32)
    kw = {} if threshold is None else {"fusion_threshold_bytes": threshold}
    # Reference: fresh span ids, and a fresh program so its fusion plan
    # (and its flush markers) is traced.
    JC._reset_negotiation()
    JC._EAGER_CACHE.clear()
    JT.start_timeline(str(tmp_path / "ref.json"))
    try:
        jhvd.allreduce(jnp.asarray(x), op=jhvd.Sum, name="grad/w", **kw)
    finally:
        JT.stop_timeline()
    hvd.init(device="cpu")
    try:
        PT.start_timeline(str(tmp_path / "port.json"))
        try:
            hvd.allreduce(torch.tensor(x[0]), op=hvd.Sum, name="grad/w",
                          **kw)
        finally:
            PT.stop_timeline()
        port_epoch = PCORE.init_epoch()
    finally:
        hvd.shutdown()
    ref = _norm(_events(tmp_path / "ref.json"), JCORE.init_epoch(), N)
    port = _norm(_events(tmp_path / "port.json"), port_epoch, 1)
    assert port == ref
    names = sorted(json.loads(e)["name"] for e in port)
    n_buckets = 1 if threshold is None else 4
    assert names == sorted(["allreduce", "QUEUE", "EXEC"]
                           + ["fusion_flush"] * n_buckets)


_CALLS = [({"x": "float32[8]", "n": "8"}, False),
          ({"x": "float32[8]", "n": "8"}, False),
          ({"x": "float32[8]", "n": "4"}, False),
          ({"x": "float32[4]", "n": "4"}, False),
          ({"x": "float32[8]", "n": "8"}, False),
          ({"t": "1"}, True), ({"t": "2"}, True)]


def test_recompile_markers_match_reference(tmp_path):
    """The same note_trace sequence under each package's timeline leaves
    the same ``recompile`` markers: program, blamed arguments and the old
    -> new detail."""
    from horovod_tpu import profiler as JP
    from horovod_tpu_torch import profiler as PP
    got = {}
    for side, prof, tl in (("port", PP, PT), ("ref", JP, JT)):
        prof.registry.reset()
        path = tmp_path / f"{side}.json"
        tl.start_timeline(str(path))
        try:
            for sig, expected in _CALLS:
                prof.note_trace("tuned" if expected else "step", sig,
                                expected=expected)
        finally:
            tl.stop_timeline()
            prof.registry.reset()
        got[side] = [e for e in _events(path) if e["name"] == "recompile"]
    assert got["port"] == got["ref"]
    # the return to (8, 8) revisits a seen signature: no marker
    assert [e["args"]["arguments"] for e in got["port"]] == [
        ["n"], ["x"], ["t"]]
    assert got["port"][0]["cat"] == "profiler"
    assert got["port"][0]["args"] == {"program": "step", "arguments": ["n"],
                                      "detail": "n: 8 -> 4"}


def test_spans_match_reference():
    for tr in (PTR, JTR):
        tr.reset_spans()
    for args in [("allreduce", None, 0), ("broadcast", "emb", 3),
                 ("allgather", None, 1, True), ("allreduce", "w", 0)]:
        kind, tensor, ps = args[:3]
        traced = len(args) > 3
        a = PTR.mint_span(kind, tensor=tensor, process_set=ps, traced=traced)
        b = JTR.mint_span(kind, tensor=tensor, process_set=ps, traced=traced)
        assert repr(a) == repr(b) and a.args() == b.args()
    for tr in (PTR, JTR):
        tr.reset_spans()
    assert PTR.mint_span("x").op_id == JTR.mint_span("x").op_id == 1
    span = PTR.mint_span("allreduce")
    assert PTR.current_span() is None
    with PTR.active_span(span):
        assert PTR.current_span() is span
    assert PTR.current_span() is None
    JTR.reset_spans()


def test_flush_that_raised_leaves_valid_json(tmp_path):
    path = tmp_path / "sub" / "trace.json"
    t = PT.Timeline(str(path))
    t.marker("before", category="trace", x=1)
    with pytest.raises(OSError):
        t.flush()                    # the directory does not exist
    assert not path.exists()
    path.parent.mkdir()
    path.write_text('{"traceEvents": [], "displayTimeUnit": "ms"}')
    with t.activity("allreduce", op_id=1):
        pass
    t.flush()
    evs = json.loads(path.read_text())["traceEvents"]
    assert [e["name"] for e in evs] == ["before", "allreduce"]
    assert evs[1]["ph"] == "X" and evs[1]["dur"] >= 0
    t.marker("after")                # closed: dropped
    t.flush()
    assert len(json.loads(path.read_text())["traceEvents"]) == 2


def test_unwritable_argument_keeps_the_trace(tmp_path):
    class Bad:
        def __str__(self):
            raise RuntimeError("no str")

    loop = {}
    loop["self"] = loop
    t = PT.Timeline(str(tmp_path / "t.json"))
    t.marker("bad", obj=Bad(), ok=3)
    t.marker("cycle", d=loop)
    t.marker("numpy", v=np.float32(1.5), a=np.arange(2))
    t.flush()
    evs = {e["name"]: e for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert evs["bad"]["args"] == {"obj": "<unserializable Bad>", "ok": 3}
    assert evs["cycle"]["args"] == {"d": "<unserializable dict>"}
    assert evs["numpy"]["args"]["v"] == "1.5"


def test_start_and_stop_timeline_and_taps(tmp_path):
    seen = []
    PT.add_tap(seen.append)
    try:
        hvd.start_timeline(str(tmp_path / "a.json"))
        PT.get_timeline().marker("one")
        hvd.start_timeline(str(tmp_path / "b.json"))   # writes a.json
        assert json.loads((tmp_path / "a.json").read_text())[
            "traceEvents"][0]["name"] == "one"
        PT.emit_clock_anchor(epoch=3)
        hvd.stop_timeline()
        assert PT.get_timeline() is None
    finally:
        PT.remove_tap(seen.append)
    anchor = json.loads((tmp_path / "b.json").read_text())["traceEvents"][0]
    assert anchor["name"] == "clock_anchor" and anchor["cat"] == "trace"
    assert anchor["args"]["epoch"] == 3 and "wall_time" in anchor["args"]
    assert [e["name"] for e in seen] == ["one", "clock_anchor"]
    assert PT.shard_path("/p/trace.json", 3) == JT.shard_path(
        "/p/trace.json", 3) == "/p/trace.rank3.json"


def test_horovod_timeline_starts_at_init(monkeypatch, tmp_path):
    path = tmp_path / "env.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    try:
        hvd.broadcast(torch.ones(2), 0, name="b")
    finally:
        hvd.shutdown()             # writes the trace
    evs = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in evs]
    assert "clock_anchor" in names and "init" in names
    phases = [(e["name"], e["args"]["op_id"], e["args"]["tensor"])
              for e in evs if e["cat"] == "phase"]
    assert phases == [("QUEUE", 1, "b"), ("EXEC", 1, "b")]
