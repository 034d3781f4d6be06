"""Cross-rank trace aggregation: merge per-rank timeline shards into one
Chrome trace with per-rank tracks, clock alignment, and a straggler report.

Port of ``horovod_tpu/trace_merge.py``, whole. The port's timeline writes one
shard per rank (``HOROVOD_TIMELINE=/path/trace.json`` ->
``trace.rank{N}.json``, ``timeline.py``); this module is the controller-eye
view reconstructed after the fact, and on the same shards it gives the
reference's document:

* **Per-rank tracks** -- every shard's events are remapped to ``pid = rank``
  with ``process_name`` metadata, so Perfetto/chrome://tracing shows one
  swim-lane per rank.
* **Clock alignment** -- each shard records a ``clock_anchor`` instant at the
  init barrier (``core.init`` emits it right after the control group's
  barrier, one per init epoch); all ranks left that barrier at (nearly) the
  same real instant, so shifting every shard to make the anchors coincide
  cancels per-process clock origins AND wall-clock skew. The residual
  per-rank wall-clock offset is reported, not trusted.
* **Straggler report** -- phase events (``NEGOTIATE``/``QUEUE``/``EXEC``)
  carry the span context minted in ``collective.py`` (monotone ``op_id``,
  identical across ranks by negotiation order), so arrival spread per
  collective -- first-rank vs last-rank enqueue -- and a per-rank "time
  blamed" rollup fall out of a groupby.
* **Overlap estimate** -- :func:`overlap_report` reads the EXEC spans. On
  the port EXEC is the host's issue of the ``torch.distributed`` work, which
  NCCL runs asynchronously on the device: the estimate is of host issue,
  not of device overlap (``torch.profiler`` sees that).
* **Request tracks** -- request-trace shards (the reference's
  ``serving/reqtrace``, not ported yet: ROADMAP.md section A item 10) merge
  onto dedicated ``pid >= 1000`` tracks, wall-clock aligned through any
  anchored rank shard, and feed a ``requestReport`` with per-request TTFT
  breakdowns (see :func:`request_report`).

The port issues the ``allreduce_algorithm`` marker for every bucket it
issues, where the reference marks each compiled bucket once at trace time,
so :func:`overlap_report`'s ``algorithms`` counts steps x buckets on the
port's shards (the merge code is the reference's; ROADMAP.md section C).

A truncated or corrupt shard degrades to a warning (its parseable prefix is
salvaged when possible); the merge never crashes on one bad rank. Pure
Python: importing it starts no thread and touches no device.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

logger = logging.getLogger("horovod_tpu_torch")

__all__ = ["merge_timelines", "discover_shards", "load_shard",
           "straggler_report", "overlap_report", "request_report"]

#: phase-event names (tracing.phase) that mark a collective's host phases
PHASE_NAMES = ("NEGOTIATE", "QUEUE", "EXEC")

_RANK_RE = re.compile(r"\.rank(\d+)\.json$")


# ---------------------------------------------------------------------------
# shard loading
# ---------------------------------------------------------------------------

def discover_shards(inputs: Union[str, Sequence[str]]) -> List[str]:
    """Resolve ``inputs`` to a sorted list of shard paths.

    Accepts a list of explicit paths, a glob pattern, a directory, or the
    base path that was passed as ``HOROVOD_TIMELINE`` (``trace.json`` →
    every ``trace.rank*.json`` next to it, plus ``trace.json`` itself if a
    single-process run wrote it).
    """
    if not isinstance(inputs, str):
        paths: List[str] = []
        for p in inputs:
            paths.extend(discover_shards(p))
        # de-dup, keep order
        return list(dict.fromkeys(paths))
    if os.path.isdir(inputs):
        # Never re-ingest a previous merge output as a "shard".
        return sorted(p for p in glob.glob(os.path.join(inputs, "*.json"))
                      if not p.endswith(".merged.json"))
    if "*" in inputs or "?" in inputs:
        return sorted(p for p in glob.glob(inputs)
                      if not p.endswith(".merged.json"))
    root, ext = os.path.splitext(inputs)
    sharded = sorted(glob.glob(f"{root}.rank*{ext or '.json'}"),
                     key=lambda p: _shard_rank_from_name(p, 1 << 30))
    if sharded:
        return sharded
    return [inputs] if os.path.exists(inputs) else []


def _shard_rank_from_name(path: str, default: int) -> int:
    m = _RANK_RE.search(path)
    return int(m.group(1)) if m else default


def _salvage_events(text: str) -> Optional[List[dict]]:
    """Best-effort recovery of the parseable event prefix of a truncated
    shard: trim back to the last complete ``}`` and close the arrays."""
    start = text.find("[")
    if start < 0:
        return None
    body = text[start + 1:]
    cut = body.rfind("}")
    while cut >= 0:
        try:
            evs = json.loads("[" + body[:cut + 1] + "]")
            return [e for e in evs if isinstance(e, dict)]
        except ValueError:
            cut = body.rfind("}", 0, cut)
    return None


def load_shard(path: str) -> Tuple[List[dict], List[str]]:
    """Load one shard's events; returns ``(events, warnings)``. A corrupt
    or truncated shard yields its salvageable prefix (possibly empty) and a
    warning instead of raising."""
    warnings: List[str] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [], [f"{path}: unreadable ({e})"]
    try:
        doc = json.loads(text)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) \
            else doc
        if not isinstance(events, list):
            return [], [f"{path}: no traceEvents array"]
        return [e for e in events if isinstance(e, dict)], warnings
    except ValueError:
        evs = _salvage_events(text)
        if evs is None:
            return [], [f"{path}: corrupt shard, no events salvageable "
                        "(skipped)"]
        return evs, [f"{path}: truncated/corrupt shard — salvaged "
                     f"{len(evs)} events"]


def _shard_rank(path: str, events: List[dict], ordinal: int) -> int:
    """Rank of a shard: its ``shard_meta`` event, else the ``.rank{N}.``
    filename convention, else file ordinal."""
    for e in events:
        if e.get("name") == "shard_meta":
            try:
                return int(e.get("args", {})["rank"])
            except (KeyError, TypeError, ValueError):
                break
    return _shard_rank_from_name(path, ordinal)


def _request_shard_meta(events: List[dict]) -> Optional[Dict[str, Any]]:
    """The ``shard_meta`` args of a request-trace shard (``serving/
    reqtrace.flush``), identified by ``role == "request"`` — else None.
    Request shards are NOT rank shards: they have no collective op-ids,
    no clock anchor, and their own pid track space in the merge."""
    for e in events:
        if e.get("name") != "shard_meta":
            continue
        args = e.get("args") or {}
        if args.get("role") == "request":
            return args
        return None
    # A salvaged (truncated) reqtrace shard can lose its shard_meta
    # header order — fall back to the event category.
    if any(e.get("cat") == "request" for e in events):
        return {"role": "request"}
    return None


# ---------------------------------------------------------------------------
# clock alignment
# ---------------------------------------------------------------------------

def _find_anchors(events: List[dict]) -> Dict[int, dict]:
    """Init-barrier ``clock_anchor`` instants by epoch (elastic re-inits
    emit one per epoch; per epoch the earliest wins)."""
    out: Dict[int, dict] = {}
    for e in events:
        if e.get("name") != "clock_anchor":
            continue
        try:
            ep = int((e.get("args") or {}).get("epoch", 0))
        except (TypeError, ValueError):
            ep = 0
        cur = out.get(ep)
        if cur is None or e.get("ts", 0.0) < cur.get("ts", 0.0):
            out[ep] = e
    return out


def _select_anchor_epoch(shards: List[Dict[str, Any]]
                         ) -> Tuple[Dict[int, dict], List[str]]:
    """Pick ONE barrier every anchored shard attended: the highest epoch
    present in all of them. A shard's earliest anchor is NOT necessarily a
    common barrier (an elastic-relaunched worker's first anchor is a
    survivor's Nth), so aligning on it would shift whole shards by an
    epoch; the max common epoch is a barrier everyone demonstrably left
    together. Returns ``(anchor_by_rank, warnings)``."""
    warnings: List[str] = []
    anchored = [s for s in shards if s["anchors"]]
    if not anchored:
        return {}, warnings
    common = set.intersection(*(set(s["anchors"]) for s in anchored))
    out: Dict[int, dict] = {}
    if common:
        ep = max(common)
        for s in anchored:
            out[s["rank"]] = s["anchors"][ep]
    else:
        # No shared epoch number (mixed restarts): best effort — each
        # shard's earliest anchor, loudly caveated.
        for s in anchored:
            out[s["rank"]] = s["anchors"][min(s["anchors"])]
        warnings.append(
            "no clock_anchor epoch is common to all shards — aligned on "
            "each shard's earliest anchor; spreads across elastic "
            "restarts may be wrong")
    return out, warnings


def _align_offsets(shards: List[Dict[str, Any]]
                   ) -> Tuple[Dict[int, float], Dict[int, float], List[str]]:
    """Per-rank ts offsets so every shard's anchor lands on the same merged
    timestamp. Returns ``(offset_us_by_rank, wall_skew_s_by_rank,
    warnings)``; shards without an anchor keep their raw timestamps (offset
    such that alignment is identity) with a warning."""
    anchored, warnings = _select_anchor_epoch(shards)
    offsets: Dict[int, float] = {}
    skew: Dict[int, float] = {}
    if anchored:
        # Align every anchor to the LATEST anchor ts: offsets are then
        # non-negative, so no event moves before t=0.
        base = max(a.get("ts", 0.0) for a in anchored.values())
        walls = {r: a.get("args", {}).get("wall_time")
                 for r, a in anchored.items()}
        ref_wall = next((w for w in walls.values() if w is not None), None)
        for s in shards:
            r = s["rank"]
            a = anchored.get(r)
            if a is None:
                offsets[r] = 0.0
                warnings.append(
                    f"rank {r}: no clock_anchor event — timestamps kept "
                    "unaligned")
                continue
            offsets[r] = base - a.get("ts", 0.0)
            w = walls.get(r)
            skew[r] = (w - ref_wall) if (w is not None
                                         and ref_wall is not None) else 0.0
    else:
        for s in shards:
            offsets[s["rank"]] = 0.0
        if len(shards) > 1:
            warnings.append(
                "no clock_anchor events in any shard — per-rank clocks "
                "not aligned; arrival spreads include clock skew")
    return offsets, skew, warnings


# ---------------------------------------------------------------------------
# straggler analysis
# ---------------------------------------------------------------------------

#: below this arrival spread, ranks are "simultaneous": anchor alignment
#: is only barrier-exit accurate, so attributing blame from a smaller
#: delta would report clock jitter as stragglers (the live negotiation
#: path applies the same idea at its coarser ms resolution).
MIN_ATTRIBUTABLE_SPREAD_S = 1e-4


def straggler_report(shards: List[Dict[str, Any]],
                     offsets: Dict[int, float],
                     skew: Dict[int, float],
                     min_spread_s: float = MIN_ATTRIBUTABLE_SPREAD_S
                     ) -> Dict[str, Any]:
    """Cross-rank arrival analysis over span-contexted phase events.

    For every collective ``op_id`` seen on 2+ ranks: the **arrival** of a
    rank is the earliest aligned phase timestamp it logged for that op
    (NEGOTIATE start when present, else QUEUE/EXEC); the **spread** is
    last-rank minus first-rank arrival; **blame** charges the spread to the
    last-arriving rank (its lateness is what every other rank waited out);
    the **critical path** estimate sums, per elastic epoch, each op's
    spread plus the last rank's EXEC duration. Spreads below
    ``min_spread_s`` still report but neither name late ranks nor accrue
    blame — that's alignment jitter, not a straggler.
    """
    # op_id -> rank -> {"arrival": us, "exec_dur": us, meta...}
    ops: Dict[int, Dict[int, Dict[str, Any]]] = {}
    meta: Dict[int, Dict[str, Any]] = {}
    for s in shards:
        r = s["rank"]
        off = offsets.get(r, 0.0)
        for e in s["events"]:
            name = e.get("name")
            if name not in PHASE_NAMES:
                continue
            args = e.get("args") or {}
            op_id = args.get("op_id")
            if op_id is None:
                continue
            try:
                op_id = int(op_id)
            except (TypeError, ValueError):
                continue
            if op_id <= 0:
                # Negative ids are in-step ops (``mint_span(traced=
                # True)``): per-process order, not cross-rank comparable.
                continue
            ts = float(e.get("ts", 0.0)) + off
            entry = ops.setdefault(op_id, {}).setdefault(
                r, {"arrival": ts, "exec_dur": 0.0})
            entry["arrival"] = min(entry["arrival"], ts)
            if name == "EXEC":
                entry["exec_dur"] = max(entry["exec_dur"],
                                        float(e.get("dur", 0.0)))
            m = meta.setdefault(op_id, {})
            for k in ("tensor", "kind", "process_set", "epoch"):
                if k in args and k not in m:
                    m[k] = args[k]

    collectives: List[Dict[str, Any]] = []
    blame: Dict[int, float] = {s["rank"]: 0.0 for s in shards}
    epochs: Dict[str, float] = {}
    for op_id in sorted(ops):
        per_rank = ops[op_id]
        if len(per_rank) < 2:
            continue
        arrivals = {r: v["arrival"] for r, v in per_rank.items()}
        first_rank = min(arrivals, key=arrivals.get)
        last_rank = max(arrivals, key=arrivals.get)
        spread_us = arrivals[last_rank] - arrivals[first_rank]
        spread_s = spread_us / 1e6
        attributable = spread_s >= min_spread_s
        late = [r for r, a in arrivals.items()
                if a - arrivals[first_rank] > spread_us * 0.5] \
            if attributable else []
        if attributable:
            blame[last_rank] = blame.get(last_rank, 0.0) + spread_s
        exec_s = per_rank[last_rank]["exec_dur"] / 1e6
        epoch = str(meta.get(op_id, {}).get("epoch", 0))
        epochs[epoch] = epochs.get(epoch, 0.0) + spread_s + exec_s
        collectives.append({
            "op_id": op_id,
            "tensor": meta.get(op_id, {}).get("tensor"),
            "kind": meta.get(op_id, {}).get("kind"),
            "process_set": meta.get(op_id, {}).get("process_set", 0),
            "arrival_us": {str(r): round(a, 3)
                           for r, a in sorted(arrivals.items())},
            "spread_seconds": spread_s,
            "first_rank": first_rank,
            "last_rank": last_rank,
            "late_ranks": sorted(late),
            "exec_seconds_last_rank": exec_s,
        })
    return {
        "ranks": sorted(s["rank"] for s in shards),
        "collectives": collectives,
        "blame_seconds_by_rank": {str(r): v for r, v in sorted(blame.items())},
        "critical_path_seconds_by_epoch": epochs,
        "critical_path_seconds": sum(epochs.values()),
        "clock_skew_seconds_by_rank": {str(r): v
                                       for r, v in sorted(skew.items())},
    }


def overlap_report(shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-rank collective-overlap estimate from the op-id EXEC spans.

    For each rank, the EXEC phase events of positive op-ids form a set of
    host dispatch intervals. ``sum_seconds`` is their total duration,
    ``busy_seconds`` the duration of their union; the **overlap
    efficiency** ``1 - busy/sum`` is the fraction of collective dispatch
    time that ran concurrently with another collective's — 0.0 when
    every collective was serialized (one monolithic end-of-backward
    batch), approaching 1 - 1/k when k chunks/buckets pipeline cleanly.
    This is a host-side *estimate*: EXEC is the host's issue of the
    ``torch.distributed`` work, which NCCL runs asynchronously (device
    overlap is read from ``torch.profiler``), but it is computed from the
    same spans on every rank, so regressions show up as a drop without
    any device in the loop.
    """
    per_rank: Dict[str, Dict[str, float]] = {}
    effs = []
    for s in shards:
        intervals = []
        for e in s["events"]:
            if e.get("name") != "EXEC":
                continue
            args = e.get("args") or {}
            try:
                op_id = int(args.get("op_id"))
            except (TypeError, ValueError):
                continue
            if op_id <= 0:
                continue
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
            if dur > 0:
                intervals.append((ts, ts + dur))
        total = sum(b - a for a, b in intervals)
        busy = 0.0
        intervals.sort()
        cur_a = cur_b = None
        for a, b in intervals:
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
        eff = (1.0 - busy / total) if total > 0 else 0.0
        if len(intervals) >= 2:
            effs.append(eff)
        per_rank[str(s["rank"])] = {
            "collective_exec_sum_seconds": total / 1e6,
            "collective_exec_busy_seconds": busy / 1e6,
            "overlap_efficiency": round(eff, 4),
            "exec_spans": len(intervals),
        }
    return {
        "by_rank": per_rank,
        "overlap_efficiency": round(sum(effs) / len(effs), 4) if effs
        else 0.0,
        "algorithms": _algorithm_summary(shards),
    }


def _algorithm_summary(shards: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate the ``allreduce_algorithm`` markers into a per-algorithm
    lowering summary: bucket counts, total wire bytes, per-phase wire
    bytes (the multi-leg 2D/swing decomposition — each RS/AG leg
    separately), and the torus the lowering saw. Markers fire identically
    on every rank, so the summary reads one representative shard (the
    lowest rank present) rather than multiplying per-rank copies of the
    same bucket. The reference marks a compiled bucket once; the port
    marks every bucket it issues, so ``buckets`` counts steps x buckets
    there."""
    if not shards:
        return {}
    rep = min(shards, key=lambda s: s["rank"])
    out: Dict[str, Dict[str, Any]] = {}
    for e in rep["events"]:
        if e.get("name") != "allreduce_algorithm":
            continue
        args = e.get("args") or {}
        alg = args.get("algorithm")
        if not alg:
            continue
        rec = out.setdefault(alg, {"buckets": 0, "wire_bytes": 0,
                                   "phase_bytes": {}})
        rec["buckets"] += 1
        try:
            rec["wire_bytes"] += int(args.get("wire_bytes", 0))
        except (TypeError, ValueError):
            pass
        for ph, b in (args.get("phases") or {}).items():
            try:
                rec["phase_bytes"][ph] = (rec["phase_bytes"].get(ph, 0)
                                          + int(b))
            except (TypeError, ValueError):
                continue
        if args.get("topology"):
            rec["topology"] = args["topology"]
        if args.get("wire"):
            rec["wire"] = args["wire"]
    return out


# ---------------------------------------------------------------------------
# request report
# ---------------------------------------------------------------------------

#: TTFT breakdown component names, in pipeline order.
REQUEST_COMPONENTS = ("hedge_wait", "queue", "prefill", "decode", "push",
                      "other")


def _pctl(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (empty → 0)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def request_report(events_or_doc: Union[Dict[str, Any], Sequence[dict]]
                   ) -> Dict[str, Any]:
    """Per-request TTFT breakdown over ``cat == "request"`` span events.

    Groups request spans (``serving/reqtrace``) by ``args.trace_id`` and,
    for each traced request, decomposes its time-to-first-token into
    components — ``hedge_wait`` (submit until the winning attempt reached a
    replica), ``queue``/``prefill``/``decode`` (server-side engine spans),
    ``push`` (first token's transport delivery lag) and ``other`` (the
    unattributed remainder). Component durations are same-process ts
    deltas or server-recorded span durations, so the math survives clock
    skew between dispatcher and replica shards. Serving spans are
    attributed to the engine that produced the first token (``FIRST_TOKEN``
    ``args.engine``) so a hedged loser's partial work is not double
    counted.

    Returns aggregate p50/p99 TTFT, the p99 request's full breakdown (with
    its component sum, for sanity-checking against measured TTFT), mean
    breakdown across requests, the dominant component, and per-replica
    blame (``hedge_wait`` charged to the first-attempt target, serving
    time to the serving engine).
    """
    events: Sequence[dict]
    if isinstance(events_or_doc, dict):
        events = events_or_doc.get("traceEvents") or []
    else:
        events = events_or_doc

    traces: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("cat") != "request":
            continue
        tid = (e.get("args") or {}).get("trace_id")
        if tid:
            traces.setdefault(str(tid), []).append(e)

    requests: List[Dict[str, Any]] = []
    blame: Dict[str, float] = {}
    for tid, evs in sorted(traces.items()):
        by_name: Dict[str, List[dict]] = {}
        for e in sorted(evs, key=lambda e: float(e.get("ts", 0.0))):
            by_name.setdefault(e.get("name") or "", []).append(e)

        def _args(e: Optional[dict]) -> Dict[str, Any]:
            return (e.get("args") or {}) if e else {}

        submit = (by_name.get("SUBMIT") or [None])[0]
        attempts = by_name.get("ATTEMPT") or []
        hedge_win = (by_name.get("HEDGE_WIN") or [None])[0]
        winner = _args(hedge_win).get("winner")
        win_attempt = next(
            (a for a in attempts if _args(a).get("target") == winner),
            attempts[0] if attempts else None) if winner else \
            (attempts[0] if attempts else None)

        first_tok = (by_name.get("FIRST_TOKEN") or [None])[0]
        client_tok = (by_name.get("CLIENT_FIRST_TOKEN") or [None])[0]
        ttft = _args(client_tok).get("ttft_s",
                                     _args(first_tok).get("ttft_s"))
        engine = _args(first_tok).get("engine")

        def _serving(name: str) -> List[dict]:
            evs = by_name.get(name) or []
            if engine is not None:
                evs = [e for e in evs if _args(e).get("engine") == engine]
            return evs

        comp = {k: 0.0 for k in REQUEST_COMPONENTS}
        if submit is not None and win_attempt is not None:
            comp["hedge_wait"] = max(
                0.0, (float(win_attempt.get("ts", 0.0))
                      - float(submit.get("ts", 0.0))) / 1e6)
        comp["queue"] = sum(float(e.get("dur", 0.0))
                            for e in _serving("QUEUE")) / 1e6
        comp["prefill"] = sum(float(e.get("dur", 0.0))
                              for e in _serving("PREFILL")) / 1e6
        decodes = _serving("DECODE")
        if first_tok is not None:
            # Only decode work that started before the first token counts
            # toward TTFT; the rest is TPOT territory.
            ft_ts = float(first_tok.get("ts", 0.0))
            decodes = [e for e in decodes
                       if float(e.get("ts", 0.0)) <= ft_ts]
        comp["decode"] = sum(float(e.get("dur", 0.0))
                             for e in decodes) / 1e6
        pushes = by_name.get("PUSH_DELIVERY") or []
        if pushes:
            comp["push"] = float(pushes[0].get("dur", 0.0)) / 1e6
        known = sum(v for k, v in comp.items() if k != "other")
        if ttft is not None:
            comp["other"] = max(0.0, float(ttft) - known)

        first_attempt = attempts[0] if attempts else None
        target0 = _args(first_attempt).get("target")
        if target0:
            blame[str(target0)] = (blame.get(str(target0), 0.0)
                                   + comp["hedge_wait"])
        if engine:
            blame[str(engine)] = (blame.get(str(engine), 0.0)
                                  + comp["queue"] + comp["prefill"]
                                  + comp["decode"] + comp["push"])

        requests.append({
            "trace_id": tid,
            "request": _args(submit).get("request",
                                         _args(first_tok).get("request")),
            "ttft_s": float(ttft) if ttft is not None else None,
            "hedged": bool(by_name.get("HEDGE")),
            "winner": winner,
            "engine": engine,
            "breakdown_s": comp,
            "breakdown_sum_s": sum(comp.values()),
        })

    with_ttft = sorted((r for r in requests if r["ttft_s"] is not None),
                       key=lambda r: r["ttft_s"])
    ttfts = [r["ttft_s"] for r in with_ttft]
    p99_req = with_ttft[max(0, min(len(with_ttft) - 1,
                                   int(math.ceil(0.99 * len(with_ttft)))
                                   - 1))] if with_ttft else None
    mean = {k: (sum(r["breakdown_s"][k] for r in requests) / len(requests)
                if requests else 0.0) for k in REQUEST_COMPONENTS}
    dominant = max(mean, key=mean.get) if requests else None
    return {
        "requests": requests,
        "count": len(requests),
        "hedged": sum(1 for r in requests if r["hedged"]),
        "ttft_p50_s": _pctl(ttfts, 0.50),
        "ttft_p99_s": _pctl(ttfts, 0.99),
        "p99_request": p99_req,
        "breakdown_mean_s": mean,
        "dominant_component": dominant,
        "replica_blame_s": {k: v for k, v in sorted(blame.items())},
        "dominant_replica": (max(blame, key=blame.get) if blame else None),
    }


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------

def merge_timelines(inputs: Union[str, Sequence[str]],
                    output: Optional[str] = None, *,
                    feed_metrics: bool = True) -> Dict[str, Any]:
    """Merge per-rank timeline shards into one Chrome trace
    (``hvd.merge_timelines``).

    ``inputs``: the base path given as ``HOROVOD_TIMELINE`` (shards are
    discovered next to it), a glob, a directory, or an explicit list of
    shard paths. Returns the merged trace dict — ``traceEvents`` with
    per-rank ``pid`` tracks plus a ``stragglerReport`` key (ignored by
    trace viewers) — and writes it to ``output`` when given.

    When ``feed_metrics`` (default), each collective's arrival spread is
    observed into the process-local metrics registry as
    ``collective_arrival_spread_seconds{source="merge"}`` so a post-run
    merge surfaces skew through the same exporters as live metrics.
    """
    paths = discover_shards(inputs)
    if not paths:
        raise FileNotFoundError(f"no timeline shards found for {inputs!r}")
    warnings: List[str] = []
    shards: List[Dict[str, Any]] = []
    req_shards: List[Dict[str, Any]] = []
    for i, path in enumerate(paths):
        events, w = load_shard(path)
        warnings.extend(w)
        for msg in w:
            logger.warning("trace_merge: %s", msg)
        if not events:
            continue
        rmeta = _request_shard_meta(events)
        if rmeta is not None:
            # Request-trace shard: its own track, wall-clock aligned —
            # it never competes for a rank id and never feeds the
            # op-id straggler/overlap analysis.
            req_shards.append({
                "path": path, "events": events,
                "proc": str(rmeta.get("proc") or f"shard{i}"),
                "wall0": float(rmeta.get("wall0") or 0.0)})
            continue
        rank = _shard_rank(path, events, i)
        if any(s["rank"] == rank for s in shards):
            warnings.append(f"{path}: duplicate rank {rank} — skipped "
                            "(is a previous merge output in the input set?)")
            logger.warning("trace_merge: %s", warnings[-1])
            continue
        shards.append({"path": path, "events": events, "rank": rank,
                       "anchors": _find_anchors(events)})
    if not shards and not req_shards:
        raise ValueError(
            f"no events salvageable from any shard of {inputs!r}: "
            + "; ".join(warnings))

    offsets, skew, w = _align_offsets(shards)
    warnings.extend(w)
    for msg in w:
        logger.warning("trace_merge: %s", msg)

    merged: List[dict] = []
    for s in shards:
        r = s["rank"]
        off = offsets.get(r, 0.0)
        merged.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"rank {r}"}})
        merged.append({"name": "process_sort_index", "ph": "M", "pid": r,
                       "args": {"sort_index": r}})
        for e in s["events"]:
            if e.get("ph") == "M":
                continue        # per-shard metadata is re-synthesized above
            out = dict(e)
            out["pid"] = r
            if "ts" in out:
                out["ts"] = float(out["ts"]) + off
            merged.append(out)

    if req_shards:
        # Request shards carry no clock_anchor (they live in dispatcher /
        # replica processes, outside the collective barrier). Each records
        # the wall time of its ts origin (``wall0``), so map wall time onto
        # the merged axis through any anchored rank shard whose anchor also
        # recorded ``wall_time``; with no rank shards at all, the earliest
        # request shard defines t=0.
        anchored, _ = _select_anchor_epoch(shards)
        ref: Optional[Tuple[float, float]] = None
        for r, a in sorted(anchored.items()):
            wall = (a.get("args") or {}).get("wall_time")
            if wall is not None:
                ref = (float(wall), float(a.get("ts", 0.0))
                       + offsets.get(r, 0.0))
                break
        if ref is None:
            ref = (min(s["wall0"] for s in req_shards), 0.0)
        for seq, s in enumerate(sorted(req_shards,
                                       key=lambda s: s["wall0"])):
            pid = 1000 + seq
            delta = (s["wall0"] - ref[0]) * 1e6 + ref[1]
            merged.append({"name": "process_name", "ph": "M", "pid": pid,
                           "args": {"name": f"request {s['proc']}"}})
            merged.append({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "args": {"sort_index": pid}})
            for e in s["events"]:
                if e.get("ph") == "M":
                    continue
                out = dict(e)
                out["pid"] = pid
                if "ts" in out:
                    out["ts"] = float(out["ts"]) + delta
                merged.append(out)

    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))

    report = straggler_report(shards, offsets, skew)
    report["overlap"] = overlap_report(shards)
    if warnings:
        report["warnings"] = warnings

    if feed_metrics:
        try:
            from horovod_tpu_torch import metrics as _metrics
            for c in report["collectives"]:
                _metrics.histogram("collective_arrival_spread_seconds",
                                   source="merge").observe(
                    c["spread_seconds"])
            _metrics.gauge("overlap_efficiency_estimate",
                           source="merge").set(
                report["overlap"]["overlap_efficiency"])
        except Exception:
            logger.exception("trace_merge: feeding metrics failed")

    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "stragglerReport": report}
    if any(e.get("cat") == "request" for e in merged):
        try:
            doc["requestReport"] = request_report(merged)
        except Exception:
            logger.exception("trace_merge: request_report failed")
    if output:
        tmp = f"{output}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, output)
    return doc
