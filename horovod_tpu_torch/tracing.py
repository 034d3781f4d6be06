"""Span contexts: cross-rank correlation ids for collective operations.

Port of ``horovod_tpu/tracing.py``, whole.

Upstream Horovod's ``timeline.cc`` keys every NEGOTIATE / QUEUE / NCCL phase
event to the tensor being reduced, and because every rank logs the same
phases for the same tensor, merged per-rank timelines line up into one
cross-rank story. This module is that correlation layer:

* :func:`mint_span` hands out a **monotone op-id** at collective enqueue time
  (``collective.py``). Negotiation enforces that every process issues the
  same eager collectives in the same order, so locally-minted ids agree
  across ranks without any extra wire traffic — rank 3's op #17 *is* rank
  5's op #17.
* The span travels through negotiation, fusion, dispatch, and completion;
  each layer emits timeline phase events (``NEGOTIATE`` / ``QUEUE`` /
  ``EXEC``) carrying ``op_id`` + ``process_set`` + ``tensor`` args, so
  a merge of the rank shards can compute per-collective arrival spread and
  straggler blame (``trace_merge.py``, ``hvd.merge_timelines``).
* :func:`active_span` / :func:`current_span` expose the in-flight span to
  layers that cannot take it as an argument (the fusion planner stamps its
  flush events with it).

Span ids restart together with the negotiation history (`re-init`, elastic
re-mesh) — both count the same submission sequence.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

__all__ = ["Span", "mint_span", "current_span", "active_span",
           "reset_spans", "phase"]

_LOCK = threading.Lock()
_SEQ = 0
_TRACED_SEQ = 0
_TLS = threading.local()


class Span:
    """Identity of one collective operation, shared by every rank.

    ``op_id`` is the position in the (negotiation-ordered) submission
    sequence; ``process_set`` the set id the op ran on; ``tensor`` the
    user-facing name (``name=`` argument, or ``kind#op_id`` when unnamed).
    """

    __slots__ = ("op_id", "kind", "tensor", "process_set")

    def __init__(self, op_id: int, kind: str, tensor: str,
                 process_set: int = 0):
        self.op_id = op_id
        self.kind = kind
        self.tensor = tensor
        self.process_set = process_set

    def args(self) -> Dict[str, Any]:
        """Timeline-event args every phase of this op carries."""
        return {"op_id": self.op_id, "kind": self.kind,
                "tensor": self.tensor, "process_set": self.process_set}

    def __repr__(self) -> str:
        return (f"Span(op_id={self.op_id}, kind={self.kind!r}, "
                f"tensor={self.tensor!r}, process_set={self.process_set})")


def mint_span(kind: str, tensor: Optional[str] = None,
              process_set: int = 0, traced: bool = False) -> Span:
    """Mint the next span in the submission sequence (enqueue time).

    ``traced=True`` is for ops whose order is per-process (the
    reference's in-jit lowerings, once per compilation): they draw from a
    separate NEGATIVE id sequence -- never comparable cross-rank, never
    colliding with the negotiation-ordered eager ids a shard merge
    correlates."""
    global _SEQ, _TRACED_SEQ
    with _LOCK:
        if traced:
            _TRACED_SEQ -= 1
            op_id = _TRACED_SEQ
        else:
            _SEQ += 1
            op_id = _SEQ
    return Span(op_id, kind,
                tensor if tensor else f"{kind}#{op_id}", process_set)


def reset_spans() -> None:
    """Restart the op-id sequences (re-init / elastic re-mesh, alongside
    ``collective._reset_negotiation`` — ids and negotiation history count
    the same submission sequence and must restart together)."""
    global _SEQ, _TRACED_SEQ
    with _LOCK:
        _SEQ = 0
        _TRACED_SEQ = 0


def current_span() -> Optional[Span]:
    """The span of the collective currently being traced/dispatched on this
    thread, if any (what fusion reads to stamp its flush events)."""
    return getattr(_TLS, "span", None)


@contextmanager
def active_span(span: Optional[Span]):
    """Bind ``span`` as the thread's current span for the duration."""
    prev = getattr(_TLS, "span", None)
    _TLS.span = span
    try:
        yield span
    finally:
        _TLS.span = prev


@contextmanager
def phase(span: Optional[Span], name: str, category: str = "phase",
          **extra):
    """Emit a timeline complete-event for one phase of ``span``
    (``NEGOTIATE`` / ``QUEUE`` / ``EXEC``, mirroring upstream
    ``timeline.cc`` phase rows). No-op when no timeline is active; never
    raises into the dispatch hot path."""
    t = None
    try:
        from horovod_tpu_torch import timeline as _tl
        t = _tl.get_timeline()
    except Exception:
        pass
    if t is None or span is None:
        yield
        return
    args = dict(span.args(), **extra)
    try:
        cm = t.activity(name, category=category, **args)
        cm.__enter__()
    except Exception:
        yield
        return
    try:
        yield
    finally:
        try:
            cm.__exit__(None, None, None)
        except Exception:
            pass
