"""Static schedule tables for interleaved 1F1B.

Port of ``horovod_tpu/parallel/schedule_sim.py`` (which imports only numpy,
but importing it runs ``horovod_tpu/__init__`` and so jax: the port keeps
its own copy). Its tables are the reference's, bit for bit, and so are its
errors.

Megatron-LM's interleaved 1F1B gives each rank of a pp line R *virtual
stages* (rounds) and schedules warmup forwards, steady 1F1B and cooldown
backwards per rank. :func:`pipeline.pipeline_interleaved_1f1b` reads that
schedule as data: per-(rank, tick) tables of the (round, microbatch) each
forward and backward slot runs, what each tick's hops carry, and which
buffer slot a payload occupies. A rank runs its own row of the tables;
both ends of every hop read the same tables, so a send always meets its
receive, in the same order.

This module derives the tables with a host-side event simulation:

- Each rank's op ORDER follows the Megatron recipe: ``num_warmup(d) =
  (S - d - 1) * 2 + (R - 1) * S`` forwards first (microbatches walked in
  round-major groups of S), then strict F/B alternation, then the B tail.
- TIMING comes from dependency-driven lockstep: at each tick a rank runs
  its next F and/or next B when their inputs exist (the activation of
  virtual stage ``sigma - 1`` one hop earlier, the cotangent of ``sigma +
  1``), with ONE forward hop and ONE backward hop per rank per tick, and
  the wrap edge ``S - 1 -> 0`` (round handoff) sharing the forward ring.
- The result is verified structurally (every op exactly once, deps
  respected, no buffer slot overwritten before it is read) before any
  rank runs it.

All sizes here are tiny (S, R, M up to a few dozen), so the O(T·S) Python
simulation takes microseconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["InterleavedSchedule", "build_interleaved_1f1b"]


@dataclass
class InterleavedSchedule:
    """Per-(device, tick) slot tables, -1 = idle. Shapes (S, T)."""
    S: int
    R: int
    M: int
    T: int
    f_round: np.ndarray      # round of the F slot
    f_mb: np.ndarray         # microbatch of the F slot
    b_round: np.ndarray      # round of the B slot
    b_mb: np.ndarray         # microbatch of the B slot
    # Forward-ring traffic: at tick t the forward hop carries, for each
    # SENDER device d, the (round_at_receiver, mb) it ships (-1 = none).
    # The receiver of d is (d+1) % S; the wrap edge S-1 -> 0 hands the
    # activation to round r+1.
    send_round: np.ndarray
    send_mb: np.ndarray
    # Backward-ring traffic, sender d ships to d-1 (-1 = none).
    bsend_round: np.ndarray
    bsend_mb: np.ndarray
    # Receive-side labels (= the upstream sender's send labels): where
    # the payload arriving at device d this tick must be stored.
    recv_round: np.ndarray = None
    recv_mb: np.ndarray = None
    brecv_round: np.ndarray = None
    brecv_mb: np.ndarray = None
    # Residual ring-buffer slot of the F/B slot's (round, mb); -1 idle.
    f_slot: np.ndarray = None
    b_slot: np.ndarray = None
    n_slots: int = 0
    # Loss-head output buffer slots: only the LAST device's final-round
    # ops need their stage output y kept for the loss vjp, so they get a
    # compact secondary ring (-1 everywhere else) — sizing y storage to
    # the loss stage's in-flight peak instead of n_slots on every device.
    fy_slot: np.ndarray = None
    by_slot: np.ndarray = None
    n_y_slots: int = 1

    def live_peaks(self) -> List[int]:
        """Per device, the most (round, mb) sets live at once (between a
        virtual stage's F and its B; a tick's F counts before its B)."""
        peaks = []
        for d in range(self.S):
            live = set()
            peak = 0
            for t in range(self.T):
                if self.f_mb[d, t] >= 0:
                    live.add((self.f_round[d, t], self.f_mb[d, t]))
                    peak = max(peak, len(live))
                if self.b_mb[d, t] >= 0:
                    live.discard((self.b_round[d, t], self.b_mb[d, t]))
            peaks.append(peak)
        return peaks

    def stash_slots(self) -> int:
        """Max residual sets simultaneously live on any device (between a
        virtual stage's F and its B) — the ring-buffer size."""
        return max(self.live_peaks())


def _op_order(S: int, R: int, M: int, d: int):
    """Megatron's per-device op sequence: F order walks microbatch groups
    of S round-major; warmup F count staggers by depth; then 1F1B; B
    order mirrors F order reversed over rounds."""
    f_seq = [(r, g * S + i)
             for g in range(M // S)
             for r in range(R)
             for i in range(S)]
    b_seq = [(R - 1 - r, g * S + i)
             for g in range(M // S)
             for r in range(R)
             for i in range(S)]
    warmup = min((S - d - 1) * 2 + (R - 1) * S, len(f_seq))
    return f_seq, b_seq, warmup


def build_interleaved_1f1b(S: int, R: int, M: int,
                           max_ticks: Optional[int] = None
                           ) -> InterleavedSchedule:
    """Simulate the interleaved-1F1B lockstep and emit slot tables.

    Requires ``M % S == 0`` (Megatron's constraint: microbatch groups of
    exactly S keep the round handoffs aligned).
    """
    if M % S:
        raise ValueError(
            f"interleaved 1F1B needs M % S == 0, got M={M}, S={S} "
            f"(Megatron's microbatch-group constraint)")
    if R < 1:
        raise ValueError(f"rounds must be >= 1, got {R}")
    V = R * S
    total = M * R
    max_ticks = max_ticks or 4 * (M * R + 2 * V)   # generous safety bound

    orders = [_op_order(S, R, M, d) for d in range(S)]
    fi = [0] * S                    # next index into f_seq per device
    bi = [0] * S                    # next index into b_seq per device
    # activations/cotangents available per device: (round, mb) -> ready
    # tick (strictly earlier ticks only are consumable).
    have_act: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(S)]
    have_cot: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(S)]
    f_done: List[set] = [set() for _ in range(S)]

    # Device 0 round 0 feeds from the data: every (0, m) is ready at -1.
    for m in range(M):
        have_act[0][(0, m)] = -1

    cols: List[dict] = []
    done_b = 0
    t = 0
    while done_b < S * total:
        if t >= max_ticks:
            raise RuntimeError(
                f"interleaved 1F1B schedule did not converge within "
                f"{max_ticks} ticks (S={S}, R={R}, M={M}) — simulator bug")
        col = {k: [-1] * S for k in ("fr", "fm", "br", "bm",
                                     "sr", "sm", "tr", "tm")}
        # --- decide slots for this tick -------------------------------
        for d in range(S):
            f_seq, b_seq, warmup = orders[d]
            # B slot first (steady-state priority: drain before fill).
            if bi[d] < len(b_seq):
                r, m = b_seq[bi[d]]
                sigma = r * S + d
                own_f = (r, m) in f_done[d]
                ct_ok = (sigma == V - 1) or \
                    have_cot[d].get((r, m), t) < t
                # 1F1B alternation: B runs only once warmup Fs are done.
                warm_ok = fi[d] >= min(warmup + bi[d] + 1, len(f_seq))
                if own_f and ct_ok and warm_ok:
                    col["br"][d], col["bm"][d] = r, m
            if fi[d] < len(f_seq):
                r, m = f_seq[fi[d]]
                if have_act[d].get((r, m), t) < t:
                    col["fr"][d], col["fm"][d] = r, m
        # --- commit + route traffic -----------------------------------
        for d in range(S):
            r, m = col["fr"][d], col["fm"][d]
            if m >= 0:
                fi[d] += 1
                f_done[d].add((r, m))
                sigma = r * S + d
                if sigma < V - 1:
                    # ship activation forward on the ring (wrap edge
                    # increments the round).
                    nd = (d + 1) % S
                    nr = r if d < S - 1 else r + 1
                    col["sr"][d], col["sm"][d] = nr, m
                    have_act[nd][(nr, m)] = t
            r, m = col["br"][d], col["bm"][d]
            if m >= 0:
                bi[d] += 1
                done_b += 1
                sigma = r * S + d
                if sigma > 0:
                    nd = (d - 1) % S
                    nr = r if d > 0 else r - 1
                    col["tr"][d], col["tm"][d] = nr, m
                    have_cot[nd][(nr, m)] = t
        cols.append(col)
        t += 1

    T = len(cols)

    def tab(key):
        return np.array([[cols[t][key][d] for t in range(T)]
                         for d in range(S)], np.int32)

    sched = InterleavedSchedule(
        S=S, R=R, M=M, T=T,
        f_round=tab("fr"), f_mb=tab("fm"),
        b_round=tab("br"), b_mb=tab("bm"),
        send_round=tab("sr"), send_mb=tab("sm"),
        bsend_round=tab("tr"), bsend_mb=tab("tm"))
    _derive_recv(sched)
    _assign_slots(sched)
    _verify(sched)
    return sched


def _derive_recv(s: InterleavedSchedule) -> None:
    """Receive labels = the upstream sender's send labels, same tick
    (device d receives forward traffic from (d-1) % S, backward from
    (d+1) % S)."""
    fwd_src = [(d - 1) % s.S for d in range(s.S)]
    bwd_src = [(d + 1) % s.S for d in range(s.S)]
    s.recv_round = s.send_round[fwd_src]
    s.recv_mb = s.send_mb[fwd_src]
    s.brecv_round = s.bsend_round[bwd_src]
    s.brecv_mb = s.bsend_mb[bwd_src]


def _assign_slots(s: InterleavedSchedule) -> None:
    """Greedy free-list slot assignment for the residual ring: F writes a
    slot, the matching B frees it. Slot count = peak in-flight ops."""
    n_slots = s.stash_slots()
    s.f_slot = np.full((s.S, s.T), -1, np.int32)
    s.b_slot = np.full((s.S, s.T), -1, np.int32)
    s.n_slots = n_slots
    for d in range(s.S):
        free = list(range(n_slots))[::-1]
        owner: Dict[Tuple[int, int], int] = {}
        for t in range(s.T):
            if s.f_mb[d, t] >= 0:
                slot = free.pop()
                owner[(s.f_round[d, t], s.f_mb[d, t])] = slot
                s.f_slot[d, t] = slot
            if s.b_mb[d, t] >= 0:
                slot = owner.pop((s.b_round[d, t], s.b_mb[d, t]))
                s.b_slot[d, t] = slot
                free.append(slot)

    # Secondary ring for the loss head's y: last device, final round only.
    s.fy_slot = np.full((s.S, s.T), -1, np.int32)
    s.by_slot = np.full((s.S, s.T), -1, np.int32)
    d = s.S - 1
    peak = 0
    live: Dict[Tuple[int, int], int] = {}
    for t in range(s.T):
        if s.f_mb[d, t] >= 0 and s.f_round[d, t] == s.R - 1:
            live[(s.R - 1, s.f_mb[d, t])] = t
            peak = max(peak, len(live))
        if s.b_mb[d, t] >= 0 and s.b_round[d, t] == s.R - 1:
            live.pop((s.R - 1, s.b_mb[d, t]))
    s.n_y_slots = max(peak, 1)
    free = list(range(s.n_y_slots))[::-1]
    owner = {}
    for t in range(s.T):
        if s.f_mb[d, t] >= 0 and s.f_round[d, t] == s.R - 1:
            slot = free.pop()
            owner[s.f_mb[d, t]] = slot
            s.fy_slot[d, t] = slot
        if s.b_mb[d, t] >= 0 and s.b_round[d, t] == s.R - 1:
            s.by_slot[d, t] = owner.pop(s.b_mb[d, t])
            free.append(s.by_slot[d, t])


def _verify(s: InterleavedSchedule) -> None:
    """Structural invariants — raise loudly rather than run a wrong
    schedule."""
    for d in range(s.S):
        fs = [(s.f_round[d, t], s.f_mb[d, t]) for t in range(s.T)
              if s.f_mb[d, t] >= 0]
        bs = [(s.b_round[d, t], s.b_mb[d, t]) for t in range(s.T)
              if s.b_mb[d, t] >= 0]
        want = {(r, m) for r in range(s.R) for m in range(s.M)}
        if set(fs) != want or len(fs) != len(want):
            raise RuntimeError(f"device {d}: F slots {len(fs)} != "
                               f"{len(want)} unique ops")
        if set(bs) != want or len(bs) != len(want):
            raise RuntimeError(f"device {d}: B slots wrong")
        # B after own F, per (round, mb)
        f_at = {op: t for t, op in
                [(t, (s.f_round[d, t], s.f_mb[d, t]))
                 for t in range(s.T) if s.f_mb[d, t] >= 0]}
        for t in range(s.T):
            if s.b_mb[d, t] >= 0:
                op = (s.b_round[d, t], s.b_mb[d, t])
                if f_at[op] > t:
                    raise RuntimeError(
                        f"device {d}: B of {op} at {t} before its F")

    # Activation/cotangent buffers are (R, S): round x (mb % S). Verify a
    # payload is never overwritten before its consumer reads it, and that
    # every non-feed consumption was delivered at a strictly earlier tick.
    for kind, recv_r, recv_m, use_r, use_m, skip_first in (
            ("act", s.recv_round, s.recv_mb, s.f_round, s.f_mb, True),
            ("cot", s.brecv_round, s.brecv_mb, s.b_round, s.b_mb, True)):
        V = s.R * s.S
        for d in range(s.S):
            buf: Dict[Tuple[int, int], Tuple[int, int]] = {}
            for t in range(s.T):
                # consume BEFORE this tick's arrival lands (arrivals are
                # consumable from t+1)
                if use_m[d, t] >= 0:
                    r, m = int(use_r[d, t]), int(use_m[d, t])
                    sigma = r * s.S + d
                    is_feed = (kind == "act" and sigma == 0) or \
                        (kind == "cot" and sigma == V - 1)
                    if not is_feed:
                        got = buf.pop((r, m % s.S), None)
                        if got is None or got != (r, m):
                            raise RuntimeError(
                                f"device {d} tick {t}: {kind} buffer slot "
                                f"({r},{m % s.S}) holds {got}, needed "
                                f"({r},{m})")
                if recv_m[d, t] >= 0:
                    r, m = int(recv_r[d, t]), int(recv_m[d, t])
                    key = (r, m % s.S)
                    if key in buf:
                        raise RuntimeError(
                            f"device {d} tick {t}: {kind} buffer slot "
                            f"{key} overwritten while holding "
                            f"{buf[key]} (new ({r},{m}))")
                    buf[key] = (r, m)
