"""Pipeline parallelism: GPipe, 1F1B and their interleaved forms over a
line of ranks.

Port of ``horovod_tpu/parallel/pipeline.py``. The reference runs a schedule
as one ``lax.scan`` inside ``shard_map``, one device a stage, and hops
activations with ``lax.ppermute``. Here one process is a stage: the ranks
of a process set (``process_set=`` takes the place of the reference's
``axis_name``; default the global set, a mesh's ``mesh.process_set("pp")``
for a pp line) are stages 0..S-1 in the set's rank order, and a tick's
hops go through :class:`Line`: one grouped ``dist.batch_isend_irecv`` of
everything the tick sends and receives (the activation to stage s + 1, the
cotangent to stage s - 1), so neighbours that exchange both ways in one
tick do not deadlock on NCCL. For GPipe and 1F1B the line's ends are open:
the last stage sends nothing forward and stage 0 receives nothing, as the
reference's ``fwd_perm`` drops that edge. The interleaved schedules wrap
it into a ring.

Schedules. With S stages and M microbatches, GPipe runs M + S - 1 ticks
forward and as many backward; at tick t stage s runs microbatch t - s.
Its bubble is (S - 1) / (M + S - 1), and it keeps the autograd graphs of
all M microbatches until the backward. :func:`pipeline_1f1b` runs M +
2(S - 1) ticks of one forward and one backward: stage s runs the forward
of microbatch t - s and the backward of microbatch t - 2(S - 1) + s, so
it holds at most min(2(S - 1 - s) + 1, M) graphs at once. A stage that is
idle in a tick computes nothing (the reference's SPMD program runs
``stage_fn`` on zeros there); every send it posts still meets its
receive, because both ends of a hop derive it from the same tick.

Interleaved schedules. Rank d holds R *virtual stages*, rounds r = 0..R-1
of the depth-R·S pipeline (virtual stage r·S + d), as the leading axis of
its ``stage_params`` leaves. The activation of virtual stage r·S + S - 1
goes from the last rank to rank 0 at round r + 1, and its cotangent back
the same way: the line is a ring (``Line(process_set, wrap=True)``).
:func:`pipeline_loss_interleaved` is GPipe on that ring (at tick t rank d
runs round (t - d) // S of microbatch (t - d) % S), M <= S microbatches at
a time: more are run as chunks of S, one after the other.
:func:`pipeline_interleaved_1f1b` runs Megatron's interleaved 1F1B from
the tables of ``schedule_sim.build_interleaved_1f1b``: each rank reads
its own row (which (round, microbatch) its forward and backward slots run
at each tick, which hops the tick carries), and both ends of a hop read
the same tables. At S = 2 a rank's forward and backward hops go to the
same peer, and NCCL and gloo match a pair's sends and receives in the
order they are posted, so every rank posts the forward hop first. At S =
1 a hop goes from the rank to itself and is handed over without a send.

Autograd. :func:`pipeline_loss` returns the loss replicated over the line
and differentiable: run ``loss.backward()`` (or ``torch.autograd.grad``)
on every stage, and each stage's parameters get their gradient while the
cotangents hop backward. Only the last stage's loss seeds the backward
(the reference's ``_graft_last_stage_loss``): a differentiable allreduce
of the loss would sum S unit cotangents and give S times the gradient.
The backward is the GPipe schedule reversed, driven inside one autograd
node a stage, so its hops keep the forward's order. The 1F1B steps have
no outer backward: they return the loss and the gradients.

The saved residuals are torch's: a stage's graph saves references to its
weights, not copies, so the 1F1B stash holds the activations of the
microbatches in flight and nothing else (the reference's
``_x_dependent_leaf_mask``, which keeps weight-only residuals out of its
ring buffer, has no counterpart).
"""

from __future__ import annotations

import functools
import inspect
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch.ops.ring_attention import Ring
from horovod_tpu_torch.parallel.schedule_sim import build_interleaved_1f1b

__all__ = ["Line", "pipeline_apply", "pipeline_loss",
           "pipeline_loss_interleaved", "pipeline_1f1b",
           "pipeline_interleaved_1f1b", "chunkable_loss"]


# ---------------------------------------------------------------------------
# Transport: the hops of one tick along the line of a process set
# ---------------------------------------------------------------------------

class Line(Ring):
    """A process set seen as a pipeline: a :class:`Ring`, this rank's stage
    ``rank`` of ``n`` and the global ranks of the previous and next stages.
    Its ends are open (None) unless ``wrap``: the interleaved schedules hop
    from the last stage to stage 0 and back."""

    wrap = False

    def __init__(self, process_set=None, wrap: bool = False):
        super().__init__(process_set)
        self.wrap = wrap
        if not wrap:
            if self.rank == 0:
                self.prev = None
            if self.rank == self.n - 1:
                self.next = None

    @classmethod
    def of(cls, process_set=None, wrap: bool = False) -> "Line":
        """``process_set`` when it is a line already (open, or wrapped as
        ``wrap`` asks), else the line of that set (default: the global
        set)."""
        if isinstance(process_set, cls):
            if process_set.wrap != wrap:
                raise ValueError("the interleaved schedules hop on a wrapped "
                                 "line (Line(process_set, wrap=True)), GPipe "
                                 "and 1F1B on an open one")
            return process_set
        return cls(process_set, wrap)

    def exchange(self, fwd: Optional[torch.Tensor] = None,
                 bwd: Optional[torch.Tensor] = None,
                 recv_fwd: Optional[torch.Tensor] = None,
                 recv_bwd: Optional[torch.Tensor] = None) -> tuple:
        """One tick's hops in one ``batch_isend_irecv``: ``fwd`` to the next
        stage, ``bwd`` to the previous one, and a tensor shaped like
        ``recv_fwd`` from the previous stage and one like ``recv_bwd`` from
        the next. Returns (from the previous stage, from the next), None
        where nothing was asked; waits for the hops (on NCCL the current
        stream waits, the host does not). On a one-stage ring a hop is
        handed over to this rank without a send."""
        if (fwd is not None or recv_bwd is not None) and self.next is None:
            raise ValueError("the last stage has no next stage")
        if (bwd is not None or recv_fwd is not None) and self.prev is None:
            raise ValueError("stage 0 has no previous stage")
        if self.n == 1:
            if (fwd is None) != (recv_fwd is None) \
                    or (bwd is None) != (recv_bwd is None):
                raise ValueError("a one-stage ring sends each hop to itself:"
                                 " it must receive what it sends in the same "
                                 "tick")
            return fwd, bwd
        return self._run(self._posts(fwd, bwd, recv_fwd, recv_bwd))

    def _posts(self, fwd, bwd, recv_fwd, recv_bwd) -> list:
        """The tick's point-to-point operations in the order they are
        posted: ``(dist.isend or dist.irecv, tensor, peer, "fwd" or
        "bwd")``, the forward hop before the backward one each way. A pair
        of ranks matches its sends and receives in this order (NCCL and
        gloo alike), and at S = 2 both hops go to the same peer."""
        posts = [(dist.isend, t.contiguous(), to, way)
                 for t, to, way in ((fwd, self.next, "fwd"),
                                    (bwd, self.prev, "bwd"))
                 if t is not None]
        posts += [(dist.irecv, torch.empty(like.shape, dtype=like.dtype,
                                           device=like.device), frm, way)
                  for like, frm, way in ((recv_fwd, self.prev, "fwd"),
                                         (recv_bwd, self.next, "bwd"))
                  if like is not None]
        return posts

    def _run(self, posts: list) -> tuple:
        """Posts ``posts`` in one ``batch_isend_irecv`` and waits; returns
        what arrived (from the previous stage, from the next)."""
        if posts:
            ops = [dist.P2POp(op, t, peer, self.group)
                   for op, t, peer, _ in posts]
            self._collective._ensure_p2p(self.ps, ops[0].tensor)
            # The sent tensors stay referenced by ``ops`` until the wait.
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        got = {way: t for op, t, _, way in posts if op is dist.irecv}
        return got.get("fwd"), got.get("bwd")

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the line (no gradient): an in-step
        allreduce, as the reference's in-program ``psum``."""
        if self.n == 1:
            return x.clone()
        from horovod_tpu_torch import collective as C
        return C._in_step_allreduce(x.contiguous(), C.Sum, self.ps,
                                    name="pipeline/psum")


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def _apply_stage(stage_fn: Callable, params, x: torch.Tensor):
    y = stage_fn(params, x)
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"stage_fn must keep its input's shape and dtype "
                         f"{tuple(x.shape)} {x.dtype}; got {tuple(y.shape)} "
                         f"{y.dtype}")
    return y


def _leaf(x: torch.Tensor, grad: bool) -> torch.Tensor:
    """``x`` cut from its graph, as a leaf that records a gradient when
    ``grad`` (floating tensors only)."""
    return x.detach().requires_grad_(grad and x.is_floating_point())


def _accumulate(acc: list, grads) -> None:
    for i, g in enumerate(grads):
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def _tick_slot(t: int, d: int, S: int, R: int, mc: int):
    """The (round, microbatch) stage ``d`` runs at tick ``t`` of a GPipe run
    of ``mc`` microbatches over ``R`` rounds of the line, or None when it
    is idle (the reference's ``active``). R = 1 is plain GPipe (microbatch
    t - d); R > 1 the circular schedule (mc <= S): round (t - d) // S of
    microbatch (t - d) % S."""
    period = max(S, mc)
    rel = t - d
    if 0 <= rel < R * period and rel % period < mc:
        return divmod(rel, period)
    return None


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one stage, plain or circular: forward over the
    ticks, keeping each microbatch's graph; backward over the ticks
    reversed, the cotangents hopping to the previous stage. Its output is
    the last stage's (M, mb, ...) outputs there and a scalar zero
    elsewhere, whose cotangent only starts the stage's backward.

    ``rounds`` None: the leaves are the stage's parameters and the line is
    open. Else the leaves are ``(rounds, ...)``, round r's slice is virtual
    stage r·S + d's, the line wraps, and the microbatches run in chunks of
    at most S, one after the other (the reference's chunking)."""

    @staticmethod
    def forward(ctx, run, microbatches, *leaves):
        stage_fn, spec, line, rounds = run
        S, d, M = line.n, line.rank, microbatches.shape[0]
        like = microbatches[0]
        ctx.line, ctx.M, ctx.like, ctx.rounds = line, M, like, rounds
        ctx.mb_grad = ctx.needs_input_grad[1]
        grad = ctx.needs_input_grad[2:]
        ctx.leaves = ([[_leaf(p, g) for p, g in zip(leaves, grad)]]
                      if rounds is None else
                      [[_leaf(p[r], g) for p, g in zip(leaves, grad)]
                       for r in range(rounds)])
        params = [pytree.tree_unflatten(ls, spec) for ls in ctx.leaves]
        R = len(params)
        ctx.chunks = ([(0, M)] if rounds is None else
                      [(c, min(S, M - c)) for c in range(0, M, S)])
        ctx.stash, out = {}, [None] * M
        # Graphs are kept only for a backward (not under no_grad).
        with torch.set_grad_enabled(any(ctx.needs_input_grad)):
            for start, mc in ctx.chunks:
                act = None
                for t in range(mc + R * S - 1):
                    slot, y, final = _tick_slot(t, d, S, R, mc), None, False
                    if slot is not None:
                        r, m = slot
                        feed, final = d == 0 and r == 0, \
                            d == S - 1 and r == R - 1
                        x = _leaf(microbatches[start + m] if feed else act,
                                  not feed or ctx.mb_grad)
                        y = _apply_stage(stage_fn, params[r], x)
                        ctx.stash[(start, r, m)] = (x, y)
                        if final:
                            out[start + m] = y.detach()
                    nxt = _tick_slot(t + 1, d, S, R, mc)
                    act, _ = line.exchange(
                        fwd=None if y is None or final else y.detach(),
                        recv_fwd=like if nxt is not None
                        and not (d == 0 and nxt[0] == 0) else None)
        if d == S - 1:
            return torch.stack(out)
        return torch.zeros((), dtype=torch.float32, device=like.device)

    @staticmethod
    def backward(ctx, g_out):
        line, M, like = ctx.line, ctx.M, ctx.like
        S, d, R = line.n, line.rank, len(ctx.leaves)
        want = [[p for p in ls if p.requires_grad] for ls in ctx.leaves]
        grads = [[None] * len(w) for w in want]
        g_mb = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                           device=like.device) if ctx.mb_grad else None
        with torch.enable_grad():
            for start, mc in reversed(ctx.chunks):
                cot = None
                for t in reversed(range(mc + R * S - 1)):
                    slot, gx, feed = _tick_slot(t, d, S, R, mc), None, False
                    if slot is not None:
                        r, m = slot
                        feed = d == 0 and r == 0
                        x, y = ctx.stash.pop((start, r, m))
                        inputs = ([x] if x.requires_grad else []) + want[r]
                        gs = torch.autograd.grad(
                            y, inputs, g_out[start + m]
                            if d == S - 1 and r == R - 1 else cot,
                            allow_unused=True)
                        if x.requires_grad:
                            gx, gs = gs[0], gs[1:]
                            if feed:
                                g_mb[start + m] = gx
                        _accumulate(grads[r], gs)
                    prv = _tick_slot(t - 1, d, S, R, mc)
                    _, cot = line.exchange(
                        bwd=gx if gx is not None and not feed else None,
                        recv_bwd=like if prv is not None
                        and not (d == S - 1 and prv[0] == R - 1) else None)
        its = [iter(g) for g in grads]
        out = []
        for i, p in enumerate(ctx.leaves[0]):
            if not p.requires_grad:
                out.append(None)
                continue
            gs = [next(it) for it in its]
            if ctx.rounds is None:
                out.append(gs[0])
            else:
                out.append(torch.stack([
                    torch.zeros_like(ls[i]) if g is None else g
                    for ls, g in zip(ctx.leaves, gs)]))
        ctx.leaves = ctx.stash = None
        return (None, g_mb, *out)


def _gpipe(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
           line: Line, rounds: Optional[int] = None) -> torch.Tensor:
    leaves, spec = pytree.tree_flatten(stage_params)
    return _GPipe.apply((stage_fn, spec, line, rounds), microbatches,
                        *leaves)


class _FromLast(torch.autograd.Function):
    """The last stage's (M, mb, ...) outputs on every stage: the sum over
    the line of the outputs there and zeros elsewhere. Its backward sums
    the cotangents over the line into the last stage, as the transpose of
    the reference's ``psum`` does."""

    @staticmethod
    def forward(ctx, line, out, like):
        ctx.line = line
        last = line.rank == line.n - 1
        return line.psum(out if last else torch.zeros_like(like))

    @staticmethod
    def backward(ctx, g):
        g = ctx.line.psum(g)
        if ctx.line.rank != ctx.line.n - 1:
            # The cotangent of the other stages' scalar stand-in.
            g = torch.zeros((), dtype=torch.float32, device=g.device)
        return None, g, None


def pipeline_apply(stage_fn: Callable, stage_params,
                   microbatches: torch.Tensor,
                   process_set=None) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline over the line of
    ``process_set`` (a process set, or a :class:`Line`; default the
    global set): the forward / inference path.

    Args:
      stage_fn: ``(stage_params, x) -> y`` with ``y`` of ``x``'s shape and
        dtype (the transformer-block contract).
      stage_params: this stage's parameters (a tensor or a tree of them).
      microbatches: (M, mb, ...): the whole microbatched input; only stage
        0 reads its values, the other stages its shape and dtype.

    Returns (M, mb, ...): the last stage's outputs, on every stage.
    Differentiated, the cotangents are summed over the line first, as the
    reference's broadcast by ``psum`` gives them: a loss of the outputs
    taken on every stage trains with S times the gradient. Use
    :func:`pipeline_loss` to train.
    """
    line = Line.of(process_set)
    out = _gpipe(stage_fn, stage_params, microbatches, line)
    return _FromLast.apply(line, out, microbatches)


def _loss_takes_start(loss_fn) -> bool:
    """Does ``loss_fn`` take the two-argument ``(outputs, mb_start)`` form?
    True when it is marked (``_hvd_mb_start``) or its second positional
    parameter is named ``mb_start``; a ``loss(outputs, weights)`` does not
    opt in."""
    if getattr(loss_fn, "_hvd_mb_start", False):
        return True
    try:
        params = inspect.signature(loss_fn).parameters.values()
    except (TypeError, ValueError):
        return False
    positional = [p for p in params if p.kind in
                  (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2 and positional[1].name == "mb_start"


def pipeline_loss(stage_fn: Callable, stage_params,
                  microbatches: torch.Tensor, loss_fn: Callable,
                  process_set=None) -> torch.Tensor:
    """GPipe forward and loss with correct gradients (the training path).

    ``loss_fn(outputs)`` (or ``loss_fn(outputs, mb_start)``, given 0) runs
    on the last stage only, on its (M, mb, ...) outputs. The returned fp32
    scalar is that loss on every stage of the line, and differentiable:
    run its backward on every stage. Only the last stage's copy seeds the
    backward (the others add the sum as a constant), so each parameter's
    cotangent flows once, with no 1/S scaling. ``loss_fn`` may close over
    the targets; gradients of parameters that every stage holds (an
    embedding on stage 0, a head on the last) are this stage's share:
    sum them over the line.
    """
    line = Line.of(process_set)
    out = _gpipe(stage_fn, stage_params, microbatches, line)
    if line.rank == line.n - 1:
        local = (loss_fn(out, 0) if _loss_takes_start(loss_fn)
                 else loss_fn(out)).float()
    else:
        local = out
    return _graft_last_stage_loss(local, line)


def pipeline_loss_interleaved(stage_fn: Callable, stage_params,
                              microbatches: torch.Tensor, loss_fn: Callable,
                              process_set=None) -> torch.Tensor:
    """The interleaved (circular) GPipe schedule and its loss over the
    ring of ``process_set`` (a process set, or a wrapped :class:`Line`;
    default the global set): Megatron's interleaved layout, trained as
    :func:`pipeline_loss` trains.

    Rank d holds R virtual stages, rounds r = 0..R-1 of the depth-R·S
    pipeline (virtual stage r·S + d), as the leading axis of its
    ``stage_params`` leaves (``(R, ...)``; round r's slice goes to
    ``stage_fn``). Activations hop on the ring: after virtual stage r·S +
    S - 1 the microbatch comes back to rank 0 at round r + 1. The bubble is
    1 - R·M / (M + R·S - 1): at M = S about 1 / (R + 1), where plain GPipe
    needs M = 4(S - 1) microbatches for a fifth.

    At most S microbatches fit on the ring at once. M > S are run in
    chunks of S, one after the other, and the loss is the sum of the
    chunks' losses, each weighted by its share of the M microbatches: the
    full batch's loss when ``loss_fn`` is a mean over the microbatch axis.
    Chunking needs the two-argument ``loss_fn(outputs, mb_start)``
    (``mb_start`` the index of ``outputs[0]`` among the M microbatches, so
    the loss can slice its targets): name the second positional
    ``mb_start``, or mark the loss with :func:`chunkable_loss`.
    ``loss_fn`` runs on the last rank only; run the returned loss's
    backward on every rank.
    """
    line = Line.of(process_set, wrap=True)
    S, M = line.n, microbatches.shape[0]
    takes_start = _loss_takes_start(loss_fn)
    if M > S and not takes_start:
        raise ValueError(
            f"interleaved schedule fits at most S={S} microbatches on "
            f"the ring at once; chunking the given M={M} automatically "
            f"needs a loss_fn(outputs, mb_start) so targets can follow "
            f"their chunk. Name the second positional 'mb_start', or —"
            f" for functools.partial / C callables whose signature "
            f"cannot be inspected — mark the loss with "
            f"horovod_tpu_torch.parallel.chunkable_loss")
    rounds = pytree.tree_leaves(stage_params)[0].shape[0]
    out = _gpipe(stage_fn, stage_params, microbatches, line, rounds)
    if line.rank != S - 1:
        local = out
    elif M > S:
        local = torch.zeros((), dtype=torch.float32, device=out.device)
        for start in range(0, M, S):
            chunk = out[start:start + S]
            local = local + (chunk.shape[0] / M) * loss_fn(chunk,
                                                           start).float()
    else:
        local = (loss_fn(out, 0) if takes_start else loss_fn(out)).float()
    return _graft_last_stage_loss(local, line)


def chunkable_loss(loss_fn: Callable) -> Callable:
    """Mark ``loss_fn`` as taking the two-argument ``(outputs, mb_start)``
    form that :func:`pipeline_loss_interleaved` needs to chunk M > S
    microbatches. A ``def loss(outputs, mb_start)`` needs no mark; a
    ``functools.partial`` or a C callable, whose signature cannot be read,
    does::

        loss = hvd.parallel.chunkable_loss(functools.partial(f, cfg))

    Returns ``loss_fn`` itself, marked, or, where it takes no attribute (a
    builtin), a marked function that calls it."""
    try:
        loss_fn._hvd_mb_start = True
        return loss_fn
    except (AttributeError, TypeError):   # builtins reject attributes
        @functools.wraps(loss_fn, assigned=("__doc__",), updated=())
        def wrapped(outputs, mb_start):
            return loss_fn(outputs, mb_start)
        wrapped._hvd_mb_start = True
        return wrapped


def _graft_last_stage_loss(local: torch.Tensor, line: Line) -> torch.Tensor:
    """Forward: the sum over the line of ``local`` (the last stage's loss,
    zero elsewhere). Backward: only ``local`` is differentiated, the sum
    added as a constant, so the last stage alone seeds the backward and
    the other stages' unit cotangents only start their schedules."""
    total = line.psum(local.detach())
    return local + (total - local.detach())


# ---------------------------------------------------------------------------
# 1F1B
# ---------------------------------------------------------------------------

class _OneFOneB:
    """The step :func:`pipeline_1f1b` returns. ``peak_in_flight``: the most
    microbatch graphs this stage held at once in the last call."""

    def __init__(self, stage_fn, per_mb_loss, line):
        self.stage_fn, self.per_mb_loss, self.line = (stage_fn, per_mb_loss,
                                                      line)
        self.peak_in_flight = 0

    def __call__(self, stage_params, loss_params, microbatches):
        line = self.line
        S, s, M = line.n, line.rank, microbatches.shape[0]
        last = s == S - 1
        like = microbatches[0]
        p_leaves, p_spec = pytree.tree_flatten(stage_params)
        p_leaves = [_leaf(p, True) for p in p_leaves]
        params = pytree.tree_unflatten(p_leaves, p_spec)
        p_want = [p for p in p_leaves if p.requires_grad]
        l_leaves, l_spec = pytree.tree_flatten(loss_params)
        l_leaves = [_leaf(p, last) for p in l_leaves]
        l_params = pytree.tree_unflatten(l_leaves, l_spec)
        l_want = [p for p in l_leaves if p.requires_grad]
        g_stage: list = [None] * len(p_want)
        g_loss: list = [None] * len(l_want)
        g_x = torch.zeros_like(microbatches)
        loss_acc = torch.zeros((), dtype=torch.float32, device=like.device)
        stash, act, cot, peak = {}, None, None, 0
        with torch.enable_grad():
            for t in range(M + 2 * (S - 1)):
                # F slot: the forward of microbatch t - s.
                m_f, y = t - s, None
                if 0 <= m_f < M:
                    x = _leaf(microbatches[m_f] if s == 0 else act, True)
                    y = _apply_stage(self.stage_fn, params, x)
                    stash[m_f] = (x, y)
                    peak = max(peak, len(stash))
                # B slot: the backward of microbatch t - 2(S - 1) + s; on
                # the last stage it is this tick's forward.
                m_b, gx = t - 2 * (S - 1) + s, None
                if 0 <= m_b < M:
                    x, yb = stash.pop(m_b)
                    g_in = cot
                    if last:
                        g_in, loss_m = self._loss_slot(l_params, l_want, yb,
                                                       m_b, M, g_loss)
                        loss_acc = loss_acc + loss_m
                    gs = torch.autograd.grad(yb, [x] + p_want, g_in,
                                             allow_unused=True)
                    gx = gs[0]
                    _accumulate(g_stage, gs[1:])
                    if s == 0:
                        g_x[m_b] = gx
                # Hops: the activation forward, the cotangent backward.
                act, cot = line.exchange(
                    fwd=y.detach() if y is not None and not last else None,
                    bwd=gx if gx is not None and s > 0 else None,
                    recv_fwd=like if s > 0 and 0 <= t + 1 - s < M else None,
                    recv_bwd=like if not last
                    and 0 <= t + 1 - 2 * (S - 1) + s < M else None)
        self.peak_in_flight = peak
        loss = line.psum(loss_acc)
        return loss, (_grads_like(p_leaves, g_stage, p_spec),
                      _grads_like(l_leaves, g_loss, l_spec), g_x)

    def _loss_slot(self, l_params, l_want, y, m, M, g_loss):
        """The head of microbatch ``m`` on the last stage: its cotangent
        seeded with 1/M; returns (the cotangent of ``y``, loss / M) and
        adds the head's gradients to ``g_loss``."""
        y = _leaf(y, True)
        loss = self.per_mb_loss(l_params, y, m)
        seed = torch.full((), 1.0 / M, dtype=loss.dtype, device=loss.device)
        gs = torch.autograd.grad(loss, l_want + [y], seed, allow_unused=True)
        _accumulate(g_loss, gs[:-1])
        return gs[-1], loss.detach().float() / M


def _grads_like(leaves, grads, spec):
    """The gradients of ``leaves`` as their tree, zeros where none came."""
    it = iter(grads)
    out = []
    for p in leaves:
        g = next(it) if p.requires_grad else None
        out.append(torch.zeros_like(p) if g is None else g)
    return pytree.tree_unflatten(out, spec)


def pipeline_1f1b(stage_fn: Callable, per_mb_loss: Callable,
                  process_set=None) -> Callable:
    """Build a 1F1B pipeline step over the line of ``process_set`` (a
    process set, or a :class:`Line`; default the global set): the forward
    and the backward scheduled by hand, at most min(2(S - 1 - s) + 1, M)
    microbatch graphs alive on stage s (GPipe keeps M).

    Args:
      stage_fn: ``(stage_params, x) -> y`` with ``y`` of ``x``'s shape and
        dtype.
      per_mb_loss: ``(loss_params, y, m) -> scalar``, microbatch ``m``'s
        loss from the last stage's output ``y``; the loss is the mean over
        the microbatches, so each cotangent is seeded with 1/M. It runs on
        the last stage only, once per microbatch, and must hold no
        collective.

    Returns ``fn(stage_params, loss_params, microbatches) -> (loss,
    (g_stage, g_loss_params, g_microbatches))``, the reference's contract:
    ``loss`` is already the same on every stage; ``g_loss_params`` is
    nonzero on the last stage only and ``g_microbatches`` on stage 0 only
    (sum them over the line to replicate them); ``g_stage`` is this
    stage's. No outer backward: the backward is the schedule. ``fn``'s
    ``peak_in_flight`` is the most microbatch graphs the stage held at once
    in its last call.
    """
    return _OneFOneB(stage_fn, per_mb_loss, Line.of(process_set))


# ---------------------------------------------------------------------------
# Interleaved 1F1B
# ---------------------------------------------------------------------------

class _Interleaved1F1B(_OneFOneB):
    """The step :func:`pipeline_interleaved_1f1b` returns: a table-driven
    executor of ``build_interleaved_1f1b(S, rounds, M)``. ``schedule``: the
    tables of the last call; ``peak_in_flight``: the most (round,
    microbatch) graphs this rank held at once in it, which its row of the
    tables bounds (``schedule.live_peaks()[rank]``)."""

    def __init__(self, stage_fn, per_mb_loss, line, rounds):
        super().__init__(stage_fn, per_mb_loss, line)
        self.rounds, self.schedule = rounds, None

    def __call__(self, stage_params, loss_params, microbatches):
        line, R = self.line, self.rounds
        S, d, M = line.n, line.rank, microbatches.shape[0]
        sched = self.schedule = build_interleaved_1f1b(S, R, M)
        like = microbatches[0]
        p_leaves, p_spec = pytree.tree_flatten(stage_params)
        if any(p.shape[:1] != (R,) for p in p_leaves):
            raise ValueError(f"stage_params leaves must be (rounds, ...) = "
                             f"({R}, ...), one slice a virtual stage")
        rounds = [[_leaf(p[r], True) for p in p_leaves] for r in range(R)]
        params = [pytree.tree_unflatten(ls, p_spec) for ls in rounds]
        want = [[p for p in ls if p.requires_grad] for ls in rounds]
        g_stage = [[None] * len(w) for w in want]
        l_leaves, l_spec = pytree.tree_flatten(loss_params)
        l_leaves = [_leaf(p, d == S - 1) for p in l_leaves]
        l_params = pytree.tree_unflatten(l_leaves, l_spec)
        l_want = [p for p in l_leaves if p.requires_grad]
        g_loss: list = [None] * len(l_want)
        g_x = torch.zeros_like(microbatches)
        loss_acc = torch.zeros((), dtype=torch.float32, device=like.device)
        # Activations and cotangents wait keyed by (round, mb % S), as the
        # reference's (R, S) buffers; the stash by (round, mb).
        stash, act_buf, cot_buf, peak = {}, {}, {}, 0
        row = {k: getattr(sched, k)[d].tolist() for k in (
            "f_round", "f_mb", "b_round", "b_mb", "send_mb", "bsend_mb",
            "recv_round", "recv_mb", "brecv_round", "brecv_mb")}
        with torch.enable_grad():
            for t in range(sched.T):
                # F slot.
                r, m, y = row["f_round"][t], row["f_mb"][t], None
                if m >= 0:
                    x = _leaf(microbatches[m] if d == 0 and r == 0
                              else act_buf.pop((r, m % S)), True)
                    y = _apply_stage(self.stage_fn, params[r], x)
                    stash[(r, m)] = (x, y)
                    peak = max(peak, len(stash))
                # B slot; the loss head seeds it on the last virtual stage.
                r, m, gx = row["b_round"][t], row["b_mb"][t], None
                if m >= 0:
                    x, yb = stash.pop((r, m))
                    if d == S - 1 and r == R - 1:
                        g_in, loss_m = self._loss_slot(l_params, l_want, yb,
                                                       m, M, g_loss)
                        loss_acc = loss_acc + loss_m
                    else:
                        g_in = cot_buf.pop((r, m % S))
                    gs = torch.autograd.grad(yb, [x] + want[r], g_in,
                                             allow_unused=True)
                    gx = gs[0]
                    _accumulate(g_stage[r], gs[1:])
                    if d == 0 and r == 0:
                        g_x[m] = gx
                # Hops, as the tables say on both ends; the buffers were
                # read above, before this tick's arrivals land.
                act, cot = line.exchange(
                    fwd=y.detach() if row["send_mb"][t] >= 0 else None,
                    bwd=gx if row["bsend_mb"][t] >= 0 else None,
                    recv_fwd=like if row["recv_mb"][t] >= 0 else None,
                    recv_bwd=like if row["brecv_mb"][t] >= 0 else None)
                if act is not None:
                    act_buf[(row["recv_round"][t],
                             row["recv_mb"][t] % S)] = act
                if cot is not None:
                    cot_buf[(row["brecv_round"][t],
                             row["brecv_mb"][t] % S)] = cot
        self.peak_in_flight = peak
        loss = line.psum(loss_acc)
        g_rounds = [_grads_like(ls, g, p_spec)
                    for ls, g in zip(rounds, g_stage)]
        g_stage = pytree.tree_map(lambda *gs: torch.stack(gs), *g_rounds)
        return loss, (g_stage, _grads_like(l_leaves, g_loss, l_spec), g_x)


def pipeline_interleaved_1f1b(stage_fn: Callable, per_mb_loss: Callable,
                              process_set=None, *, rounds: int) -> Callable:
    """Megatron's interleaved 1F1B over the ring of ``process_set`` (a
    process set, or a wrapped :class:`Line`; default the global set): R =
    ``rounds`` virtual stages a rank, as :func:`pipeline_loss_interleaved`
    (the bubble shrinks about R-fold), with the forward and the backward
    scheduled by hand, as :func:`pipeline_1f1b` (the graphs held bounded by
    the schedule's peak in flight, not M·R).

    The schedule is data: ``schedule_sim.build_interleaved_1f1b(S, R, M)``
    simulates it on the host and verifies it, and each rank runs its row:
    at each tick the forward slot, then the backward slot, then the tick's
    hops. Requires M % S == 0 (Megatron's microbatch groups) and
    ``stage_params`` leaves ``(R, ...)`` (the
    ``stack_block_params_interleaved`` layout of a rank).

    The contract is :func:`pipeline_1f1b`'s: ``fn(stage_params,
    loss_params, microbatches) -> (loss, (g_stage, g_loss_params,
    g_microbatches))``, ``loss`` the same on every rank, ``g_loss_params``
    nonzero on the last rank only and ``g_microbatches`` on rank 0 only,
    ``g_stage`` this rank's, ``(R, ...)``. ``per_mb_loss`` runs on the last
    rank's final round only and must hold no collective. ``fn``'s
    ``peak_in_flight`` and ``schedule`` are those of its last call.
    """
    return _Interleaved1F1B(stage_fn, per_mb_loss,
                            Line.of(process_set, wrap=True), rounds)
