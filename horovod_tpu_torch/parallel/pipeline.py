"""Pipeline parallelism: GPipe and 1F1B over a line of ranks.

Port of ``horovod_tpu/parallel/pipeline.py`` (the interleaved schedules,
``pipeline_loss_interleaved``, ``pipeline_interleaved_1f1b`` and
``chunkable_loss``, come with ``ROADMAP.md`` item 8c-ii). The reference runs
a schedule as one ``lax.scan`` inside ``shard_map``, one device a stage, and
hops activations with ``lax.ppermute``. Here one process is a stage: the
ranks of a process set (``process_set=`` takes the place of the
reference's ``axis_name``; default the global set, a mesh's
``mesh.process_set("pp")`` for a pp line) are stages 0..S-1 in the set's
rank order, and a tick's hops go through :class:`Line`: one grouped
``dist.batch_isend_irecv`` of everything the tick sends and receives (the
activation to stage s + 1, the cotangent to stage s - 1), so neighbours
that exchange both ways in one tick do not deadlock on NCCL. A line is not
a ring: the last stage sends nothing forward and stage 0 receives nothing,
as the reference's ``fwd_perm`` drops that edge.

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

Autograd. :func:`pipeline_loss` returns the loss replicated over the line
and differentiable: run ``loss.backward()`` (or ``torch.autograd.grad``)
on every stage, and each stage's parameters get their gradient while the
cotangents hop backward. Only the last stage's loss seeds the backward
(the reference's ``_graft_last_stage_loss``): a differentiable allreduce
of the loss would sum S unit cotangents and give S times the gradient.
The backward is the GPipe schedule reversed, driven inside one autograd
node a stage, so its hops keep the forward's order. :func:`pipeline_1f1b`
has no outer backward: it returns the loss and the gradients.

The saved residuals are torch's: a stage's graph saves references to its
weights, not copies, so the 1F1B stash holds the activations of the
microbatches in flight and nothing else (the reference's
``_x_dependent_leaf_mask``, which keeps weight-only residuals out of its
ring buffer, has no counterpart).
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from horovod_tpu_torch.ops.ring_attention import Ring

__all__ = ["Line", "pipeline_apply", "pipeline_loss", "pipeline_1f1b"]


# ---------------------------------------------------------------------------
# Transport: the hops of one tick along the line of a process set
# ---------------------------------------------------------------------------

class Line(Ring):
    """A process set seen as a pipeline: a :class:`Ring` whose ends are
    open, this rank's stage ``rank`` of ``n`` and the global ranks of the
    previous and next stages (None at the ends)."""

    def __init__(self, process_set=None):
        super().__init__(process_set)
        if self.rank == 0:
            self.prev = None
        if self.rank == self.n - 1:
            self.next = None

    def exchange(self, fwd: Optional[torch.Tensor] = None,
                 bwd: Optional[torch.Tensor] = None,
                 recv_fwd: Optional[torch.Tensor] = None,
                 recv_bwd: Optional[torch.Tensor] = None) -> tuple:
        """One tick's hops in one ``batch_isend_irecv``: ``fwd`` to the next
        stage, ``bwd`` to the previous one, and a tensor shaped like
        ``recv_fwd`` from the previous stage and one like ``recv_bwd`` from
        the next. Returns (from the previous stage, from the next), None
        where nothing was asked; waits for the hops (on NCCL the current
        stream waits, the host does not)."""
        if (fwd is not None or recv_bwd is not None) and self.next is None:
            raise ValueError("the last stage has no next stage")
        if (bwd is not None or recv_fwd is not None) and self.prev is None:
            raise ValueError("stage 0 has no previous stage")
        ops = [dist.P2POp(dist.isend, t.contiguous(), to, self.group)
               for t, to in ((fwd, self.next), (bwd, self.prev))
               if t is not None]
        got: List[Optional[torch.Tensor]] = [None, None]
        for i, (like, frm) in enumerate(((recv_fwd, self.prev),
                                         (recv_bwd, self.next))):
            if like is not None:
                got[i] = torch.empty(like.shape, dtype=like.dtype,
                                     device=like.device)
                ops.append(dist.P2POp(dist.irecv, got[i], frm, self.group))
        if ops:
            self._collective._ensure_p2p(self.ps, ops[0].tensor)
            # The sent tensors stay referenced by ``ops`` until the wait.
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(got)

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


class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one stage: forward over the ticks, keeping
    each microbatch's graph; backward over the ticks reversed, the
    cotangents hopping to the previous stage. Its output is the last
    stage's (M, mb, ...) outputs there and a scalar zero elsewhere, whose
    cotangent only starts the stage's backward."""

    @staticmethod
    def forward(ctx, run, microbatches, *leaves):
        stage_fn, spec, line = run
        S, s, M = line.n, line.rank, microbatches.shape[0]
        like = microbatches[0]
        ctx.line, ctx.M, ctx.like = line, M, like
        ctx.mb_grad = ctx.needs_input_grad[1]
        ctx.leaves = [_leaf(p, g) for p, g in
                      zip(leaves, ctx.needs_input_grad[2:])]
        params = pytree.tree_unflatten(ctx.leaves, spec)
        ctx.stash, act = [], None
        # Graphs are kept only for a backward (not under no_grad).
        with torch.set_grad_enabled(any(ctx.needs_input_grad)):
            for t in range(M + S - 1):
                m, y = t - s, None
                if 0 <= m < M:
                    x = _leaf(microbatches[m] if s == 0 else act,
                              s > 0 or ctx.mb_grad)
                    y = _apply_stage(stage_fn, params, x)
                    ctx.stash.append((x, y))
                act, _ = line.exchange(
                    fwd=y.detach() if y is not None and s < S - 1 else None,
                    recv_fwd=like if s > 0 and 0 <= t + 1 - s < M else None)
        if s == S - 1:
            return torch.stack([y.detach() for _, y in ctx.stash])
        return torch.zeros((), dtype=torch.float32, device=like.device)

    @staticmethod
    def backward(ctx, g_out):
        line, M, like = ctx.line, ctx.M, ctx.like
        S, s = line.n, line.rank
        want = [p for p in ctx.leaves if p.requires_grad]
        grads: list = [None] * len(want)
        g_mb = torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                           device=like.device) if ctx.mb_grad else None
        cot = None
        with torch.enable_grad():
            for t in reversed(range(M + S - 1)):
                m, gx = t - s, None
                if 0 <= m < M:
                    x, y = ctx.stash[m]
                    ctx.stash[m] = None
                    inputs = ([x] if x.requires_grad else []) + want
                    gs = torch.autograd.grad(
                        y, inputs, g_out[m] if s == S - 1 else cot,
                        allow_unused=True)
                    if x.requires_grad:
                        gx, gs = gs[0], gs[1:]
                        if s == 0:
                            g_mb[m] = gx
                    _accumulate(grads, gs)
                _, cot = line.exchange(
                    bwd=gx if s > 0 and gx is not None else None,
                    recv_bwd=like if s < S - 1 and 0 <= t - 1 - s < M
                    else None)
        it = iter(grads)
        out = [next(it) if p.requires_grad else None for p in ctx.leaves]
        ctx.leaves = ctx.stash = None
        return (None, g_mb, *out)


def _gpipe(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
           line: Line) -> torch.Tensor:
    leaves, spec = pytree.tree_flatten(stage_params)
    return _GPipe.apply((stage_fn, spec, line), microbatches, *leaves)


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
