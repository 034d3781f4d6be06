"""Distributed optimizer, the functional step and the start-of-training
broadcasts.

Port of ``horovod_tpu/optimizer.py`` (``allreduce_gradients``, error
feedback, ``DistributedOptimizer``, ``grad``, ``value_and_grad``,
``DistributedGradientTape``, ``AutotunedStep``, ``broadcast_parameters``,
``broadcast_variables``, ``broadcast_optimizer_state``,
``accumulation_has_updated``). ``DistributedOptimizer`` has the shape of
the torch frontend
(``horovod_tpu/torch/__init__.py``): :class:`DistributedOptimizer` wraps any
``torch.optim.Optimizer`` and its ``step()`` first synchronizes every
``.grad`` (one fused, optionally compressed allreduce, written back in
place), then runs the inner step.

``backward_passes_per_step=k`` keeps the reference's semantics: ``step()``
is called after every backward pass; the first k-1 calls only add the
pass's gradients to a local accumulator and leave the parameters alone, the
k-th allreduces the *sum* of the k passes and applies the inner step. Call
``zero_grad()`` between passes, as with any optimizer.

``alive`` is the in-step form of Horovod's join for uneven data (the
reference's join mask, ``allreduce_gradients(alive=)``): a rank that has
run out of data passes ``alive=0`` for the step, contributes zero
gradients, and the average divides by the number of live ranks. The eager
form is ``hvd.join()`` (``collective.py``).

``algorithm`` / ``overlap_chunks`` pick each bucket's lowering
(``overlap.py``, ``collective.allreduce``). ``gradient_predivide_factor``
f is the torch frontend's: prescale 1/f before the sum, postscale f after.

**Error feedback** (``error_feedback=True``; on by default when the
resolved algorithm names a quantized wire): the residual of each parameter
-- what the 1-byte wire dropped of this rank's contribution last step,
``x - dequantize(quantize(x))`` under the wire's per-tensor block geometry
-- is added to the next step's gradient before it is reduced. The
residuals live in the wrapper's ``state_dict()`` and
:func:`reset_error_feedback` zeros them. The quantized wire is
``Compression.int8``/``fp8``, else the algorithm's suffix, else
``HOROVOD_ALLREDUCE_WIRE``; the reference's error feedback does not look at
the compression marker (its residual stays zero under
``Compression.int8``), the port counts it, because the marker path
quantizes each tensor with that same geometry.

**Gradient overlap** (``overlap=True``): a
``register_post_accumulate_grad_hook`` on every parameter packs its
gradient into its bucket of the reference's fusion plan as the backward
produces it; a full bucket is issued at once, last bucket first with the
order pinned (the reference's ``reverse=True, pin_order=True``,
``fusion.BucketFiller``), as an in-step allreduce that takes no
negotiation round (``collective._in_step_bucket_async``), so the
reduction of the last layers runs while the backward still computes the
first. ``step()`` issues
what is left (the buckets of parameters that got no gradient this step,
which contribute zeros, as in the reference), waits for every bucket and
writes the results into ``.grad``. The plan is negotiated once, at the
first step and whenever the tuner changes it: ranks whose plans differ
raise on every rank before any bucket goes out. Under
``backward_passes_per_step=k`` the hooks issue on the k-th backward only.
A parameter carries the hook of one wrapper at a time: a new
``overlap=True`` wrapper over it (the optimizer rebuilt after a checkpoint
load or a reset) removes the earlier wrapper's hook, and
:meth:`DistributedOptimizer.close` removes the wrapper's own. A hook holds
its wrapper weakly, so a dropped wrapper and its bucket buffers are
freed.
The join mask must be known before the backward there: call
:meth:`DistributedOptimizer.set_alive` before ``loss.backward()`` (and
pass the same value to ``step``).

``HOROVOD_AUTOTUNE=1`` tunes the fusion threshold online from the time
between ``synchronize`` calls (``autotune.py``, mode
``HOROVOD_AUTOTUNE_MODE``), one record a step, each new point agreed on
rank 0's by ``broadcast_object`` and the converged point appended to
``HOROVOD_AUTOTUNE_LOG`` by rank 0, as the reference's torch frontend does.
A tuner passed as ``autotuner=`` that tunes the algorithm or the wire
(``BayesianAutotuner(tune_algorithm=True, tune_wire=True)``) has its
picks threaded into the allreduce, as the reference's ``AutotunedStep``
threads them.

``HOROVOD_METRICS_GRAD_NORM=1`` records the global L2 norm of the reduced
gradients in the ``optimizer_grad_norm`` gauge (``metrics.py``) after each
allreduce, as the reference does; reading it back waits for the device, so
it is off by default.
"""

from __future__ import annotations

import json
import time
import weakref
from typing import Dict, Iterable, List, Optional

import torch

from horovod_tpu_torch import collective as C
from horovod_tpu_torch import fusion as _fusion
from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch import overlap as _overlap
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
from horovod_tpu_torch.ops import quantized as _quantized
from horovod_tpu_torch.process_set import ProcessSet

__all__ = ["allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_variables", "reset_error_feedback", "grad",
           "value_and_grad", "DistributedGradientTape",
           "accumulation_has_updated", "AutotunedStep"]


def _maybe_record_grad_norm(grads: List[torch.Tensor]) -> None:
    """The ``optimizer_grad_norm`` gauge: the L2 norm, in fp32, of the
    floating-point gradients (``HOROVOD_METRICS_GRAD_NORM``)."""
    if not get_config().metrics_grad_norm:
        return
    sq = [g.float().square().sum() for g in grads if g.is_floating_point()]
    if sq:
        _metrics.gauge("optimizer_grad_norm").set(
            torch.stack(sq).sum().sqrt().item())


def _effective_quant_wire(algorithm: Optional[str], wire: Optional[str] = None,
                          compression=None) -> Optional[str]:
    """The quantized wire a gradient allreduce will use, or None: the
    compression marker's, else an explicit quantized ``algorithm``'s,
    else the wire (argument or ``HOROVOD_ALLREDUCE_WIRE``) when it is
    ``int8`` or ``fp8``. The reference's does not read the marker (a
    deliberate divergence; see the module docstring)."""
    marker = getattr(compression, "wire", None)
    if marker is not None:
        return marker
    cfg = get_config()
    qw = _overlap.parse_algorithm(algorithm or cfg.allreduce_algorithm)[1]
    if qw is not None:
        return qw
    w = wire if wire is not None else cfg.allreduce_wire
    return w if w in _overlap.QUANT_WIRES else None


def _quantization_residual(t: torch.Tensor, wire: str) -> torch.Tensor:
    """``t - dequantize(quantize(t))`` with blocks from the tensor's first
    element (the wire's per-tensor geometry): the part of this rank's
    contribution the quantized exchange drops locally. The
    re-quantization error of the reduced chunk is shared by all ranks and
    is not folded in, as in the reference. Integer tensors: zeros."""
    if not t.is_floating_point() or t.numel() == 0:
        return torch.zeros_like(t)
    flat = t.reshape(-1).to(torch.float32)
    q, s = _quantized.quantize_blocks(flat, wire)
    return (flat - _quantized.dequantize_blocks(q, s)).view(t.shape) \
        .to(t.dtype)


def allreduce_gradients(grads: List[torch.Tensor], op: int = C.Average,
                        process_set: Optional[ProcessSet] = None,
                        compression=Compression.none,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        fusion_threshold_bytes: Optional[int] = None,
                        alive=None, algorithm: Optional[str] = None,
                        overlap_chunks: Optional[int] = None,
                        overlap: bool = False, error_feedback=None,
                        wire: Optional[str] = None):
    """Fused allreduce of a list of gradients, in place.

    ``alive`` (this rank's 0 or 1, a number or a tensor) is the join mask:
    the number of live ranks ``n_alive`` is the allreduce Sum of ``alive``,
    at least 1; every gradient is multiplied by ``alive`` and reduced with
    Sum; Average then divides by ``n_alive``. It takes Sum and Average
    only. ``algorithm`` / ``overlap_chunks`` pick each bucket's lowering;
    ``overlap=True`` issues the buckets last first (the reference's
    reverse issue order; the backward-overlapped form is
    ``DistributedOptimizer(overlap=True)``). ``wire`` is
    :func:`collective.allreduce`'s (the tuner's wire pick reaches it here).

    ``error_feedback`` (the residuals, one per gradient, zeros at step 0)
    adds each residual into its gradient before the reduction and returns
    ``(grads, new_residuals)``; the new residuals are the quantization
    error of the compensated gradients. With no quantized wire in effect
    they are zeros and the reduction is unchanged."""
    if error_feedback is not None:
        kw = dict(op=op, process_set=process_set, compression=compression,
                  prescale_factor=prescale_factor,
                  postscale_factor=postscale_factor,
                  fusion_threshold_bytes=fusion_threshold_bytes, alive=alive,
                  algorithm=algorithm, overlap_chunks=overlap_chunks,
                  overlap=overlap, wire=wire)
        qwire = _effective_quant_wire(algorithm, wire, compression)
        if qwire is None:
            return (allreduce_gradients(grads, **kw),
                    [torch.zeros_like(r) for r in error_feedback])
        for g, r in zip(grads, error_feedback):
            g.add_(r.to(g.dtype))
        residual = [_quantization_residual(g, qwire) for g in grads]
        return allreduce_gradients(grads, **kw), residual
    kw = dict(process_set=process_set, compression=compression,
              prescale_factor=prescale_factor,
              postscale_factor=postscale_factor,
              fusion_threshold_bytes=fusion_threshold_bytes, out=grads,
              algorithm=algorithm, overlap_chunks=overlap_chunks, wire=wire,
              _reverse_issue=overlap)
    if alive is None:
        out = C.grouped_allreduce(grads, op=op, **kw)
        _maybe_record_grad_norm(out)
        return out
    if op not in (C.Average, C.Sum):
        raise ValueError("join-style allreduce supports Sum/Average only")
    device = grads[0].device if grads else None
    alivef = torch.as_tensor(alive, dtype=torch.float32, device=device)
    n_alive = C.allreduce(alivef, op=C.Sum,
                          process_set=process_set).clamp_min(1.0)
    for g in grads:
        g.mul_(alivef.to(g.dtype))
    C.grouped_allreduce(grads, op=C.Sum, **kw)
    if op == C.Average:
        for g in grads:
            g.div_(n_alive.to(g.dtype))
    _maybe_record_grad_norm(grads)
    return grads


def _make_autotuner():
    """The tuner ``HOROVOD_AUTOTUNE_MODE`` names, as the reference's torch
    frontend makes it."""
    from horovod_tpu_torch.autotune import Autotuner, BayesianAutotuner
    cfg = get_config()
    mode = cfg.autotune_mode
    if mode == "bayes":
        return BayesianAutotuner(probes=cfg.autotune_probes,
                                 samples_per_probe=cfg.autotune_samples)
    if mode == "bayes-compression":
        return BayesianAutotuner(probes=cfg.autotune_probes,
                                 samples_per_probe=cfg.autotune_samples,
                                 tune_compression=True)
    if mode == "ladder":
        return Autotuner()
    raise ValueError(f"HOROVOD_AUTOTUNE_MODE={mode!r}: expected 'ladder', "
                     "'bayes', or 'bayes-compression'")


# id(parameter) -> (weak reference to it, handle of its overlap hook): the
# one DistributedOptimizer(overlap=True) hook each parameter carries.
_OVERLAP_HOOKS: Dict[int, tuple] = {}


def _grad_hook(owner: weakref.ref, i: int):
    def hook(p):
        opt = owner()
        if opt is not None:
            opt._on_grad(i, p)
    return hook


def _hook_parameters(opt, params: List[torch.Tensor]) -> list:
    """Register ``opt``'s post-accumulate-grad hook on every parameter in
    place of the hook an earlier wrapper left there; returns the
    ``(weakref(parameter), handle)`` pairs."""
    for k in [k for k, (ref, _) in _OVERLAP_HOOKS.items() if ref() is None]:
        del _OVERLAP_HOOKS[k]
    owner, hooks = weakref.ref(opt), []
    for i, p in enumerate(params):
        old = _OVERLAP_HOOKS.pop(id(p), None)
        if old is not None and old[0]() is p:
            old[1].remove()
        entry = (weakref.ref(p),
                 p.register_post_accumulate_grad_hook(_grad_hook(owner, i)))
        _OVERLAP_HOOKS[id(p)] = entry
        hooks.append(entry)
    return hooks


def _unhook_parameters(hooks: list) -> None:
    for ref, handle in hooks:
        handle.remove()
        p = ref()
        if p is not None and _OVERLAP_HOOKS.get(id(p)) is not None \
                and _OVERLAP_HOOKS[id(p)][1] is handle:
            del _OVERLAP_HOOKS[id(p)]


class _Overlap:
    """One gradient plan of ``DistributedOptimizer(overlap=True)``: the
    fusion plan of the parameters, the bucket buffers they are packed
    into, the filler that says which bucket may go, and the step's
    handles."""

    def __init__(self, params: List[torch.Tensor], key: tuple,
                 threshold: int, pad: int):
        self.key = key
        self.plan = _fusion.make_plan([p.numel() for p in params],
                                      [p.dtype for p in params], threshold,
                                      pad)
        self.filler = _fusion.BucketFiller(self.plan, reverse=True)
        # (bucket, offset in it, start in the tensor, n) of each tensor.
        self.places: Dict[int, list] = {}
        self.sizes = []
        for b, segs in enumerate(self.plan.buckets):
            off = 0
            for s in segs:
                i, start, n = self.plan.segments[s]
                self.places.setdefault(i, []).append((b, off, start, n))
                off += self.plan.padded_len(s)
            self.sizes.append(off)
        self.dtypes = [params[self.plan.segments[segs[0]][0]].dtype
                       for segs in self.plan.buckets]
        self.device = params[0].device
        self.buffers: List[Optional[torch.Tensor]] = [None] * len(
            self.plan.buckets)
        self.reset()

    def reset(self) -> None:
        self.filler.reset()
        self.handles: Dict[int, C.Handle] = {}
        self.marked: set = set()
        self.begun = False
        self.n_alive = None
        self.issued_in_backward = 0
        self.firings = 0

    def buffer(self, b: int) -> torch.Tensor:
        if self.buffers[b] is None:
            self.buffers[b] = torch.zeros(self.sizes[b], dtype=self.dtypes[b],
                                          device=self.device)
        return self.buffers[b]

    def pack(self, i: int, g: torch.Tensor) -> None:
        flat = g.reshape(-1)
        for b, off, start, n in self.places.get(i, ()):
            self.buffer(b)[off:off + n].copy_(flat[start:start + n])

    def unpack(self, i: int, p: torch.Tensor) -> None:
        flat = torch.empty(p.numel(), dtype=p.dtype, device=p.device)
        for b, off, start, n in self.places.get(i, ()):
            flat[start:start + n].copy_(self.buffers[b][off:off + n])
        if p.grad is None:
            p.grad = flat.view(p.shape)
        else:
            p.grad.copy_(flat.view(p.shape))


class DistributedOptimizer:
    """``hvd.DistributedOptimizer`` around a torch optimizer.

    Everything but ``step``/``synchronize``/``zero_grad``/``state_dict``/
    ``load_state_dict`` is forwarded to the inner optimizer
    (``param_groups``, ``state``...). ``named_parameters`` is accepted for
    upstream's signature and unused: gradients are fused in the
    optimizer's own parameter order. See the module docstring for
    ``algorithm``, ``overlap_chunks``, ``overlap``, ``error_feedback``,
    ``gradient_predivide_factor`` and ``autotuner``.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable] = None,
                 compression=Compression.none, op: int = C.Average,
                 backward_passes_per_step: int = 1,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 fusion_threshold_bytes: Optional[int] = None,
                 gradient_predivide_factor: float = 1.0,
                 algorithm: Optional[str] = None,
                 overlap_chunks: Optional[int] = None,
                 overlap: bool = False,
                 error_feedback: Optional[bool] = None,
                 autotuner=None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        f = float(gradient_predivide_factor)
        if not f > 0:
            raise ValueError("gradient_predivide_factor must be > 0, got "
                             f"{gradient_predivide_factor}")
        C._resolve_axis(algorithm, overlap_chunks, None)
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._prescale = float(prescale_factor) / f
        self._postscale = float(postscale_factor) * f
        self._process_set = process_set
        self._threshold = fusion_threshold_bytes
        self._algorithm = algorithm
        self._chunks = overlap_chunks
        self._k = int(backward_passes_per_step)
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
        self.has_updated = False
        if error_feedback is None:
            error_feedback = _overlap.parse_algorithm(
                algorithm or get_config().allreduce_algorithm)[1] is not None
        self._ef = bool(error_feedback)
        self._residual: Dict[torch.Tensor, torch.Tensor] = {}
        self._autotuner = autotuner
        if autotuner is None and get_config().autotune:
            self._autotuner = _make_autotuner()
        self._last_step_t = None
        self._autotune_synced = False
        self._overlap = bool(overlap)
        self._ov: Optional[_Overlap] = None
        self._alive = None
        # Of the last step under overlap=True: hook firings, buckets issued
        # in the backward, buckets in the plan.
        self.last_overlap: Optional[dict] = None
        self._hooks: list = []
        if self._overlap:
            params = self._params()
            self._ov_params = [p for p in params if p.requires_grad]
            self._hooks = _hook_parameters(self, self._ov_params)
            weakref.finalize(self, _unhook_parameters, self._hooks)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_opt"), name)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self._opt.param_groups for p in g["params"]]

    # -- communication parameters (the tuner's picks when it has them) ----

    def _comm(self) -> tuple:
        """(threshold, algorithm, chunks, wire) for the next reduction."""
        thr, alg, chunks, wire = (self._threshold, self._algorithm,
                                  self._chunks, None)
        t = self._autotuner
        if t is not None:
            thr = t.current_threshold()
            if getattr(t, "_tune_alg", False):
                alg, chunks = t.current_algorithm(), t.current_chunks()
            if getattr(t, "_tune_wire", False):
                wire = t.current_wire()
                alg = _overlap.compose_algorithm(
                    alg or get_config().allreduce_algorithm, wire)
        if thr is None:
            thr = get_config().fusion_threshold_bytes
        return int(thr), alg, chunks, wire

    def _autotune_record(self) -> None:
        """One record a step: the time since the last, then the rank-0
        agreement of a new point, the probed compression, and at
        convergence rank 0's pick and the ``HOROVOD_AUTOTUNE_LOG`` line
        (the reference's torch frontend, ``synchronize``)."""
        t = self._autotuner
        now = time.perf_counter()
        if self._last_step_t is not None:
            t.record(now - self._last_step_t)
        self._last_step_t = now
        if getattr(t, "pending_sync", False):
            t.set_current_point(tuple(C.broadcast_object(
                t.current_point(), root_rank=0)))
        if getattr(t, "_tune_comp", False):
            self._compression = (Compression.fp16
                                 if t.current_compression() == "fp16"
                                 else Compression.none)
        if t.converged and not self._autotune_synced:
            comp = getattr(t, "current_compression", lambda: "none")()
            best, comp = C.broadcast_object(
                (int(t.current_threshold()), comp), root_rank=0)
            t._best = int(best)
            if hasattr(t, "_best_compression"):
                t._best_compression = comp
            if comp == "fp16":
                self._compression = Compression.fp16
            line = {"converged_fusion_threshold_bytes": int(best),
                    "converged_compression": comp}
            if getattr(t, "_tune_alg", False):
                alg, chunks = C.broadcast_object(
                    (t.current_algorithm(), t.current_chunks()), 0)
                t._best_algorithm, t._best_chunks = alg, int(chunks)
                line.update(converged_algorithm=alg,
                            converged_chunks=int(chunks))
            if getattr(t, "_tune_wire", False):
                t._best_wire = C.broadcast_object(t.current_wire(), 0)
                line["converged_wire"] = t._best_wire
            self._autotune_synced = True
            log = get_config().autotune_log
            from horovod_tpu_torch import core
            if log and core.rank() == 0:
                with open(log, "a") as fh:
                    fh.write(json.dumps(line) + "\n")

    # -- the reduction after the backward ----------------------------------

    def _reduce(self, grads: List[torch.Tensor], params, alive) -> None:
        thr, alg, chunks, wire = self._comm()
        kw = dict(op=self._op, process_set=self._process_set,
                  compression=self._compression,
                  prescale_factor=self._prescale,
                  postscale_factor=self._postscale,
                  fusion_threshold_bytes=thr, alive=alive, algorithm=alg,
                  overlap_chunks=chunks, wire=wire)
        if not self._ef:
            allreduce_gradients(grads, **kw)
            return
        residual = [self._residual.get(p) for p in params]
        residual = [torch.zeros_like(g) if r is None else r
                    for g, r in zip(grads, residual)]
        _, new = allreduce_gradients(grads, error_feedback=residual, **kw)
        for p, r in zip(params, new):
            self._residual[p] = r

    def synchronize(self, alive=None) -> None:
        """Allreduce every ``.grad`` now (one fused collective per fusion
        bucket) and write the results back into ``.grad``; ``alive`` is
        this rank's join mask (:func:`allreduce_gradients`). Under
        ``overlap=True``: issue what the backward left, wait for every
        bucket and write the results back."""
        if self._overlap:
            # The step's buckets went out under the current plan: finish
            # them before the tuner may change it.
            self._overlap_finish(alive)
            if self._autotuner is not None:
                self._autotune_record()
            return
        if self._autotuner is not None:
            self._autotune_record()
        params = [p for p in self._params() if p.grad is not None]
        if params:
            self._reduce([p.grad for p in params], params, alive)

    def step(self, closure=None, alive=None):
        """Synchronize the gradients, then run the inner step. ``alive``
        (0 or 1) is this rank's join mask for this step; with
        ``backward_passes_per_step > 1`` the k-th call's mask applies to
        the accumulated gradients and earlier calls' are not used. Without
        ``alive`` the value of :meth:`set_alive` applies, if any."""
        if alive is None:
            alive = self._alive
        if self._k > 1:
            self._passes += 1
            # Under overlap the hooks add the earlier passes' sum on the
            # k-th backward.
            if self._passes < self._k or not self._overlap:
                for p in self._params():
                    if p.grad is None:
                        continue
                    acc = self._acc.get(p)
                    if acc is None:
                        self._acc[p] = p.grad.detach().clone()
                    else:
                        acc.add_(p.grad)
            if self._passes < self._k:
                self.has_updated = False
                return None
            self._passes = 0
            if not self._overlap:
                for p in self._params():
                    if p in self._acc:
                        p.grad = self._acc.pop(p)
        self.synchronize(alive)
        self._alive = None
        self.has_updated = True
        return self._opt.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._opt.zero_grad(set_to_none=set_to_none)

    def close(self) -> None:
        """Remove the gradient hooks of ``overlap=True`` and free the
        bucket buffers. A later ``step()`` still reduces the gradients,
        all of them at the step, as if none had arrived in the backward."""
        _unhook_parameters(self._hooks)
        self._ov = None

    # -- error-feedback state ----------------------------------------------

    def state_dict(self) -> dict:
        """The inner optimizer's state dict, plus the error-feedback
        residuals (one per parameter, in parameter order, None where a
        parameter has none yet) when error feedback is on."""
        sd = self._opt.state_dict()
        if self._ef:
            sd["error_feedback"] = [self._residual.get(p)
                                    for p in self._params()]
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        sd = dict(state_dict)
        res = sd.pop("error_feedback", None)
        self._opt.load_state_dict(sd)
        self._residual = {}
        if res is not None:
            for p, r in zip(self._params(), res):
                if r is not None:
                    self._residual[p] = r.to(device=p.device).clone()

    # -- gradient overlap ----------------------------------------------------

    def set_alive(self, alive) -> None:
        """This rank's join mask (0 or 1) for the coming step; under
        ``overlap=True`` the hooks need it before the gradients go out, so
        it must be set before the backward."""
        self._alive = alive

    def _ov_state(self) -> _Overlap:
        thr, alg, chunks, wire = self._comm()
        alg_r, chunks_r, wire_r = C._resolve_axis(alg, chunks, wire)
        quant = (getattr(self._compression, "wire", None) is not None
                 or _overlap.parse_algorithm(alg_r)[1] is not None
                 or wire_r in _overlap.QUANT_WIRES)
        key = (thr, alg_r, chunks_r, wire_r, self._compression.__name__)
        if self._ov is None or self._ov.key != key:
            self._ov = _Overlap(self._ov_params, key, thr,
                                _quantized.BLOCK if quant else 1)
            ps = self._process_set
            # One round for a new plan: a rank whose plan differs raises
            # on every rank before any bucket goes out.
            C._negotiate("overlap_plan", (
                tuple((tuple(p.shape), C._dtype_name(p.dtype))
                      for p in self._ov_params),
                self._op, None if ps is None else C._ps_key(ps),
                self._prescale, self._postscale) + key)
            _metrics.gauge("overlap_buckets").set(len(self._ov.plan.buckets))
        return self._ov

    def _included(self) -> bool:
        return self._process_set is None or self._process_set.included()

    def _begin(self) -> _Overlap:
        """The first gradient of a step: the plan (negotiated when new)
        and, under a join mask, the count of live ranks (in-step)."""
        st = self._ov_state()
        if not st.begun:
            st.begun = True
            if self._alive is not None:
                if self._op not in (C.Average, C.Sum):
                    raise ValueError(
                        "join-style allreduce supports Sum/Average only")
                a = torch.as_tensor(self._alive, dtype=torch.float32,
                                    device=st.device).reshape(1)
                st.n_alive = C._in_step_allreduce_async(
                    [a], C.Sum, self._ps(), algorithm="psum")
        return st

    def _ps(self) -> ProcessSet:
        return C._resolve_ps(self._process_set)

    def _contribution(self, st: _Overlap, p: torch.Tensor,
                      g: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's value of one gradient for the step: the earlier
        passes' sum added, the error-feedback residual added (and the new
        one kept), the join mask applied."""
        if g is None:
            g = torch.zeros_like(p)
        acc = self._acc.pop(p, None)
        if acc is not None:
            g = g + acc
        if self._ef:
            qwire = _effective_quant_wire(st.key[1], st.key[3],
                                          self._compression)
            if qwire is not None:
                r = self._residual.get(p)
                if r is not None:
                    g = g + r.to(g.dtype)
                self._residual[p] = _quantization_residual(g, qwire)
        if self._alive is not None:
            g = g * float(self._alive)
        return g

    def _issue(self, st: _Overlap, buckets: List[int],
               in_backward: bool) -> None:
        _, alg, chunks, wire, _ = st.key
        op = C.Sum if self._alive is not None else self._op
        for b in buckets:
            st.handles[b] = C._in_step_bucket_async(
                st.buffer(b), op, self._ps(), self._prescale,
                self._postscale, self._compression, alg, chunks, wire,
                name=f"overlap/bucket{b}")
            _metrics.counter(
                "overlap_buckets_total",
                issued="backward" if in_backward else "step").inc()
            if in_backward:
                st.issued_in_backward += 1

    def _on_grad(self, i: int, p: torch.Tensor) -> None:
        """The post-accumulate-grad hook of parameter ``i``."""
        if (self._k > 1 and self._passes != self._k - 1) or \
                not self._included():
            return
        with torch.no_grad():
            st = self._begin()
            st.firings += 1
            if i in st.marked:
                raise RuntimeError(
                    f"DistributedOptimizer(overlap=True): the gradient of "
                    f"parameter {i} arrived twice in one step, after its "
                    "bucket may have gone out; run one backward a step "
                    "(backward_passes_per_step for more)")
            st.marked.add(i)
            st.pack(i, self._contribution(st, p, p.grad))
            self._issue(st, st.filler.mark(i), in_backward=True)

    def _overlap_finish(self, alive) -> None:
        if not self._included():
            return
        if alive is not None and (self._alive is None
                                  or float(alive) != float(self._alive)):
            raise ValueError(
                "DistributedOptimizer(overlap=True): the join mask must be "
                "known before the backward; call set_alive(alive) before "
                "loss.backward() and pass the same value to step()")
        with torch.no_grad():
            st = self._begin()
            for i, p in enumerate(self._ov_params):
                if i not in st.marked:
                    st.marked.add(i)
                    st.pack(i, self._contribution(st, p, p.grad))
                    self._issue(st, st.filler.mark(i), in_backward=False)
            self._issue(st, st.filler.rest(), in_backward=False)
            for b in _fusion.issue_order(len(st.plan.buckets), True):
                st.handles[b].synchronize()
            _metrics.gauge("overlap_buckets_in_backward").set(
                st.issued_in_backward)
            self.last_overlap = {"firings": st.firings,
                                 "issued_in_backward": st.issued_in_backward,
                                 "buckets": len(st.plan.buckets)}
            for i, p in enumerate(self._ov_params):
                st.unpack(i, p)
            if st.n_alive is not None and self._op == C.Average:
                n_alive = st.n_alive.synchronize()[0].clamp_min(1.0)
                for p in self._ov_params:
                    p.grad.div_(n_alive.to(p.grad.dtype))
            _maybe_record_grad_norm([p.grad for p in self._ov_params])
            st.reset()


def reset_error_feedback(optimizer: DistributedOptimizer) -> None:
    """Zero every error-feedback residual of a :class:`DistributedOptimizer`
    (the reference's ``reset_error_feedback``): after a change of the
    world the residuals are stale local error of the old one."""
    for r in optimizer._residual.values():
        r.zero_()


def broadcast_parameters(params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None) -> None:
    """Copy ``root_rank``'s parameters into every rank's, in place
    (``hvd.broadcast_parameters(model.state_dict(), 0)``). Takes a
    state_dict, ``named_parameters()`` or a list of tensors."""
    items = params.items() if hasattr(params, "items") else params
    for item in items:
        t = item[1] if isinstance(item, tuple) else item
        if torch.is_tensor(t):
            with torch.no_grad():
                C.broadcast_(t.data, root_rank, process_set=process_set)


def _describe(v) -> tuple:
    if torch.is_tensor(v):
        return ("tensor", tuple(v.shape), v.dtype, v.device.type == "cpu")
    return ("value", v)


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None
                              ) -> None:
    """Copy ``root_rank``'s optimizer state into every rank's
    (``hvd.broadcast_optimizer_state``). The ranks' states may differ in
    layout (the root resumed from a checkpoint, the others are fresh), so
    the root's layout goes first, by object broadcast: the param groups'
    hyperparameters and, for each parameter, its state's keys, each
    tensor's shape and dtype and each other value. Every rank then makes
    its state that layout -- a missing or misshapen tensor becomes zeros on
    the parameter's device (on the CPU where the root keeps it there, as
    torch's optimizers keep ``step``), keys the root lacks are dropped --
    and the tensors are broadcast in the root's order."""
    opt = getattr(optimizer, "_opt", optimizer)
    layout = C.broadcast_object({
        "groups": [{k: v for k, v in g.items() if k != "params"}
                   for g in opt.param_groups],
        "state": [[sorted((k, _describe(v))
                          for k, v in opt.state.get(p, {}).items())
                   for p in g["params"]] for g in opt.param_groups],
    }, root_rank, process_set)
    for g, src in zip(opt.param_groups, layout["groups"]):
        g.update(src)
    for g, entries_of in zip(opt.param_groups, layout["state"]):
        for p, entries in zip(g["params"], entries_of):
            if not entries:
                opt.state.pop(p, None)
                continue
            state = opt.state[p]
            for k in [k for k in state if k not in dict(entries)]:
                del state[k]
            for k, desc in entries:
                if desc[0] == "value":
                    state[k] = desc[1]
                    continue
                _, shape, dtype, on_cpu = desc
                cur = state.get(k)
                if not (torch.is_tensor(cur) and tuple(cur.shape) == shape
                        and cur.dtype == dtype):
                    cur = state[k] = torch.zeros(
                        shape, dtype=dtype,
                        device="cpu" if on_cpu else p.device)
                C.broadcast_(cur, root_rank, process_set=process_set)


def broadcast_variables(variables, root_rank: int = 0, **kw):
    """``hvd.broadcast_variables``: :func:`broadcast_parameters` under the
    TensorFlow frontend's name; returns ``variables``, now holding
    ``root_rank``'s values."""
    broadcast_parameters(variables, root_rank, **kw)
    return variables


def accumulation_has_updated(optimizer) -> bool:
    """True when the last ``step()`` of a ``backward_passes_per_step > 1``
    :class:`DistributedOptimizer` applied a real step (the k-th pass)
    rather than accumulating."""
    return bool(optimizer.has_updated)


# ---------------------------------------------------------------------------
# the functional step: grad, value_and_grad, the gradient tape
# ---------------------------------------------------------------------------

def _has_aux(gradkw: dict) -> bool:
    kw = dict(gradkw)
    has_aux = bool(kw.pop("has_aux", False))
    if kw:
        raise TypeError(f"unsupported gradient options {sorted(kw)}: the "
                        "port takes has_aux only")
    return has_aux


def _value_and_local_grads(fun, argnums, has_aux, args, kwargs, tap_kw):
    """``fun(*args, **kwargs)`` and this rank's gradients of its scalar
    value with respect to the ``argnums`` arguments (trees of tensors), in
    their structure. Each argument's leaves are detached and made to
    require grad; under ``tap_kw`` each argument is tapped
    (``overlap.tap_params``) first, so its buckets are reduced in the
    backward."""
    from horovod_tpu_torch.checkpoint_sharded import (_flatten_with_keys,
                                                      _unflatten_like)
    from horovod_tpu_torch.elastic.state import _tree_map
    idxs = (argnums,) if isinstance(argnums, int) else tuple(argnums)
    args = list(args)
    parts = []
    for i in idxs:
        # The argument's own order, which the taps' buckets follow.
        tree = _tree_map(lambda t: t.detach().requires_grad_(True)
                         if isinstance(t, torch.Tensor) else t, args[i])
        flat = _flatten_with_keys(tree)
        keys = [k for k, _ in flat]
        xs = [t for _, t in flat]
        if tap_kw is not None:
            tree = _overlap.tap_params(tree, **tap_kw)
        args[i] = tree
        parts.append((xs, keys, args[i]))
    with torch.enable_grad():
        out = fun(*args, **kwargs)
    value, aux = out if has_aux else (out, None)
    if not (torch.is_tensor(value) and value.numel() == 1):
        raise TypeError("grad requires a function of one scalar tensor "
                        f"value, got {type(value).__name__}")
    xs = [x for p, _, _ in parts for x in p]
    gs = torch.autograd.grad(value, xs, allow_unused=True)
    flat, seen = [], set()
    for x, g in zip(xs, gs):
        g = torch.zeros_like(x) if g is None else g.contiguous()
        if id(g) in seen:
            g = g.clone()
        seen.add(id(g))
        flat.append(g)
    trees, off = [], 0
    for p, keys, tree in parts:
        trees.append(_unflatten_like(tree, dict(zip(keys,
                                                    flat[off:off + len(p)]))))
        off += len(p)
    grads = trees[0] if isinstance(argnums, int) else tuple(trees)
    return value.detach(), aux, grads, flat


def grad(fun, argnums=0, op: int = C.Average,
         process_set: Optional[ProcessSet] = None,
         compression=Compression.none, overlap: bool = False,
         algorithm: Optional[str] = None,
         overlap_chunks: Optional[int] = None, **gradkw):
    """``hvd.grad``: the gradient of a scalar function of trees of tensors
    (``fun(params, *args)``, for example a loss over
    ``torch.func.functional_call(model, params, ...)``), allreduced across
    the process set. Returns a function that gives the gradients in the
    structure of the ``argnums`` arguments (a tuple of them for a tuple
    ``argnums``; ``(grads, aux)`` with ``has_aux=True``).

    ``overlap=True`` swaps the end-of-backward allreduce for identity taps
    on buckets of the arguments' leaves, at most the fusion threshold each
    (``overlap.tap_params``): every bucket's gradient is reduced inside
    the backward, as soon as it is produced, by an in-step allreduce with
    no negotiation round."""
    has_aux = _has_aux(gradkw)
    tap_kw = None
    if overlap:
        tap_kw = dict(op=op, process_set=process_set,
                      compression=compression, algorithm=algorithm,
                      overlap_chunks=overlap_chunks)
        _overlap.make_grad_sync_tap(**tap_kw)     # validates now

    def wrapped(*args, **kwargs):
        _, aux, grads, flat = _value_and_local_grads(
            fun, argnums, has_aux, args, kwargs, tap_kw)
        if overlap:
            # The taps already reduced every group.
            _maybe_record_grad_norm(flat)
        else:
            allreduce_gradients(flat, op=op, process_set=process_set,
                                compression=compression,
                                algorithm=algorithm,
                                overlap_chunks=overlap_chunks)
        return (grads, aux) if has_aux else grads
    return wrapped


def value_and_grad(fun, argnums=0, op: int = C.Average,
                   process_set: Optional[ProcessSet] = None,
                   compression=Compression.none, **gradkw):
    """``hvd.value_and_grad``: :func:`grad` that also returns the value
    (``((value, aux), grads)`` with ``has_aux=True``), averaged over the
    process set so every rank reports the global loss. The value's
    average is an in-step allreduce (no negotiation round); the gradients'
    is :func:`allreduce_gradients`. The reference averages the value only
    inside its SPMD context; the port's world of one process per GPU is
    that context, so the value is always averaged."""
    has_aux = _has_aux(gradkw)

    def wrapped(*args, **kwargs):
        from horovod_tpu_torch.checkpoint_sharded import (_flatten_with_keys,
                                                          _unflatten_like)
        value, aux, grads, flat = _value_and_local_grads(
            fun, argnums, has_aux, args, kwargs, None)
        out = (value, aux) if has_aux else value
        leaves = dict(_flatten_with_keys(out))
        keys = [k for k, x in leaves.items() if torch.is_tensor(x)]
        if keys:
            avg = C._in_step_allreduce_async(
                [leaves[k].detach() for k in keys], C.Average,
                C._resolve_ps(process_set), name="value_and_grad/value",
                algorithm="psum").synchronize()
            leaves.update(zip(keys, avg))
        allreduce_gradients(flat, op=op, process_set=process_set,
                            compression=compression)
        return _unflatten_like(out, leaves), grads
    return wrapped


class DistributedGradientTape:
    """The TensorFlow frontend's ``DistributedGradientTape`` in functional
    form: ``tape.gradient(fun, params, *args)`` is the gradient of
    ``fun(params, *args)`` with respect to ``params``, allreduced."""

    def __init__(self, op: int = C.Average,
                 process_set: Optional[ProcessSet] = None,
                 compression=Compression.none):
        self._op = op
        self._ps = process_set
        self._comp = compression

    def gradient(self, fun, params, *args, **kwargs):
        return grad(fun, op=self._op, process_set=self._ps,
                    compression=self._comp)(params, *args, **kwargs)


# ---------------------------------------------------------------------------
# AutotunedStep
# ---------------------------------------------------------------------------

def _wait_for(out) -> None:
    """Wait for the card when any tensor of ``out`` lives on it."""
    from horovod_tpu_torch.checkpoint_sharded import _flatten_with_keys
    for _, x in _flatten_with_keys(out):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


class AutotunedStep:
    """Fusion autotuning of a training step that is rebuilt for each
    proposal (the reference's ``AutotunedStep``).

    ``make_step(threshold_bytes) -> step_fn`` builds the step for a fusion
    threshold (a builder of 3 required arguments also receives the
    tuner's algorithm and chunk count, one of 4 the wire as well). While
    the tuner (default ``BayesianAutotuner`` with
    ``HOROVOD_AUTOTUNE_PROBES`` / ``HOROVOD_AUTOTUNE_SAMPLES``) tunes,
    each call is timed, behind ``torch.cuda.synchronize()`` when its
    outputs live on the card, and recorded; the first call after each
    (re)build runs untimed. When a probe completes, rank 0's point is
    agreed by ``broadcast_object`` (world size above 1) and the step is
    rebuilt; after convergence the agreed best runs untimed. Timed calls
    set the ``optimizer_step_seconds`` gauge and the
    ``optimizer_step_latency_seconds`` histogram."""

    def __init__(self, make_step, tuner=None):
        import inspect

        from horovod_tpu_torch.autotune import BayesianAutotuner
        cfg = get_config()
        self._make = make_step
        # Only required positional parameters count: a 1-argument builder
        # with defaulted extras must not get the algorithm in them.
        try:
            sig = inspect.signature(make_step)
            self._make_arity = sum(
                1 for p in sig.parameters.values()
                if p.default is p.empty and p.kind in (
                    p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        except (TypeError, ValueError):
            self._make_arity = 1
        self._tuner = tuner if tuner is not None else BayesianAutotuner(
            probes=cfg.autotune_probes,
            samples_per_probe=cfg.autotune_samples)
        self._fn = self._build(self._tuner.current_threshold())
        self._done = False
        # The first call after a (re)build pays one-time costs (allocator
        # growth, kernel builds); a probe's median must not be that.
        self._skip_next = True

    @property
    def converged(self) -> bool:
        return self._done

    def current_threshold(self) -> int:
        return self._tuner.current_threshold()

    def _build(self, threshold: int):
        if self._make_arity >= 3:
            t = self._tuner
            alg = getattr(t, "current_algorithm", lambda: "auto")()
            chunks = getattr(t, "current_chunks", lambda: None)()
            if self._make_arity >= 4:
                wire = getattr(t, "current_wire", lambda: "fp32")()
                return self._make(threshold, alg, chunks, wire)
            return self._make(threshold, alg, chunks)
        return self._make(threshold)

    def _agree_and_rebuild(self) -> None:
        from horovod_tpu_torch import core
        t = self._tuner
        multi = core.is_initialized() and core.size() > 1
        if getattr(t, "pending_sync", False):
            # Proposals come from local timings: agree on rank 0's point.
            if multi:
                t.set_current_point(tuple(C.broadcast_object(
                    t.current_point(), 0)))
            else:
                t.set_current_point(tuple(t.current_point()))
        if t.converged:
            best = int(t.current_threshold())
            if multi:
                # Each rank's argmin is over its local timings: every rank
                # runs, and the tuner reports, rank 0's.
                best = int(C.broadcast_object(best, 0))
                t._best = best
                if getattr(t, "_tune_alg", False):
                    alg, chunks = C.broadcast_object(
                        (t.current_algorithm(), t.current_chunks()), 0)
                    t._best_algorithm, t._best_chunks = alg, int(chunks)
                if getattr(t, "_tune_wire", False):
                    t._best_wire = C.broadcast_object(t.current_wire(), 0)
                if getattr(t, "_tune_topology", False):
                    t._best_topology = C.broadcast_object(
                        t.current_topology(), 0)
            self._fn = self._build(best)
            self._done = True
        else:
            self._fn = self._build(t.current_threshold())
        self._skip_next = True

    def __call__(self, *args, **kwargs):
        if self._done:
            return self._fn(*args, **kwargs)
        if self._skip_next:
            out = self._fn(*args, **kwargs)
            _wait_for(out)
            self._skip_next = False
            return out
        before = self._tuner.current_threshold()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        _wait_for(out)
        dt = time.perf_counter() - t0
        self._tuner.record(dt)
        _metrics.gauge("optimizer_step_seconds").set(dt)
        _metrics.histogram("optimizer_step_latency_seconds").observe(dt)
        if (getattr(self._tuner, "pending_sync", False)
                or self._tuner.converged
                or self._tuner.current_threshold() != before):
            self._agree_and_rebuild()
        return out
