"""Distributed optimizer and the start-of-training broadcasts.

Port of ``horovod_tpu/optimizer.py`` (``allreduce_gradients``,
``DistributedOptimizer``, ``broadcast_parameters``,
``broadcast_optimizer_state``) in the shape of the torch frontend
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
gradients, and the average divides by the number of live ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

from horovod_tpu_torch import collective as C
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.process_set import ProcessSet

__all__ = ["allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state"]


def allreduce_gradients(grads: List[torch.Tensor], op: int = C.Average,
                        process_set: Optional[ProcessSet] = None,
                        compression=Compression.none,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        fusion_threshold_bytes: Optional[int] = None,
                        alive=None) -> List[torch.Tensor]:
    """Fused allreduce of a list of gradients, in place.

    ``alive`` (this rank's 0 or 1, a number or a tensor) is the join mask:
    the number of live ranks ``n_alive`` is the allreduce Sum of ``alive``,
    at least 1; every gradient is multiplied by ``alive`` and reduced with
    Sum; Average then divides by ``n_alive``. It takes Sum and Average
    only."""
    kw = dict(process_set=process_set, compression=compression,
              prescale_factor=prescale_factor,
              postscale_factor=postscale_factor,
              fusion_threshold_bytes=fusion_threshold_bytes, out=grads)
    if alive is None:
        return C.grouped_allreduce(grads, op=op, **kw)
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
    return grads


class DistributedOptimizer:
    """``hvd.DistributedOptimizer`` around a torch optimizer.

    Everything but ``step``/``synchronize``/``zero_grad`` is forwarded to
    the inner optimizer (``param_groups``, ``state``, ``state_dict``...).
    ``named_parameters`` is accepted for upstream's signature and unused:
    gradients are fused in the optimizer's own parameter order.
    """

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable] = None,
                 compression=Compression.none, op: int = C.Average,
                 backward_passes_per_step: int = 1,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 process_set: Optional[ProcessSet] = None,
                 fusion_threshold_bytes: Optional[int] = None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        if getattr(compression, "wire", None) is not None:
            raise NotImplementedError("quantized wire: not yet ported")
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self._prescale = float(prescale_factor)
        self._postscale = float(postscale_factor)
        self._process_set = process_set
        self._threshold = fusion_threshold_bytes
        self._k = int(backward_passes_per_step)
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
        self.has_updated = False

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_opt"), name)

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self._opt.param_groups for p in g["params"]]

    def synchronize(self, alive=None) -> None:
        """Allreduce every ``.grad`` now (one fused collective per fusion
        bucket) and write the results back into ``.grad``; ``alive`` is
        this rank's join mask (:func:`allreduce_gradients`)."""
        grads = [p.grad for p in self._params() if p.grad is not None]
        if grads:
            allreduce_gradients(grads, op=self._op,
                                process_set=self._process_set,
                                compression=self._compression,
                                prescale_factor=self._prescale,
                                postscale_factor=self._postscale,
                                fusion_threshold_bytes=self._threshold,
                                alive=alive)

    def step(self, closure=None, alive=None):
        """Synchronize the gradients, then run the inner step. ``alive``
        (0 or 1) is this rank's join mask for this step; with
        ``backward_passes_per_step > 1`` the k-th call's mask applies to
        the accumulated gradients and earlier calls' are not used."""
        if self._k > 1:
            self._passes += 1
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
            for p in self._params():
                if p in self._acc:
                    p.grad = self._acc.pop(p)
            self._passes = 0
        self.synchronize(alive)
        self.has_updated = True
        return self._opt.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self._opt.zero_grad(set_to_none=set_to_none)


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


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None
                              ) -> None:
    """Copy ``root_rank``'s optimizer state into every rank's
    (``hvd.broadcast_optimizer_state``): tensor state in place, scalar state
    and the param-group hyperparameters by object broadcast."""
    opt = getattr(optimizer, "_opt", optimizer)
    groups = C.broadcast_object(
        [{k: v for k, v in g.items() if k != "params"}
         for g in opt.param_groups], root_rank, process_set)
    for g, src in zip(opt.param_groups, groups):
        g.update(src)
    scalars: Dict[Any, Any] = {}
    for gi, g in enumerate(opt.param_groups):
        for pi, p in enumerate(g["params"]):
            for k, v in sorted(opt.state.get(p, {}).items()):
                if torch.is_tensor(v):
                    C.broadcast_(v, root_rank, process_set=process_set)
                else:
                    scalars[(gi, pi, k)] = v
    scalars = C.broadcast_object(scalars, root_rank, process_set)
    for (gi, pi, k), v in scalars.items():
        opt.state[opt.param_groups[gi]["params"][pi]][k] = v
