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
gradients, and the average divides by the number of live ranks. The eager
form is ``hvd.join()`` (``collective.py``).

``HOROVOD_METRICS_GRAD_NORM=1`` records the global L2 norm of the reduced
gradients in the ``optimizer_grad_norm`` gauge (``metrics.py``) after each
allreduce, as the reference does; reading it back waits for the device, so
it is off by default. The reference's step-time gauge is recorded on its
autotuned step only, and waits with the autotuner.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import torch

from horovod_tpu_torch import collective as C
from horovod_tpu_torch import metrics as _metrics
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.config import get_config
from horovod_tpu_torch.process_set import ProcessSet

__all__ = ["allreduce_gradients", "DistributedOptimizer",
           "broadcast_parameters", "broadcast_optimizer_state"]


def _maybe_record_grad_norm(grads: List[torch.Tensor]) -> None:
    """The ``optimizer_grad_norm`` gauge: the L2 norm, in fp32, of the
    floating-point gradients (``HOROVOD_METRICS_GRAD_NORM``)."""
    if not get_config().metrics_grad_norm:
        return
    sq = [g.float().square().sum() for g in grads if g.is_floating_point()]
    if sq:
        _metrics.gauge("optimizer_grad_norm").set(
            torch.stack(sq).sum().sqrt().item())


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
