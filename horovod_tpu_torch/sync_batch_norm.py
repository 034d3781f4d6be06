"""``hvd.SyncBatchNorm``: cross-replica batch norm for users' own torch
models.

Port of ``horovod_tpu/torch/sync_batch_norm.py`` (upstream
``horovod/torch/sync_batch_norm.py``) onto this package's collectives: in
training mode the per-channel sum, sum of squares and count are
Sum-allreduced mid-forward, and the backward Sum-allreduces the gradient
sums, so the input gradients are exact for the global batch's
normalization. Weight and bias gradients stay local (the
``DistributedOptimizer`` averages them afterwards). The running variance is
the unbiased one over the global count, as torch's. For flax's semantics
(biased running variance, momentum 0.9) use ``ops.batch_norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch import collective as C

__all__ = ["SyncBatchNorm"]


def _allreduce_sum(vec: torch.Tensor) -> torch.Tensor:
    return C.allreduce(vec, op=C.Sum)


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        count = x.numel() // c
        local = torch.cat([
            x.sum(dims, dtype=torch.float32),
            (x.float() * x.float()).sum(dims),
            torch.full((1,), float(count), dtype=torch.float32,
                       device=x.device),
        ])
        tot = _allreduce_sum(local)
        n = tot[-1]
        mean = tot[:c] / n
        var = tot[c:2 * c] / n - mean * mean
        invstd = torch.rsqrt(var + eps)

        shape = [1, c] + [1] * (x.dim() - 2)
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        out = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd, n)
        return out.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, grad_out, _gm, _gv, _gn):
        xhat, weight, invstd, n = ctx.saved_tensors
        c = grad_out.shape[1]
        dims = [0] + list(range(2, grad_out.dim()))
        dy = grad_out.float()
        sum_dy = dy.sum(dims)
        sum_dy_xhat = (dy * xhat).sum(dims)
        # Global sums for the input gradient (the cross-replica coupling);
        # the affine parameters keep their local sums.
        tot = _allreduce_sum(torch.cat([sum_dy, sum_dy_xhat]))
        g_sum_dy, g_sum_dy_xhat = tot[:c], tot[c:]
        shape = [1, c] + [1] * (grad_out.dim() - 2)
        grad_x = (invstd * weight).view(shape) * (
            dy - (g_sum_dy.view(shape)
                  + xhat * g_sum_dy_xhat.view(shape)) / n)
        return grad_x.to(grad_out.dtype), sum_dy_xhat, sum_dy, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNormNd`` with statistics over every
    rank's batch (``hvd.SyncBatchNorm``). Eval mode normalizes locally by
    the running stats."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        if not self.training and self.track_running_stats:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        c = x.shape[1]
        weight = self.weight if self.affine else x.new_ones(
            c, dtype=torch.float32)
        bias = self.bias if self.affine else x.new_zeros(
            c, dtype=torch.float32)
        out, mean, var, n = _SyncBatchNormFn.apply(x, weight, bias, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                if self.num_batches_tracked is not None:
                    self.num_batches_tracked.add_(1)
                if self.momentum is None:
                    # torch semantics: cumulative moving average.
                    m = 1.0 / float(self.num_batches_tracked)
                else:
                    m = self.momentum
                unbiased = var * (n / (n - 1).clamp(min=1.0))
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(unbiased, alpha=m)
        return out
