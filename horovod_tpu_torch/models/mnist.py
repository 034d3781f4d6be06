"""The MNIST CNN as a PyTorch ``nn.Module``.

Port of ``horovod_tpu/models/mnist.py``: two 3x3 convs with flax's default
``"SAME"`` padding (the maps stay 28x28; the Keras example the reference
names pads "valid", the JAX package does not), a 2x2 max-pool, dropout
0.25, ``Dense`` 128, dropout 0.5 and an fp32 ``Dense`` to the classes.
The pooled maps are flattened in NHWC order, as flax flattens them, so the
12,544 inputs of the first ``Dense`` are in (h, w, c) order and a JAX
checkpoint loads with a plain transpose
(``models.convert.mnist_params_from_jax``). Dropout draws from the
``generator`` given to ``forward`` (or torch's default one); its stream
cannot match JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from horovod_tpu_torch.models.gpt2 import Dense
from horovod_tpu_torch.models.resnet import Conv

__all__ = ["MnistCNN", "dropout"]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: keep each element with
    probability 1 - rate and scale it by 1 / (1 - rate)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class MnistCNN(nn.Module):
    """``forward(images, generator=None)`` -> fp32 logits (N, classes);
    ``images`` is (N, 1, 28, 28). Dropout runs in training mode only."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv(1, 32, 3, bias=True, dtype=dtype)
        self.conv1 = Conv(32, 64, 3, bias=True, dtype=dtype)
        self.dense0 = Dense(14 * 14 * 64, 128, dtype)
        self.dense1 = Dense(128, num_classes, torch.float32)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for m in (self.conv0, self.conv1, self.dense0, self.dense1):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.relu(self.conv0(x.to(self.dtype)))
        x = F.relu(self.conv1(x))
        x = F.max_pool2d(x, 2, 2)
        if self.training:
            x = dropout(x, 0.25, generator)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.dense0(x))
        if self.training:
            x = dropout(x, 0.5, generator)
        return self.dense1(x)
