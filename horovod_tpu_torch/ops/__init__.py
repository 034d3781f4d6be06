"""Operators of the port: attention dispatch, the flash-attention kernels
(CUDA C++ under ``csrc/``, built at first use by ``_build.py``) and
sequence-parallel attention (ring, flash ring, Ulysses)."""

from horovod_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
from horovod_tpu_torch.ops.ring_flash import ring_flash_attention  # noqa: F401
from horovod_tpu_torch.ops.sequence import ulysses_attention  # noqa: F401
