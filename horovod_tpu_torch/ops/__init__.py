"""Operators of the port: attention dispatch, the flash-attention kernels
(CUDA C++ under ``csrc/``, built at first use by ``_build.py``), the MoE
layer and sequence-parallel attention (ring, flash ring, Ulysses).

As in the reference's package, ``ops.flash_attention`` and
``ops.ring_attention`` name the functions; their modules are
``importlib.import_module("horovod_tpu_torch.ops.flash_attention")`` and
``horovod_tpu_torch.ops.ring_attention``'s other names."""

from horovod_tpu_torch.ops.flash_attention import flash_attention  # noqa: F401
from horovod_tpu_torch.ops.moe import MoEMLP, Top1Router  # noqa: F401
from horovod_tpu_torch.ops.ring_attention import ring_attention  # noqa: F401
from horovod_tpu_torch.ops.ring_flash import ring_flash_attention  # noqa: F401
from horovod_tpu_torch.ops.sequence import ulysses_attention  # noqa: F401
