"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

Data-parallel training on NVIDIA GPUs with Horovod's API::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA + NCCL
    model = GPT2(cfg).to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))

Entry points run on the GPU unless asked otherwise: ``init()`` raises when
no CUDA device is present; ``init(device="cpu")`` runs on the CPU with gloo.
The flash-attention kernels are CUDA C++ for Hopper (``ops/csrc``), built
with nvcc at first use. This package imports nothing of JAX or of
``horovod_tpu``.
"""

from horovod_tpu_torch.collective import (
    Adasum, Average, Max, Min, Product, ReduceOp, Sum, allgather, allreduce,
    barrier, broadcast, broadcast_, broadcast_object,
    grouped_allreduce)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import (
    backend, build_info, cross_rank, cross_size, device, init,
    is_initialized, local_rank, local_size, rank, shutdown, size)
from horovod_tpu_torch.optimizer import (
    DistributedOptimizer, allreduce_gradients, broadcast_optimizer_state,
    broadcast_parameters)
from horovod_tpu_torch.process_set import ProcessSet, global_process_set

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "device", "backend",
    "build_info", "allreduce", "grouped_allreduce",
    "broadcast", "broadcast_", "allgather", "barrier", "broadcast_object",
    "DistributedOptimizer", "allreduce_gradients", "broadcast_parameters",
    "broadcast_optimizer_state", "Compression", "ReduceOp", "Average", "Sum",
    "Min", "Max", "Product", "Adasum", "ProcessSet", "global_process_set",
]
