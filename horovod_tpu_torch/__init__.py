"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

Data-parallel training on NVIDIA GPUs with Horovod's API::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA + NCCL
    model = GPT2(cfg).to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))

Entry points run on the GPU unless asked otherwise: ``init()`` raises when
no CUDA device is present; ``init(device="cpu")`` runs on the CPU with gloo.
Models: ``models.get_model`` (MNIST, ResNet-18/50 with local,
cross-replica or bf16-statistics batch norm, GPT-2 medium, BERT, ViT,
Llama). Collectives: Horovod's eager API with ``*_async`` handles,
``synchronize`` and ``poll``, Adasum (``adasum.py``), and subset process
sets (``add_process_set``); the join mask (``alive``) of
``DistributedOptimizer``; ``SyncBatchNorm`` for users' own models. The
flash-attention kernels are CUDA C++ for Hopper (``ops/csrc``), built with
nvcc at first use. This package imports nothing
of JAX or of ``horovod_tpu``.
"""

from horovod_tpu_torch.collective import (
    Adasum, Average, Handle, Max, Min, Product, ReduceOp, Sum, allgather,
    allgather_async, allgather_object, allreduce, allreduce_,
    allreduce_async, allreduce_async_, alltoall, alltoall_async, barrier,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    broadcast_object, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_async, grouped_reducescatter,
    grouped_reducescatter_async, poll, ragged_allgather, reducescatter,
    reducescatter_async, synchronize)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import (
    backend, build_info, cross_rank, cross_size, device, init,
    is_initialized, local_rank, local_size, rank, shutdown, size)
from horovod_tpu_torch.optimizer import (
    DistributedOptimizer, allreduce_gradients, broadcast_optimizer_state,
    broadcast_parameters)
from horovod_tpu_torch.process_set import (
    ProcessSet, add_process_set, get_process_set_ids_and_ranks,
    global_process_set, remove_process_set)
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "device", "backend",
    "build_info", "allreduce", "allreduce_", "allreduce_async",
    "allreduce_async_", "grouped_allreduce", "grouped_allreduce_async",
    "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
    "allgather", "allgather_async", "grouped_allgather",
    "grouped_allgather_async", "ragged_allgather", "alltoall",
    "alltoall_async", "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "grouped_reducescatter_async", "synchronize",
    "poll", "Handle", "barrier", "broadcast_object", "allgather_object",
    "DistributedOptimizer", "allreduce_gradients", "broadcast_parameters",
    "broadcast_optimizer_state", "Compression", "ReduceOp", "Average", "Sum",
    "Min", "Max", "Product", "Adasum", "ProcessSet", "global_process_set",
    "add_process_set", "remove_process_set",
    "get_process_set_ids_and_ranks", "SyncBatchNorm",
]
