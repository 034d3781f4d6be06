"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu.

Data-parallel training on NVIDIA GPUs with Horovod's API::

    import horovod_tpu_torch as hvd
    hvd.init()                                   # CUDA + NCCL
    model = GPT2(cfg).to(hvd.device())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()))

Entry points run on the GPU unless asked otherwise: ``init()`` raises when
no CUDA device is present; ``init(device="cpu")`` runs on the CPU with
gloo. Models: ``models.get_model`` (MNIST, ResNet-18/50 with local,
cross-replica or bf16-statistics batch norm, GPT-2 medium, BERT, ViT,
Llama, T5). Upstream's build flags (``nccl_built``, ``gloo_built``,
``mpi_built``, ``cuda_built``, ``rocm_built``, ``mpi_enabled``,
``gloo_enabled``, ``mpi_threads_supported``) report this PyTorch's build
and the backend ``init`` chose. Collectives: Horovod's eager API with
``*_async`` handles, ``synchronize`` and ``poll``, Adasum (``adasum.py``),
and subset process sets (``add_process_set``); eager ``join()`` for uneven
data and the join mask (``alive``) of ``DistributedOptimizer``;
``SyncBatchNorm`` for users' own models. Horovod's controller runs around
every eager op: negotiation (a readable error, not a NCCL hang, when ranks
issue collectives in another order), the timeline (``HOROVOD_TIMELINE`` or
``start_timeline``), the metrics registry (``metrics()``,
``HOROVOD_METRICS_FILE``) and the stall watchdog
(``HOROVOD_STALL_CHECK_TIME_SECONDS``). Observability: ``merge_timelines``
merges the per-rank timeline shards into one trace with a straggler
report (``trace_merge.py``); ``metrics_http`` starts the live scrape
endpoint (``/metrics``, ``/metrics.json``, ``/trace``, ``/healthz``,
``/config``; ``POST /config`` gated by ``HOROVOD_SERVE_AUTH_TOKEN``);
``timeseries`` keeps windowed series of the registry (``TimeSeriesStore``,
``LocalSampler``); ``profiler`` keeps the program registry (``instrument``:
recompile blame, FLOPs from a cost capture, mfu / hfu on the card's peaks),
memory accounting and ``torch.profiler`` captures (``profile``, and one
bounded capture a stall under ``HOROVOD_PROFILE_ON_STALL``), and
``doctor()`` ranks what looks sick; ``blackbox`` is the flight recorder
(``HOROVOD_BLACKBOX``): a stall, a fault-plan kill, SIGTERM or
``dump_postmortem()`` publishes a bundle that ``postmortem_report``
(``tools/torch_postmortem.py``) ranks the root cause of; ``confbus`` is
the config bus: ``set_config`` changes a runtime-mutable knob (refusing
shape-affecting ones with a typed reason), and every change, by the bus or
by an env change that ``config.refresh()`` sees, is audited once (a
``config_epoch``, a ledger line under ``HOROVOD_CONFIG_LEDGER``, a
``CONFIG`` timeline marker, a flight-recorder record; ``GET /config``
shows it). The allreduce algorithm axis
(``overlap.py``: ``algorithm=`` ``psum``, ``rs_ag``, ``chunked_rs_ag``,
their ``_int8`` / ``_fp8`` quantized forms, the ``_2d`` forms over
``topology()``, ``swing``, or ``auto``; ``wire=`` and ``overlap_chunks=``;
``HOROVOD_ALLREDUCE_ALGORITHM``, ``HOROVOD_ALLREDUCE_WIRE``,
``HOROVOD_OVERLAP_CHUNKS``, ``HOROVOD_TOPOLOGY``), the quantized wire
``Compression.int8`` / ``fp8`` (``ops/quantized.py``), and in
``DistributedOptimizer`` gradient overlap in the backward
(``overlap=True``), error feedback (``error_feedback=``,
``reset_error_feedback``), ``gradient_predivide_factor`` and the online
tuner (``HOROVOD_AUTOTUNE``, ``autotune.py``). The functional step:
``grad`` / ``value_and_grad`` over trees of tensors (for example through
``torch.func.functional_call``; ``overlap=True`` reduces each group inside
the backward), ``DistributedGradientTape``, ``AutotunedStep``, per-rank
data sharding (``data``: ``DistributedSampler``, ``ShardedBatchIterator``)
and ZeRO-1 (``sharded_adamw``, ``optimizer_sharded.py``). Model-parallel
layouts (``parallel``): the named dp x mp mesh (``HOROVOD_MESH``,
``mesh2d``, ``dp_size`` / ``mp_size`` / ``dp_rank`` / ``mp_rank``),
``PartitionRules``, FSDP / ZeRO-3 (blocks stored as flat shards and
gathered just in time), ZeRO-2 and Megatron's conjugate operators. Fault
tolerance: ``elastic`` (``TorchState``, ``TensorState``, ``FsdpState``,
``@elastic.run``, discovery, hot spares), ``checkpoint_sharded`` (async
two-phase sharded checkpoints in the reference's on-disk format),
``checkpoint`` (full state), ``faults`` (``HOROVOD_FAULT_PLAN``) and
``runner.run_elastic``. The flash-attention kernels are CUDA C++ for Hopper
(``ops/csrc``), built with nvcc at first use. This package imports nothing
of JAX or of ``horovod_tpu``.
"""

from horovod_tpu_torch.collective import (
    Adasum, Average, Handle, Max, Min, Product, ReduceOp, Sum, allgather,
    allgather_async, allgather_object, allreduce, allreduce_,
    allreduce_async, allreduce_async_, alltoall, alltoall_async, barrier,
    broadcast, broadcast_, broadcast_async, broadcast_async_,
    broadcast_object, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_async, grouped_reducescatter,
    grouped_reducescatter_async, join, negotiation_arrival_stats,
    negotiation_stats, poll, ragged_allgather, reducescatter,
    reducescatter_async, synchronize)
from horovod_tpu_torch.autotune import (
    AutotuneResult, Autotuner, BayesianAutotuner, autotune_fusion_threshold)
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import (
    backend, build_info, cross_rank, cross_size, cuda_built, device,
    dp_rank, dp_size, gloo_built, gloo_enabled, init, is_initialized,
    local_rank, local_size, mesh2d, mesh_spec, mp_rank, mp_size, mpi_built,
    mpi_enabled, mpi_threads_supported, nccl_built, rank, rocm_built,
    shutdown, size, topology, topology_str)
from horovod_tpu_torch import metrics
from horovod_tpu_torch.metrics import (
    get_stall_watchdog, metrics_http, reset_metrics, start_metrics_flusher,
    start_stall_watchdog, stop_metrics_flusher, stop_stall_watchdog)
from horovod_tpu_torch.optimizer import (
    AutotunedStep, DistributedGradientTape, DistributedOptimizer,
    accumulation_has_updated, allreduce_gradients, broadcast_optimizer_state,
    broadcast_parameters, broadcast_variables, grad, reset_error_feedback,
    value_and_grad)
from horovod_tpu_torch.optimizer_sharded import (
    ShardedAdamWState, sharded_adamw)
from horovod_tpu_torch.ops.quantized import quantized_allreduce
from horovod_tpu_torch.process_set import (
    ProcessSet, add_process_set, get_process_set_ids_and_ranks,
    global_process_set, remove_process_set)
from horovod_tpu_torch.sync_batch_norm import SyncBatchNorm
from horovod_tpu_torch.timeline import (
    merge_timelines, start_timeline, stop_timeline)
# Windowed series over registry snapshots (hvd.timeseries).
from horovod_tpu_torch import timeseries  # noqa: E402,F401
# Program registry, roofline gauges, captures and the doctor (hvd.profiler,
# hvd.doctor, hvd.profile).
from horovod_tpu_torch import profiler  # noqa: E402,F401
from horovod_tpu_torch.profiler import doctor, profile  # noqa: E402,F401
# The flight recorder and postmortem plane (hvd.blackbox): bounded rings
# under HOROVOD_BLACKBOX, crash-time bundles (hvd.dump_postmortem) and the
# offline root-cause report (hvd.postmortem_report; CLI:
# tools/torch_postmortem.py).
from horovod_tpu_torch import blackbox  # noqa: E402,F401
from horovod_tpu_torch.blackbox import (  # noqa: E402,F401
    dump_postmortem, postmortem_report)
# The config bus (hvd.confbus): the typed knob registry over config.py,
# hvd.set_config() with its audit ledger and config_epoch, measured-effect
# windows with revert-on-regression, and GET / POST /config on
# hvd.metrics_http().
from horovod_tpu_torch import confbus  # noqa: E402,F401
from horovod_tpu_torch.confbus import set_config  # noqa: E402,F401
# Fault tolerance: elastic states and the run decorator (hvd.elastic), async
# sharded checkpoints (hvd.checkpoint_sharded), full-state checkpoints
# (hvd.checkpoint) and the fault plan (hvd.faults).
from horovod_tpu_torch import checkpoint  # noqa: E402,F401
from horovod_tpu_torch import checkpoint_sharded  # noqa: E402,F401
from horovod_tpu_torch import elastic  # noqa: E402,F401
from horovod_tpu_torch import faults  # noqa: E402,F401
from horovod_tpu_torch.checkpoint_sharded import (  # noqa: E402,F401
    ShardedCheckpointManager, TornCheckpointError)
# Model-parallel layouts on the named dp x mp mesh (hvd.parallel): meshes,
# partition rules, FSDP / ZeRO-3, ZeRO-2 and the conjugate operators.
from horovod_tpu_torch import parallel  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "__version__", "nccl_built", "gloo_built", "mpi_built", "cuda_built",
    "rocm_built", "mpi_enabled", "gloo_enabled", "mpi_threads_supported",
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
    "get_process_set_ids_and_ranks", "SyncBatchNorm", "join", "metrics",
    "reset_metrics", "start_metrics_flusher", "stop_metrics_flusher",
    "start_timeline", "stop_timeline", "start_stall_watchdog",
    "stop_stall_watchdog", "get_stall_watchdog", "negotiation_stats",
    "negotiation_arrival_stats", "topology", "topology_str",
    "reset_error_feedback", "quantized_allreduce", "Autotuner",
    "BayesianAutotuner", "AutotuneResult", "autotune_fusion_threshold",
    "checkpoint", "checkpoint_sharded", "elastic", "faults",
    "ShardedCheckpointManager", "TornCheckpointError", "AutotunedStep",
    "DistributedGradientTape", "accumulation_has_updated",
    "broadcast_variables", "grad", "value_and_grad", "ShardedAdamWState",
    "sharded_adamw", "parallel", "mesh2d", "mesh_spec", "dp_size",
    "mp_size", "dp_rank", "mp_rank", "merge_timelines", "metrics_http",
    "timeseries", "profiler", "doctor", "profile", "blackbox",
    "dump_postmortem", "postmortem_report", "confbus", "set_config",
]
