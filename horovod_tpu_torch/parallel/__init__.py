"""Model-parallel layouts of the port: named meshes over the world's ranks
(``mesh.py``), sharding rules (``sharding.py``), FSDP / ZeRO-3
(``fsdp.py``), Megatron tensor parallelism (the weight splits, training
and decode), ZeRO-2 and the ``zero3_*`` surface (``mp.py``) and Megatron's
conjugate operators (``conjugate.py``), with the ``sp`` and ``ep`` axes
beside tp (``mp.tensor_parallel(model, tp_set, sp=, ep=)``; GPT-2, Llama
and T5), and pipelines, GPipe and 1F1B over a pp line of ranks
(``pipeline.py``; GPT-2 staged over them, with tp inside the stages, in
``models/gpt2_pipeline.py``). Port of ``horovod_tpu/parallel``; the
interleaved schedules and their schedule tables wait for ``ROADMAP.md``
item 8c-ii.
"""

from horovod_tpu_torch.parallel.conjugate import (  # noqa: F401
    identity_fwd_psum_bwd, psum_fwd_identity_bwd,
)
from horovod_tpu_torch.parallel.fsdp import (  # noqa: F401
    fsdp_adamw, fsdp_apply, fsdp_scan_blocks, fsdp_shard_params,
    stack_layer_shards,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    detect_topology, format_mesh, make_mesh, make_mesh2d, parse_mesh,
    validate_mesh,
)
from horovod_tpu_torch.parallel.mp import (  # noqa: F401
    MP_AXIS, TensorParallel, gather_shard, merge_params, mp_broadcast,
    mp_fetch, mp_partition_rules, mp_stack, param_bytes, split_params,
    tensor_parallel, tp_decode_step, tp_decode_verify_step, validate_tp,
    vocab_parallel_loss, wrap_spmd, zero2_grad_shard, zero2_update,
    zero3_adamw, zero3_apply, zero3_scan_blocks, zero3_shard_params,
    zero3_stack_layer_shards,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_1f1b, pipeline_apply, pipeline_loss,
)
from horovod_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionRules, apply_rules, shard_pytree,
)
