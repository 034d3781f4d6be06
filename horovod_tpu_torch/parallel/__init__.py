"""Model-parallel layouts of the port: named meshes over the world's ranks
(``mesh.py``), sharding rules (``sharding.py``), FSDP / ZeRO-3
(``fsdp.py``), ZeRO-2 and the ``zero3_*`` surface (``mp.py``) and
Megatron's conjugate operators (``conjugate.py``). Port of
``horovod_tpu/parallel``; its tensor-parallel splits and decode steps,
pipelines and schedule tables wait for ``ROADMAP.md`` items 8b and 8c.
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
    MP_AXIS, gather_shard, zero2_grad_shard, zero2_update, zero3_adamw,
    zero3_apply, zero3_scan_blocks, zero3_shard_params,
    zero3_stack_layer_shards,
)
from horovod_tpu_torch.parallel.sharding import (  # noqa: F401
    PartitionRules, apply_rules, shard_pytree,
)
