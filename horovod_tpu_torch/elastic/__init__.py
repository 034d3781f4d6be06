"""Elastic training: fault tolerance and dynamic membership.

Port of ``horovod_tpu/elastic`` (upstream ``horovod/common/elastic.py``:
State, the run decorator, commit and restore; and
``horovod/runner/elastic``: discovery, ``WorkerNotificationManager``).

GPU shape: the unit of failure is a worker process (one per GPU). Within a
process, ``@run`` re-forms the process group (``shutdown()`` + ``init()``)
after a membership change and re-broadcasts the last commit; across
processes, ``runner.run_elastic`` tears the job down and relaunches it,
promoting a hot spare into a dead rank's slot, and the relaunched rank 0
adopts the last published sharded checkpoint.
"""

import os as _os

from horovod_tpu_torch.elastic.state import (  # noqa: F401
    FsdpState, State, TensorState, TorchState,
)


def state_dir():
    """Shared directory for elastic commit persistence, set by
    ``runner.run_elastic`` (``HVD_TPU_ELASTIC_STATE_DIR``); None outside an
    elastic job."""
    return _os.environ.get("HVD_TPU_ELASTIC_STATE_DIR")


def restart_count() -> int:
    """How many times this job has been relaunched after worker loss
    (``HVD_TPU_ELASTIC_RESTART``); 0 on the first attempt."""
    return int(_os.environ.get("HVD_TPU_ELASTIC_RESTART", "0"))


from horovod_tpu_torch.elastic.driver import (  # noqa: E402,F401
    run, HostsUpdatedInterrupt, WorkerNotificationManager,
    is_spare, standby, standby_if_spare, promote_spare, list_spares,
)
from horovod_tpu_torch.elastic.discovery import (  # noqa: E402,F401
    HostDiscovery, FixedHostDiscovery, ScriptHostDiscovery, DeviceDiscovery,
)
