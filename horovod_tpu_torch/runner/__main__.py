"""``python -m horovod_tpu_torch.runner -np N [--elastic --spares K]
[--start-timeout S] command...``: see ``launcher.main``."""

import sys

from horovod_tpu_torch.runner.launcher import main

if __name__ == "__main__":
    sys.exit(main())
