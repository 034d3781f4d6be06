"""``python -m horovod_tpu_torch.runner -np N [--timeout S] script.py
[args...]``: run a script as N local ranks (see ``launcher.py``)."""

from __future__ import annotations

import argparse
import sys

from horovod_tpu_torch.runner.launcher import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.runner")
    p.add_argument("-np", "--num-proc", dest="np", type=int, required=True,
                   help="number of local ranks")
    p.add_argument("--timeout", type=float, default=None,
                   help="seconds before every rank is stopped")
    p.add_argument("script")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    return run(a.script, a.np, a.args, timeout_s=a.timeout)


if __name__ == "__main__":
    sys.exit(main())
