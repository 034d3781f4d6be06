#!/usr/bin/env python
"""Offline postmortem analyzer: rank the root cause of a crash bundle.

Port of ``tools/postmortem.py`` over ``horovod_tpu_torch.blackbox``. Reads
a flight-recorder bundle published by the port's black box
(``HOROVOD_BLACKBOX`` / :func:`horovod_tpu_torch.dump_postmortem`) and
prints a ranked root-cause report -- the injected-fault / quarantine /
engine-death ground truth from the events ring first, then the offline
doctor's findings over the bundled metrics window, then the pre-death
alert tail and queue trend. No cluster, no live process, no card: the
bundle is the whole input, and nothing of JAX is imported.

Usage::

    python tools/torch_postmortem.py                    # newest bundle
    python tools/torch_postmortem.py <bundle-dir>       # a specific bundle
    python tools/torch_postmortem.py --dir /path/to/blackbox
    python tools/torch_postmortem.py --json             # machine-readable

Exit status: 0 = analyzed, no confident root cause; 2 = a root cause was
identified (severity >= 0.5); 1 = no bundle to analyze.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="rank the root cause of a flight-recorder bundle")
    p.add_argument("bundle", nargs="?", default=None,
                   help="postmortem-* bundle dir (default: newest under "
                        "--dir)")
    p.add_argument("--dir", dest="root", default=None,
                   help="blackbox dir to search (default: "
                        "HOROVOD_BLACKBOX_DIR or the tempdir default)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw report dict as JSON")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    from horovod_tpu_torch import blackbox

    try:
        report = blackbox.postmortem_report(args.bundle, root=args.root)
    except FileNotFoundError as e:
        print(f"postmortem: {e}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(blackbox.format_postmortem(report))
    return 2 if report.get("cause") else 0


if __name__ == "__main__":
    sys.exit(main())
