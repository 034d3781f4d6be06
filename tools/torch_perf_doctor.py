#!/usr/bin/env python
"""Offline ``hvd.doctor()`` of horovod_tpu_torch: fuse metrics snapshots
and a merged trace into a ranked findings report.

    python tools/torch_perf_doctor.py --metrics /tmp/metrics.json \\
                                      --trace  /tmp/trace.json
    python tools/torch_perf_doctor.py --trace /tmp/trace.merged.json --json

``--metrics`` takes the JSON snapshot the ``HOROVOD_METRICS_FILE``
flusher writes (repeat the flag to fuse several ranks' snapshots);
``--trace`` takes a merged trace, a shard base path, a glob, or a
directory (shards are merged on the fly). With neither, the report runs
over this process's live registries -- only useful from inside a job.

Exit status: 0 healthy (no finding at severity >= 0.5), 2 findings.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _merge_snapshots(paths):
    """Fuse several ranks' snapshot files: series lists concatenate under
    their family name (labels keep them distinguishable; the doctor's
    checks sum/scan across series anyway)."""
    merged = {"counters": {}, "gauges": {}, "histograms": {},
              "pending_collectives": []}
    for path in paths:
        with open(path) as f:
            snap = json.load(f)
        for group in ("counters", "gauges", "histograms"):
            for name, series in (snap.get(group) or {}).items():
                merged[group].setdefault(name, []).extend(series)
        merged["pending_collectives"].extend(
            snap.get("pending_collectives") or [])
    return merged


def main() -> int:
    p = argparse.ArgumentParser(
        description="ranked performance diagnosis from metrics + traces")
    p.add_argument("--metrics", action="append", default=[],
                   help="metrics snapshot JSON (flusher output); "
                        "repeatable for multi-rank runs")
    p.add_argument("--trace", default=None,
                   help="merged trace json, shard base path, glob, or "
                        "directory")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the raw report dict instead of text")
    args = p.parse_args()

    from horovod_tpu_torch.profiler import doctor, format_report

    snapshot = _merge_snapshots(args.metrics) if args.metrics else None
    report = doctor(snapshot=snapshot, trace=args.trace)
    if args.as_json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(format_report(report))
    return 0 if report["healthy"] else 2


if __name__ == "__main__":
    sys.exit(main())
