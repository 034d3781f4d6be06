#!/usr/bin/env python
"""Merge per-rank horovod_tpu_torch timeline shards into one Chrome trace.

The port's counterpart of ``tools/trace_merge.py`` (same arguments, same
output), through ``horovod_tpu_torch.trace_merge``; it imports no JAX.

Usage:
    python tools/torch_trace_merge.py /path/trace.json -o merged.json
    python tools/torch_trace_merge.py /path/trace.rank0.json /path/trace.rank1.json
    python tools/torch_trace_merge.py /path/traces/ -o merged.json --report

The positional argument is the base path that was passed as
``HOROVOD_TIMELINE`` (shards ``trace.rank{N}.json`` are discovered next to
it), a glob, a directory, or an explicit list of shard files. The merged
trace opens in Perfetto / chrome://tracing with one track per rank; the
straggler report (per-collective arrival spread, per-rank blame rollup,
critical-path estimate) is embedded under the ``stragglerReport`` key and
printed with ``--report``.

Exit status: 0 on success, 1 when no shards are found or nothing could be
merged. Corrupt/truncated shards degrade to warnings.
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("inputs", nargs="+",
                    help="HOROVOD_TIMELINE base path, glob, directory, or "
                         "explicit shard files")
    ap.add_argument("-o", "--output", default=None,
                    help="write the merged Chrome trace here "
                         "(default: <base>.merged.json)")
    ap.add_argument("--report", action="store_true",
                    help="print the straggler report as JSON to stdout")
    ap.add_argument("--no-metrics", action="store_true",
                    help="do not feed arrival spreads into the in-process "
                         "metrics registry")
    args = ap.parse_args(argv)

    # Import late so --help works without the package's import cost.
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from horovod_tpu_torch.trace_merge import merge_timelines

    inputs = args.inputs[0] if len(args.inputs) == 1 else args.inputs
    output = args.output
    if output is None:
        base = args.inputs[0].rstrip("/")
        if os.path.isdir(base):
            # trace.merged.json (not a bare suffix): visible in ls, and
            # the .merged.json ending keeps discovery from re-ingesting
            # it as a shard on the next merge of this directory.
            output = os.path.join(base, "trace.merged.json")
        else:
            root = base[:-5] if base.endswith(".json") else base
            output = f"{root}.merged.json"
    try:
        doc = merge_timelines(inputs, output,
                              feed_metrics=not args.no_metrics)
    except (FileNotFoundError, ValueError) as e:
        print(f"trace_merge: {e}", file=sys.stderr)
        return 1
    report = doc["stragglerReport"]
    n_ev = len(doc["traceEvents"])
    print(f"merged {len(report['ranks'])} rank shard(s), {n_ev} events -> "
          f"{output}", file=sys.stderr)
    print(f"collectives correlated across ranks: "
          f"{len(report['collectives'])}; blame by rank: "
          f"{report['blame_seconds_by_rank']}", file=sys.stderr)
    if args.report:
        json.dump(report, sys.stdout, indent=2, default=str)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
