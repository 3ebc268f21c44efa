"""Op-level profile inspection / diff CLI, counterpart of
``sls_tpu/cli/profile_diff.py``, over ``train/profiling.py``:

  # top device ops of one capture
  python -m sls_tpu_torch.cli.profile_diff models/<tag>/profile

  # what did a change make slower?  (a = baseline, b = candidate)
  python -m sls_tpu_torch.cli.profile_diff /tmp/prof_a /tmp/prof_b

Captures are the chrome traces of ``sls_tpu_torch.train.profiling.trace
(logdir)`` or of ``--profile_steps`` in cli.main (``<run dir>/profile``).
The device lane is the card's kernels (category ``kernel``); ``--lane
cpu_op`` reads the host's operators instead.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("trace_a", help="profiling.trace logdir (baseline)")
    parser.add_argument("trace_b", nargs="?", default=None,
                        help="second logdir to diff against (candidate)")
    parser.add_argument("--lane", default=None,
                        help="substring an event's category must contain "
                        "(default: 'kernel', the card's kernels)")
    parser.add_argument("--min_ms", type=float, default=0.05)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--json", action="store_true", dest="as_json")
    args = parser.parse_args(argv)

    from sls_tpu_torch.train.profiling import compare_profiles, op_histogram

    a = op_histogram(args.trace_a, lane_filter=args.lane)
    if args.trace_b is None:
        rows = sorted(
            ({"op": k, "ms": round(v["ms"], 3), "count": v["count"]}
             for k, v in a.items() if v["ms"] >= args.min_ms),
            key=lambda r: -r["ms"])[: args.top]
        if args.as_json:
            print(json.dumps(rows))
        else:
            print(f"{'op':44s} {'ms':>10s} {'count':>7s}")
            for r in rows:
                print(f"{r['op'][:44]:44s} {r['ms']:10.3f} {r['count']:7d}")
        return 0

    b = op_histogram(args.trace_b, lane_filter=args.lane)
    rows = compare_profiles(a, b, min_ms=args.min_ms)[: args.top]
    if args.as_json:
        print(json.dumps(rows))
    else:
        print(f"{'op':44s} {'a_ms':>10s} {'b_ms':>10s} {'delta':>10s}")
        for r in rows:
            print(f"{r['op'][:44]:44s} {r['a_ms']:10.3f} "
                  f"{r['b_ms']:10.3f} {r['delta_ms']:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
