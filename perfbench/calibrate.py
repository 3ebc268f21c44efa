"""Readings for the limits of a cell's comparisons, in one process (the
program's kernels built once): sound runs of the program on each of
``--seeds``, then the cell's control (its workload's ``control``: the
program's own lower-precision path, or the reference in a lower
precision in the program's place) on each of ``--control-seeds``.  Each
run prints one JSON line: its seed, kind, the numbers compared and the
end-to-end values.  ``--sweep key=v1,v2,...`` runs the program once at
each value of a traffic parameter instead (the serving cell's rate).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6 --seconds 3
"""

from __future__ import annotations

import argparse
import json
import sys
from contextlib import nullcontext
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import faults  # noqa: E402
from perfbench import run as harness  # noqa: E402


def ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sweep", default=None, help="param=v1,v2,... (one program run each)")
    p.add_argument("--control", default=None, help="a control in place of the cell's (JSON)")
    p.add_argument("--param", action="append", default=[], help="param=value, for every run")
    p.add_argument("--fault", default=None, choices=sorted(faults.FAULTS),
                   help="plant a fault in the program for every program run")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = harness.Cell.load(args.workload, listed=False)
    print(f"calibrate: card {harness.card_line()}", file=sys.stderr, flush=True)
    runs = [("program", s, None, None) for s in args.seeds]
    control = json.loads(args.control) if args.control else cell.workload["control"]
    runs += [("control", s, control, None) for s in args.control_seeds]
    for item in args.param:
        key, value = item.split("=")
        cell.workload["params"][key] = json.loads(value)
    if args.sweep:
        key, values = args.sweep.split("=")
        runs = [("program", args.seeds[0] if args.seeds else 1, None, (key, float(v)))
                for v in values.split(",")]
    base = dict(cell.workload["params"])
    for kind, seed, control, param in runs:
        cell.workload["params"] = dict(base, **({param[0]: param[1]} if param else {}))
        with faults.FAULTS[args.fault]() if args.fault and kind == "program" else nullcontext():
            res = harness.execute(cell, seed, args.seconds, False, device, control=control)
        line = {"workload": args.workload, "kind": kind, "seed": seed, "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "numbers": res.get("numbers", {}),
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "check_s": res["check_s"], "attempted": res["attempted"], "failed": res["failed"],
                "memory_peak_bytes": res["device"]["memory_peak_bytes"]}
        if param:
            line["param"] = {param[0]: param[1]}
        if control:
            line["control"] = control
        if args.fault and kind == "program":
            line["fault"] = args.fault
        print(json.dumps(line), flush=True)
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
