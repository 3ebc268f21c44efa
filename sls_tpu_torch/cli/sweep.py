"""Sweep runner, counterpart of ``sls_tpu/cli/sweep.py``: the
reference's k / dict / window SLURM sweep as one command.

    python -m sls_tpu_torch.cli.sweep --preset reference -- \\
        --database_path ... --num_epochs 40

    python -m sls_tpu_torch.cli.sweep --grid k=32,64,128,256 dict=4096,8192 -- \\
        --num_epochs 40 ...

Each point runs ``sls_tpu_torch.cli.main`` through ``cli.autotrain``
(crash resilience) with ``--comment <tag>``, so every point gets its own
run directory (the run-name-as-config idiom), which ``resolve_run_dir``
predicts through the CLI's own parser and config.  Points whose CSV log
has reached the target epoch are skipped, so the sweep resumes; a failed
point is recorded and the sweep goes on, except after a config error
(exit code 2), which the same flags would repeat at every point.
Writes ``<model_dir>/sweep_summary.json`` (each point's status and best
validation EER, ``n_done``, ``n_points``).  The children inherit
``SLS_TPU_PLATFORM``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

from sls_tpu_torch.cli.monitor import read_log

# the reference's 8 training sweep jobs as 7 distinct configurations
# (train_k*.slurm, train_dict8192.slurm, train_window_topk.slurm,
# train_cpc.slurm; all: bs 14, lr 1e-6, wd 1e-4, 40 epochs, LA track).
# The 8th, train_asvspoof_df.slurm, trains --track=LA at k=128 /
# dict=4096 like train_k128_sparse.slurm and differs only in --comment,
# so it is not repeated here.
REFERENCE_PRESET = [
    {"tag": "k32_sparse_4096dim", "sae_k": 32, "sae_dict_size": 4096},
    {"tag": "k64_sparse", "sae_k": 64, "sae_dict_size": 4096},
    {"tag": "k128_sparse_4096dim", "sae_k": 128, "sae_dict_size": 4096},
    {"tag": "k256_sparse", "sae_k": 256, "sae_dict_size": 4096},
    {"tag": "dict8k_sparse", "sae_k": 128, "sae_dict_size": 8192},
    {"tag": "window_topk_w8", "sae_k": 128, "sae_dict_size": 4096,
     "use_window_topk": True, "sae_window_size": 8},
    {"tag": "cpc", "sae_k": 128, "sae_dict_size": 4096,
     "use_cpc": True, "sae_window_size": 8, "cpc_weight": 0.5},
]

_GRID_NAMES = {"k": "sae_k", "dict": "sae_dict_size", "w": "sae_window_size",
               "lr": "lr", "bs": "batch_size", "sae_weight": "sae_weight"}


def parse_grid(specs: List[str]) -> List[Dict]:
    """``k=32,64 dict=4096,8192 w=8`` -> the cartesian product's points
    (a window axis implies the window variant)."""
    axes = []
    for spec in specs:
        name, _, vals = spec.partition("=")
        if not vals:
            raise SystemExit(f"bad grid spec: {spec!r} (want name=v1,v2)")
        key = _GRID_NAMES.get(name, name)
        parsed = [float(v) if "." in v or "e" in v.lower() else int(v)
                  for v in vals.split(",")]
        axes.append([(key, v) for v in parsed])
    points = []
    for combo in itertools.product(*axes):
        point = dict(combo)
        if "sae_window_size" in point:
            point["use_window_topk"] = True
        point["tag"] = "_".join(
            f"{k.replace('sae_', '').replace('dict_size', 'dict')}{v}" for k, v in combo)
        points.append(point)
    return points


def point_args(point: Dict) -> List[str]:
    """A sweep point -> cli.main flags."""
    args = ["--comment", point["tag"]]
    for key, value in point.items():
        if key == "tag":
            continue
        if isinstance(value, bool):
            if value:
                args.append(f"--{key}")
        else:
            args.extend([f"--{key}", str(value)])
    return args


def resolve_run_dir(point: Dict, forwarded: List[str], model_dir: Path) -> Path:
    """The run directory ``cli.main`` will use for a point: the final
    flags through its own parser and config function, then its run tag."""
    from sls_tpu_torch.cli.main import build_parser, config_from_args

    ns = build_parser().parse_args(
        [*point_args(point), "--model_dir", str(model_dir), *forwarded])
    return model_dir / config_from_args(ns).model_tag()


def point_status(run_dir: Path, target_epoch: int) -> Dict:
    """pending (no log), partial or done, with the last epoch and the
    best validation EER."""
    rows = read_log(str(run_dir))
    if not rows:
        return {"state": "pending", "run_dir": str(run_dir)}
    last = int(rows[-1]["epoch"])
    best = min((float(r["val_eer"]) for r in rows if r.get("val_eer")), default=None)
    return {"state": "done" if last >= target_epoch else "partial",
            "run_dir": str(run_dir), "last_epoch": last, "best_val_eer": best}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="hyperparameter sweep runner")
    sel = p.add_mutually_exclusive_group(required=True)
    sel.add_argument("--preset", choices=["reference"],
                     help="the reference's k/dict/window/cpc sweep matrix (8 jobs, 7 "
                          "distinct configs: REFERENCE_PRESET)")
    sel.add_argument("--grid", nargs="+", help="axes like k=32,64,128 dict=4096,8192")
    p.add_argument("--model_dir", default="models")
    p.add_argument("--target_epoch", type=int, default=39,
                   help="epoch at which a point counts as done (the reference's "
                        "auto-resubmit target)")
    p.add_argument("--max_restarts", type=int, default=5,
                   help="per-point crash-restart budget (autotrain)")
    p.add_argument("--dry_run", action="store_true", help="print the commands without running")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="flags forwarded to every cli.main run (prefix with --)")
    args = p.parse_args(argv)

    points = REFERENCE_PRESET if args.preset == "reference" else parse_grid(args.grid)
    forwarded = [a for a in args.train_args if a != "--"]
    model_dir = Path(args.model_dir)
    summary: Dict = {"points": {}}

    for point in points:
        tag = point["tag"]
        run_dir = resolve_run_dir(point, forwarded, model_dir)
        status = point_status(run_dir, args.target_epoch)
        if status["state"] == "done":
            print(f"[sweep] {tag}: already done (best val EER {status['best_val_eer']})",
                  flush=True)
            summary["points"][tag] = status
            continue

        cmd = [sys.executable, "-m", "sls_tpu_torch.cli.autotrain",
               "--target_epoch", str(args.target_epoch), "--run_dir", str(run_dir),
               "--max_restarts", str(args.max_restarts), "--",
               *point_args(point), "--model_dir", str(model_dir), *forwarded]
        print(f"[sweep] {tag}: {' '.join(cmd)}", flush=True)
        if args.dry_run:
            summary["points"][tag] = {"state": "dry_run", "cmd": cmd, "run_dir": str(run_dir)}
            continue

        rc = subprocess.run(cmd).returncode
        final = point_status(run_dir, args.target_epoch)
        final["exit_code"] = rc
        summary["points"][tag] = final
        if rc == 2:
            print(f"[sweep] {tag}: config error — aborting the sweep (the same flags "
                  "would break every point)", flush=True)
            break

    done = sum(1 for s in summary["points"].values() if s.get("state") == "done")
    summary["n_done"] = done
    summary["n_points"] = len(points)
    model_dir.mkdir(parents=True, exist_ok=True)
    out = model_dir / "sweep_summary.json"
    out.write_text(json.dumps(summary, indent=2))
    print(f"[sweep] {done}/{len(points)} done -> {out}", flush=True)
    return 0 if done == len(points) else 1


if __name__ == "__main__":
    raise SystemExit(main())
