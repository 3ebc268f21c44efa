"""Crash-resilient training runner, counterpart of
``sls_tpu/cli/autotrain.py``: the SLURM auto-resubmit loop as code.

    python -m sls_tpu_torch.cli.autotrain --target_epoch 39 \\
        --run_dir models/<tag> -- <cli.main args...>

Runs ``sls_tpu_torch.cli.main`` in a subprocess (the same interpreter;
it inherits ``SLS_TPU_PLATFORM``, so ``=cpu`` trains on the CPU), with
``--resume`` once the run directory's ``training_log.csv`` holds an
epoch, and restarts it on crash-style exits until the log reaches the
target epoch or the retry budget is spent.  Works under any scheduler
(or none).

The reference's rules: exit code 2 (argparse's, and the CLI's refusals)
fails fast instead of burning the restart budget; other non-zero exits
retry, but only ``--max_no_progress`` times in a row without the log
advancing an epoch (a run that crashes before finishing one new epoch is
a broken config, not a walltime kill); ``--max_restarts`` bounds the
attempts, ``--restart_delay`` spaces them.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

from sls_tpu_torch.cli.monitor import read_log


def last_epoch(run_dir: str) -> int:
    """The last epoch in ``run_dir``'s CSV log, -1 for none."""
    rows = read_log(run_dir)
    try:
        return int(rows[-1]["epoch"]) if rows else -1
    except (KeyError, ValueError):
        return -1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="auto-resuming trainer")
    parser.add_argument("--target_epoch", type=int, required=True)
    parser.add_argument("--run_dir", required=True,
                        help="run directory (model_dir/model_tag)")
    parser.add_argument("--max_restarts", type=int, default=20)
    parser.add_argument("--max_no_progress", type=int, default=3,
                        help="consecutive failed attempts tolerated "
                             "without the CSV log advancing an epoch")
    parser.add_argument("--restart_delay", type=float, default=5.0)
    parser.add_argument("train_args", nargs=argparse.REMAINDER,
                        help="arguments forwarded to sls_tpu_torch.cli.main "
                             "(prefix with --)")
    args = parser.parse_args(argv)

    forwarded = [a for a in args.train_args if a != "--"]
    restarts = 0
    no_progress = 0
    while True:
        done = last_epoch(args.run_dir)
        if done >= args.target_epoch:
            print(f"target epoch {args.target_epoch} reached (last={done})")
            return 0
        if restarts > args.max_restarts:
            print(f"giving up after {restarts} restarts (last epoch {done})")
            return 1

        cmd = [sys.executable, "-m", "sls_tpu_torch.cli.main", *forwarded]
        if done >= 0 and "--resume" not in cmd:
            cmd.append("--resume")
        print(f"[autotrain] attempt {restarts}: {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd)
        now = last_epoch(args.run_dir)
        if proc.returncode == 0 and now >= args.target_epoch:
            return 0
        if proc.returncode == 2:
            # bad flags or a refused combination: a retry runs the same
            # broken command again
            print("[autotrain] exit code 2 (usage/config error) — "
                  "not retrying", flush=True)
            return 2
        if now > done:
            no_progress = 0  # real progress: a crash or walltime kill, retry
        else:
            no_progress += 1
            if no_progress >= args.max_no_progress:
                print(f"[autotrain] {no_progress} consecutive failures "
                      f"with no epoch progress (stuck at {now}) — "
                      "giving up; fix the config and rerun", flush=True)
                return 1
        restarts += 1
        time.sleep(args.restart_delay)


if __name__ == "__main__":
    raise SystemExit(main())
