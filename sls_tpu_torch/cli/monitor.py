"""Training monitor, counterpart of ``sls_tpu/cli/monitor.py``: a run
directory's ``training_log.csv`` (``train/loop.py``'s ``CSV_FIELDS``, the
reference's columns) as a table with the best validation EER:

    python -m sls_tpu_torch.cli.monitor --run_dir models/<tag> [--watch 30]
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path


def read_log(run_dir: str):
    path = Path(run_dir) / "training_log.csv"
    if not path.exists():
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def render(rows, tail: int = 10) -> str:
    if not rows:
        return "no training_log.csv yet"
    cols = ["epoch", "train_loss", "train_eer", "val_loss", "val_eer",
            "val_acc", "epoch_seconds"]
    lines = ["  ".join(f"{c:>12}" for c in cols)]
    for row in rows[-tail:]:
        lines.append("  ".join(f"{row.get(c, ''):>12}" for c in cols))
    try:
        best = min(rows, key=lambda r: float(r["val_eer"]))
        lines.append(
            f"\nbest val EER: {float(best['val_eer']):.4f}% @ epoch "
            f"{best['epoch']}  ({len(rows)} epochs logged)"
        )
    except (KeyError, ValueError):
        pass
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="training run monitor")
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--tail", type=int, default=10)
    parser.add_argument("--watch", type=int, default=0,
                        help="poll interval seconds (0 = print once)")
    args = parser.parse_args(argv)

    while True:
        print(render(read_log(args.run_dir), args.tail), flush=True)
        if not args.watch:
            return 0
        time.sleep(args.watch)
        print("\n" + "=" * 80 + "\n")


if __name__ == "__main__":
    raise SystemExit(main())
