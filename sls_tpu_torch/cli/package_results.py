"""Results packaging, counterpart of ``sls_tpu/cli/package_results.py``:
copies a run directory's training log, score files, JSON reports and PNG
dashboards into ``<out>/results_<date>/`` and writes a SUMMARY.md with
headline metrics from the CSV log.

    python -m sls_tpu_torch.cli.package_results --run_dir models/<tag>
"""

from __future__ import annotations

import argparse
import datetime
import shutil
from pathlib import Path

from sls_tpu_torch.cli.monitor import read_log


def package(run_dir: str, out_root: str, extra_files=()) -> Path:
    run = Path(run_dir)
    date = datetime.date.today().isoformat()
    dest = Path(out_root) / f"results_{date}"
    dest.mkdir(parents=True, exist_ok=True)

    patterns = ["training_log.csv", "*.json", "*.png", "*.txt"]
    copied = []
    for pattern in patterns:
        for f in run.glob(pattern):
            shutil.copy2(f, dest / f.name)
            copied.append(f.name)
    for f in extra_files:
        f = Path(f)
        if f.exists():
            shutil.copy2(f, dest / f.name)
            copied.append(f.name)

    rows = read_log(run_dir)
    lines = [f"# Results package — {date}", "", f"Source run: `{run}`", ""]
    if rows:
        lines.append(f"- epochs trained: {len(rows)}")
        # a crashed run can leave partial/non-numeric CSV rows — package
        # what's parseable rather than aborting half-built (same guard
        # as cli/monitor.py)
        try:
            numeric = [r for r in rows if r.get("val_eer")]
            best = min(numeric, key=lambda r: float(r["val_eer"]))
            lines.append(
                f"- best val EER: {float(best['val_eer']):.4f}% "
                f"(epoch {best['epoch']})"
            )
        except (ValueError, KeyError):
            lines.append("- best val EER: unavailable (malformed log rows)")
        final_loss = rows[-1].get("train_loss", "")
        if final_loss:
            lines.append(f"- final train loss: {final_loss}")
    lines += ["", "## Files", ""] + [f"- {name}" for name in sorted(copied)]
    (dest / "SUMMARY.md").write_text("\n".join(lines) + "\n")
    return dest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="package run results")
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--out", default="deliverables")
    parser.add_argument("--extra", nargs="*", default=[])
    args = parser.parse_args(argv)
    dest = package(args.run_dir, args.out, args.extra)
    print(f"packaged into {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
