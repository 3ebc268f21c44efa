"""One-command research deliverable, counterpart of
``sls_tpu/cli/report.py``:

    python -m sls_tpu_torch.cli.report --run_dir runs/<tag> --out deliverables

(1) runs the analysis suite (every ``cli.analyze`` command in
``SECTIONS``, with figures where matplotlib is installed) against the
run's checkpoint, loaded once (a section that fails is recorded, the
others still run, and the exit code is then 1); (2) renders a research-summary table in the
reference's shape from the measured numbers; (3) writes an executive
summary; (4) packages everything into a dated deliverable directory
through ``cli.package_results``.  Each section's seconds go to
``analysis/timings.json``.

``--demo`` first trains two tiny runs on the separable tone-against-noise
task with the port's ``Trainer`` (a per-timestep and a window-overlap
detector, the second for the comparison section), so the whole pipeline
runs with no dataset.  The report runs on the card unless
``SLS_TPU_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# analysis sections in deliverable order; (section, extra argv)
SECTIONS: List[Tuple[str, List[str]]] = [
    ("inspect", []),
    ("temporal", []),
    ("sparsity", []),
    ("importance", []),
    ("attribution", ["--ablation"]),
    ("failure", []),
    ("global-cues", []),
    ("probe", []),
    ("handcrafted", []),
    ("overlap", []),
]


def run_analysis_suite(
    run_dir: str,
    num_samples: int,
    batch_size: int,
    synthetic: bool,
    database_path: Optional[str] = None,
    protocol: Optional[str] = None,
    compare_run_dir: Optional[str] = None,
) -> Tuple[Dict[str, dict], Dict[str, str], Path]:
    """Every analyze subcommand against one loaded experiment.

    Returns (reports, errors, analysis_dir); models/params are loaded
    once (the reference reloads the checkpoint per script)."""
    from sls_tpu_torch.cli.analyze import (
        COMMANDS,
        _make_loader,
        build_parser,
        load_experiment,
    )

    analysis_dir = Path(run_dir) / "analysis"
    figures_dir = analysis_dir / "figures"
    analysis_dir.mkdir(parents=True, exist_ok=True)

    cfg, model = load_experiment(run_dir)
    parser = build_parser()
    figures = importlib.util.find_spec("matplotlib") is not None
    if not figures:
        print("[report] matplotlib is not installed: the sections run without figures")

    sections = list(SECTIONS)
    if compare_run_dir:
        sections.append(("compare", ["--compare_run_dir", compare_run_dir]))

    reports: Dict[str, dict] = {}
    errors: Dict[str, str] = {}
    timings: Dict[str, float] = {}
    t_suite = time.monotonic()
    for section, extra in sections:
        argv = [
            section, "--run_dir", str(run_dir),
            "--num_samples", str(num_samples),
            "--batch_size", str(batch_size),
        ] + (["--figures", str(figures_dir)] if figures else []) + extra
        if synthetic:
            argv.append("--synthetic")
        if database_path:
            argv += ["--database_path", database_path]
        if protocol:
            argv += ["--protocol", protocol]
        ns = parser.parse_args(argv)
        t0 = time.monotonic()
        try:
            loader = _make_loader(ns, cfg)
            report = COMMANDS[section](ns, cfg, model, loader)
            reports[section] = report
            out = analysis_dir / f"{section.replace('-', '_')}.json"
            out.write_text(json.dumps(report, indent=2, default=float))
            timings[section] = round(time.monotonic() - t0, 2)
            print(f"[report] {section}: ok in {timings[section]:.1f}s "
                  f"-> {out}")
        except Exception as e:  # noqa: BLE001 — collected, surfaced, rc!=0
            traceback.print_exc()
            errors[section] = f"{type(e).__name__}: {e}"
            timings[section] = round(time.monotonic() - t0, 2)
            print(f"[report] {section}: FAILED ({errors[section]})")
    # each section's wall-clock seconds, and the suite's
    timings["_total"] = round(time.monotonic() - t_suite, 2)
    timings["_num_samples"] = num_samples
    (analysis_dir / "timings.json").write_text(
        json.dumps(timings, indent=2))
    return reports, errors, analysis_dir


def _pct(x: float) -> str:
    return f"{100 * x:.1f}%"


def render_research_summary(
    reports: Dict[str, dict], compare_label: str = "comparison run"
) -> str:
    """The reference's research_summary_table.md shape, from measured
    numbers (reference tables 1-2: Jaccard, lifetime, transient ratio,
    flips/timestep, boundary discontinuity, optimal window)."""
    t = reports.get("temporal", {}).get("summary", {})
    spikes = reports.get("failure", {}).get("spikes", {})
    ms = reports.get("temporal", {}).get("multi_scale", {})
    lines = [
        "# Research summary (measured on this run)",
        "",
        "## Table 1: temporal stability",
        "",
        "| Metric | Value |",
        "|---|---|",
    ]
    if t:
        lines += [
            f"| Jaccard similarity | {_pct(t['mean_jaccard'])} |",
            f"| Feature lifetime (frames) | {t['mean_lifetime']:.2f} |",
            f"| Avg feature flips/timestep | {t['mean_flips']:.2f} |",
            # None (not "") marks a skipped optional row: "" survives
            # the is-not-None join filter and leaks blank lines into the
            # middle of the markdown table
            f"| Within-window Jaccard | {t['interior_jaccard']:.3f} |"
            if "interior_jaccard" in t else None,
            f"| Boundary Jaccard | {t['boundary_jaccard']:.3f} |"
            if "boundary_jaccard" in t else None,
            f"| Discontinuity score | {t.get('discontinuity', float('nan')):.3f} |"
            if "discontinuity" in t else None,
        ]
    if spikes and "spike_ratio" in spikes:
        lines.append(
            f"| Transient spike ratio | {_pct(spikes['spike_ratio'])} |")
    if ms and "optimal_window" in ms:
        lines += [
            "",
            "## Table 2: multi-scale structure",
            "",
            "| Window | Interior Jaccard | Boundary Jaccard | Discontinuity |",
            "|---|---|---|---|",
        ] + [
            f"| w={w} | {r['interior_jaccard']:.3f} "
            f"| {r['boundary_jaccard']:.3f} | {r['discontinuity']:.3f} |"
            for w, r in sorted(
                (int(float(k)), v)
                for k, v in ms.get("per_window", {}).items()
            )
        ] + ["", f"Optimal window (multi-scale probe): "
                 f"**{int(float(ms['optimal_window']))}**"]
    cmp_rep = reports.get("compare")
    if cmp_rep and "secondary" in cmp_rep:
        lines += [
            "",
            f"## Table 3: primary vs {compare_label}",
            "",
            "| Metric | Primary | Secondary | Delta |",
            "|---|---|---|---|",
        ] + [
            f"| {k} | {cmp_rep['primary'][k]:.4f} | "
            f"{cmp_rep['secondary'][k]:.4f} | {cmp_rep['delta'][k]:+.4f} |"
            for k in cmp_rep.get("delta", {})
        ]
    probe = reports.get("failure", {}).get("discriminative_transients")
    if probe:
        lines += [
            "",
            "## Discriminative transients (logistic-probe study)",
            "",
            "```json",
            json.dumps(probe, indent=2, default=float),
            "```",
        ]
    return "\n".join(line for line in lines if line is not None) + "\n"


def render_performance(score_metrics: List[str]) -> str:
    """Concatenate scorer outputs into the reference's
    4_all_model_performance.txt shape; honest placeholder when no
    scored eval exists on this image."""
    lines = ["PERFORMANCE (EER / min t-DCF)", "=" * 30, ""]
    if not score_metrics:
        lines += [
            "No scored evaluation attached to this run.",
            "Attach official-scorer outputs with --score_metrics "
            "<file> ... (produced by `python -m sls_tpu_torch.scores.evaluate`).",
        ]
    for path in score_metrics:
        p = Path(path)
        lines += [f"--- {p.name} ---", p.read_text().rstrip(), ""]
    return "\n".join(lines) + "\n"


def render_executive_summary(
    run_dir: str, reports: Dict[str, dict], errors: Dict[str, str]
) -> str:
    lines = [
        "EXECUTIVE SUMMARY — SAE TEMPORAL ANALYSIS",
        "=" * 45,
        "",
        f"Source run: {run_dir}",
        f"Analysis sections completed: {len(reports)}"
        + (f" (FAILED: {sorted(errors)})" if errors else ""),
        "",
    ]
    t = reports.get("temporal", {}).get("summary", {})
    if t:
        lines += [
            f"- temporal Jaccard {_pct(t['mean_jaccard'])}, "
            f"mean lifetime {t['mean_lifetime']:.1f} frames, "
            f"{t['mean_flips']:.1f} flips/timestep",
        ]
    insp = reports.get("inspect", {}).get("forward", {})
    if insp:
        lines.append(
            f"- checkpoint quality score {insp['quality_score']}/3 "
            f"(finite outputs, k-sparsity, feature diversity)"
        )
    att = reports.get("attribution", {})
    if "cue_consistency" in att:
        lines.append("- decision-cue consistency analysis: see "
                     "analysis/attribution.json")
    lines += [
        "",
        "FILES:",
        "- RESEARCH_SUMMARY.md   headline tables (reference "
        "research_summary_table.md shape)",
        "- PERFORMANCE.txt       EER / min t-DCF scorer outputs",
        "- analysis/*.json       one JSON report per analysis",
        "- analysis/figures/*.png PNG dashboards",
        "- SUMMARY.md            package manifest + training-log digest",
    ]
    return "\n".join(lines) + "\n"


def generate(
    run_dir: str,
    out_root: str = "deliverables",
    num_samples: int = 16,
    batch_size: int = 8,
    synthetic: bool = False,
    database_path: Optional[str] = None,
    protocol: Optional[str] = None,
    compare_run_dir: Optional[str] = None,
    score_metrics: Optional[List[str]] = None,
) -> Tuple[Path, Dict[str, str]]:
    """Full pipeline: analysis suite -> summaries -> dated package.

    Returns (deliverable_dir, errors); empty errors == complete report.
    """
    from sls_tpu_torch.cli.package_results import package

    reports, errors, analysis_dir = run_analysis_suite(
        run_dir, num_samples, batch_size, synthetic,
        database_path, protocol, compare_run_dir,
    )

    run = Path(run_dir)
    (run / "RESEARCH_SUMMARY.md").write_text(render_research_summary(reports))
    (run / "PERFORMANCE.txt").write_text(
        render_performance(score_metrics or [])
    )
    (run / "EXECUTIVE_SUMMARY.txt").write_text(
        render_executive_summary(run_dir, reports, errors)
    )

    extras = [run / "RESEARCH_SUMMARY.md"]
    extras += sorted(analysis_dir.glob("*.json"))
    extras += sorted((analysis_dir / "figures").glob("*.png"))
    dest = package(str(run), out_root, extra_files=extras)
    print(f"[report] deliverable: {dest}")
    if errors:
        print(f"[report] INCOMPLETE — failed sections: {errors}")
    return dest, errors


def build_demo_runs(root: Path, device=None) -> Tuple[str, str]:
    """Two tiny trained runs (per-timestep and window-overlap) on the
    synthetic separable task, so the whole deliverable pipeline runs
    with no dataset; on ``device`` (default: the entry points' device)."""
    import numpy as np

    from sls_tpu_torch.cli.main import platform_device
    from sls_tpu_torch.config import ExperimentConfig, RawBoostConfig, SAEConfig, TrainConfig
    from sls_tpu_torch.data.pipeline import ArrayLoader
    from sls_tpu_torch.train.loop import Trainer

    device = device if device is not None else platform_device()
    wav_len = 1000
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, size=24)
    t = np.arange(wav_len) / 16000.0
    wav = rng.normal(0, 0.05, size=(24, wav_len)).astype(np.float32)
    wav[labels == 1] += 0.3 * np.sin(2 * np.pi * 440 * t).astype(np.float32)

    dirs = []
    for variant in ("per_timestep", "window_overlap"):
        run_dir = root / f"demo_{variant}"
        cfg = ExperimentConfig(
            model=dataclasses.replace(
                _tiny_model_config(),
                sae=SAEConfig(activation_dim=64, dict_size=256, k=32,
                              variant=variant, window_size=8),
            ),
            train=TrainConfig(
                batch_size=8, lr=1e-3, num_epochs=2, cut_length=wav_len,
                rawboost=dataclasses.replace(RawBoostConfig(), algo=0),
            ),
        )
        loader = ArrayLoader(wav, np.asarray(labels), batch_size=8)
        trainer = Trainer(cfg, str(run_dir), tensorboard=False, device=device)
        trainer.init_state()
        trainer.fit(loader, loader)
        dirs.append(str(run_dir))
    return dirs[0], dirs[1]


def _tiny_model_config():
    from sls_tpu_torch.config import ModelConfig, SAEConfig, tiny_xlsr_config

    return ModelConfig(
        encoder=tiny_xlsr_config(),
        use_sae=True,
        use_sparse_features=True,
        sae=SAEConfig(activation_dim=64, dict_size=256, k=32),
        classifier_hidden=32,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="one-command research deliverable "
                    "(analysis suite + summaries + dated package)")
    p.add_argument("--run_dir", help="trained run directory")
    p.add_argument("--out", default="deliverables")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic audio (no dataset needed)")
    p.add_argument("--database_path", default=None)
    p.add_argument("--protocol", default=None)
    p.add_argument("--compare_run_dir", default=None)
    p.add_argument("--score_metrics", nargs="*", default=[],
                   help="official-scorer output files to embed")
    p.add_argument("--demo", action="store_true",
                   help="bootstrap tiny synthetic runs first (no "
                        "dataset, no checkpoint needed)")
    args = p.parse_args(argv)

    if args.demo:
        root = Path(args.out) / "demo_runs"
        root.mkdir(parents=True, exist_ok=True)
        primary, secondary = build_demo_runs(root)
        run_dir, compare, synthetic = primary, secondary, True
    else:
        if not args.run_dir:
            p.error("--run_dir is required (or pass --demo)")
        run_dir, compare = args.run_dir, args.compare_run_dir
        synthetic = args.synthetic

    _, errors = generate(
        run_dir, args.out, args.num_samples, args.batch_size,
        synthetic, args.database_path, args.protocol, compare,
        args.score_metrics,
    )
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
