"""The analysis suite as one command, counterpart of
``sls_tpu/cli/analyze.py`` (the reference's ~35 analyze_* / probe_* /
evaluate_* scripts as subcommands):

    python -m sls_tpu_torch.cli.analyze <command> --run_dir <dir> [options]

Commands (reference script equivalents):
  temporal     analyze_temporal_stability.py, analyze_window_limitations.py
  sparsity     evaluate_sparsity.py, evaluate_window_topk_sparsity.py,
               simple_sparsity_check.py
  attribution  analyze_decision_relevance.py (gradient + ablation + cues)
  importance   analyze_sae_neurons.py, per-model analyze_feature_importance
  probe        probe_acoustic_asvspoof.py (acoustic correlation probe)
  handcrafted  compare_handcrafted_features.py
  overlap      eval_overlap_clean.py / eval_overlap_eer.py
  inspect      test_interpretability.py (weights, a forward, a 0-3 score)
  compare      compare_temporal_models.py (two run directories)
  failure      analyze_boundary_error_correlation.py,
               improved_transient_analysis.py
  global-cues  analyze_global_cue_consistency.py
  gates        the SLS family's sensitive-layer gate profile, per class

Each command writes a JSON report (``--output``, else stdout) and, with
``--figures DIR``, its PNG dashboards.  The model is rebuilt from the
checkpoint's embedded config, from a run directory of either package
(``serve/scorer.py::load_serving_parts``), with ``int8_serving`` off:
analysis wants the fp numerics the model trained in, and gradients
through the int8 route's rounding are zero.  Every command but ``gates``
needs a detector run and refuses an SLS one; ``gates`` refuses a
detector run.  Data come from ``--protocol`` / ``--database_path`` or,
with ``--synthetic``, from the reference's seeded noise.  The commands
run on the card unless ``SLS_TPU_PLATFORM=cpu`` asks for the CPU
(``cli/main.py::platform_device``).  Codes come from
``Detector.encode_sae`` (no decode) a batch at a time, copied to the
host once a batch.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.train.steps import dequantize_wire


def _load(run_dir: str, checkpoint: Optional[str], device, sls: bool):
    """(cfg, model) of a run directory with int8 serving off; the family
    checked against ``sls`` (module docstring)."""
    from sls_tpu_torch.cli.main import platform_device
    from sls_tpu_torch.serve.scorer import is_sls_state, load_serving_parts, serving_model

    cfg, params = load_serving_parts(run_dir, checkpoint, int8=False)
    if is_sls_state(params) and not sls:
        raise SystemExit(
            "this run dir holds an SLS-family checkpoint (params carry 'sls_head'); the SAE "
            "analysis suite needs a detector run; for SLS interpretability use: analyze gates "
            "--run_dir ...")
    if sls and not is_sls_state(params):
        raise SystemExit(
            "'gates' needs an SLS-family checkpoint (params carrying 'sls_head'); this run dir "
            "holds a detector run; use the SAE analysis commands instead")
    return cfg, serving_model(cfg, params, device if device is not None else platform_device())


def load_experiment(run_dir: str, checkpoint: Optional[str] = None, device=None):
    """(cfg, Detector) of a detector run directory (explicit checkpoint >
    last > best), on ``device`` (default: the entry points' device)."""
    return _load(run_dir, checkpoint, device, sls=False)


def load_sls_experiment(run_dir: str, checkpoint: Optional[str] = None, device=None):
    """(cfg, SLSDetector) of an SLS-family run directory."""
    return _load(run_dir, checkpoint, device, sls=True)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _collect_codes(model, loader, max_samples: int) -> Tuple[np.ndarray, np.ndarray,
                                                             Optional[np.ndarray]]:
    """Batches through ``encode_sae``: (codes, wavs, labels) of the first
    ``max_samples`` valid rows, on the host."""
    dev = _device(model)
    codes, wavs, labels = [], [], []
    n = 0
    for batch in loader.epoch(0):
        with torch.inference_mode():
            w = dequantize_wire(torch.from_numpy(np.ascontiguousarray(batch.wav)).to(dev))
            c = model.encode_sae(w)["codes"].float().cpu().numpy()
        v = batch.valid
        codes.append(c[v])
        wavs.append(batch.wav[v])
        if batch.labels is not None:
            labels.append(batch.labels[v])
        n += int(v.sum())
        if n >= max_samples:
            break
    return (
        np.concatenate(codes)[:max_samples],
        np.concatenate(wavs)[:max_samples],
        np.concatenate(labels)[:max_samples] if labels else None,
    )


def _make_loader(args, cfg):
    """Dataset loader from dirs, or the reference's synthetic loader."""
    from sls_tpu_torch.data.pipeline import ArrayLoader, BatchLoader, DatasetIndex
    from sls_tpu_torch.data.protocols import parse_train_protocol

    if args.synthetic:
        rng = np.random.default_rng(args.seed)
        n = max(args.num_samples, 2 * args.batch_size)
        wavs = rng.normal(0, 0.1, (n, cfg.train.cut_length)).astype(np.float32)
        labels = rng.integers(0, 2, n)
        return ArrayLoader(wavs, labels, batch_size=args.batch_size)

    if not args.protocol or not args.database_path:
        raise SystemExit(
            "ERROR: provide --protocol and --database_path for dataset "
            "analysis, or use --synthetic for a smoke run"
        )
    labels_map, ids = parse_train_protocol(args.protocol)
    index = DatasetIndex.for_train(ids, labels_map, args.database_path, ext=args.audio_ext)
    return BatchLoader(index, args.batch_size, cut=cfg.train.cut_length)


def cmd_temporal(args, cfg, model, loader):
    from sls_tpu_torch.analysis.temporal import multi_scale_structure, temporal_summary

    codes, _, _ = _collect_codes(model, loader, args.num_samples)
    w = cfg.model.sae.window_size
    report = {
        "summary": temporal_summary(codes, w),
        "multi_scale": multi_scale_structure(codes),
        "num_samples": int(codes.shape[0]),
    }
    if args.figures:
        from sls_tpu_torch.analysis.temporal import (
            jaccard_consecutive,
            transient_persistent_split,
        )
        from sls_tpu_torch.analysis.visualize import plot_temporal_stability

        life = transient_persistent_split(codes, w)["lifetime"]
        report["figures"] = [plot_temporal_stability(
            jaccard_consecutive(codes), w,
            Path(args.figures) / "temporal_stability.png",
            lifetimes=life[life > 0],
        )]
    return report


def cmd_sparsity(args, cfg, model, loader):
    from sls_tpu_torch.analysis.sparsity import sparsity_stats, weight_diagnostics

    codes, _, _ = _collect_codes(model, loader, args.num_samples)
    return {
        "activations": sparsity_stats(codes),
        "weights": weight_diagnostics(model.sae.W_dec),
        "expected_k": cfg.model.sae.k,
    }


def cmd_attribution(args, cfg, model, loader):
    from sls_tpu_torch.analysis.attribution import (
        ablation_attribution,
        attribution_scores,
        top_k_cues,
        within_class_cue_consistency,
    )

    codes, _, labels = _collect_codes(model, loader, args.num_samples)
    scores = attribution_scores(model, codes)
    cues = top_k_cues(scores, k=args.top_k)
    report = {
        "num_samples": int(codes.shape[0]),
        "top_cues_per_sample": cues.tolist(),
    }
    if labels is not None:
        report["cue_consistency"] = within_class_cue_consistency(cues, labels)
    if args.ablation:
        global_top = np.argsort(-scores.sum(0))[: args.top_k]
        deltas = ablation_attribution(model, codes, global_top)
        report["ablation"] = {
            "features": global_top.tolist(),
            "mean_prob_drop": deltas.mean(0).tolist(),
        }
    if args.figures:
        from sls_tpu_torch.analysis.visualize import plot_attribution_report

        report["figures"] = [plot_attribution_report(
            scores,
            Path(args.figures) / "decision_relevance.png",
            top_k=args.top_k,
            consistency=report.get("cue_consistency"),
            ablation=report.get("ablation"),
        )]
    return report


def cmd_importance(args, cfg, model, loader):
    from sls_tpu_torch.analysis.importance import (
        class_feature_importance,
        interpretability_info,
    )

    codes, _, labels = _collect_codes(model, loader, args.num_samples)
    info = interpretability_info(codes)
    report = {"mean_sparsity": float(info["sparsity"].mean())}
    if labels is not None:
        imp = class_feature_importance(info["avg_activation"], labels)
        report["most_discriminative_features"] = imp["most_discriminative_features"].tolist()
        report["discriminative_scores"] = imp["discriminative_scores"].tolist()
        if args.figures:
            from sls_tpu_torch.analysis.importance import per_feature_class_stats
            from sls_tpu_torch.analysis.visualize import plot_feature_statistics

            report["figures"] = [plot_feature_statistics(
                per_feature_class_stats(codes, labels),
                Path(args.figures) / "feature_statistics.png",
                top_k=args.top_k,
            )]
    return report


def cmd_probe(args, cfg, model, loader):
    from sls_tpu_torch.analysis.probes import acoustic_probe

    codes, wavs, _ = _collect_codes(model, loader, args.num_samples)
    out = acoustic_probe(codes, wavs, top_k=args.top_k)
    report = {
        prop: {
            "top_features": d["top_features"].tolist(),
            "top_correlations": d["top_correlations"].tolist(),
        }
        for prop, d in out.items()
    }
    if args.figures:
        from sls_tpu_torch.analysis.visualize import plot_acoustic_probe

        report["figures"] = [plot_acoustic_probe(
            {k: v for k, v in report.items() if k != "figures"},
            Path(args.figures) / "acoustic_probe.png",
        )]
    return report


def cmd_handcrafted(args, cfg, model, loader):
    from sls_tpu_torch.analysis.probes import handcrafted_stability_comparison

    codes, wavs, _ = _collect_codes(model, loader, args.num_samples)
    return handcrafted_stability_comparison(codes, wavs)


def cmd_overlap(args, cfg, model, loader):
    from sls_tpu_torch.evaluation.overlap import overlap_stability_eval

    res = overlap_stability_eval(model, loader, window=cfg.model.sae.window_size,
                                 max_samples=args.num_samples, device=_device(model))
    res.pop("scores")  # keep the JSON small; scores go through the eval CLI
    return res


def cmd_inspect(args, cfg, model, loader):
    """Checkpoint smoke test: the architecture read from the weights, a
    forward on noise, and an interpretability quality score 0-3
    (reference: test_interpretability.py:17-191)."""
    report = {"config": {"sae_dict_size": cfg.model.sae.dict_size,
                         "sae_k": cfg.model.sae.k,
                         "variant": cfg.model.sae.variant,
                         "use_sparse_features": cfg.model.use_sparse_features}}

    # the architecture from the weight shapes: W_enc is [D, M] as in the
    # reference, fc1's weight [out, in] (the reference's kernel is [in, out])
    w_enc = model.sae.W_enc
    cls_in = model.classifier.fc1.weight.shape[1]
    report["inferred"] = {
        "activation_dim": int(w_enc.shape[0]),
        "dict_size": int(w_enc.shape[1]),
        "classifier_input_dim": int(cls_in),
        "uses_sparse_features": bool(cls_in == w_enc.shape[1]),
    }
    report["config_weight_consistency"] = bool(
        report["inferred"]["dict_size"] == cfg.model.sae.dict_size
        and report["inferred"]["uses_sparse_features"] == cfg.model.use_sparse_features)

    rng = np.random.default_rng(args.seed)
    wav = rng.normal(0, 0.1, (2, cfg.train.cut_length)).astype(np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(wav).to(_device(model)))
        codes = out["codes"].float().cpu().numpy()
        finite = bool(torch.isfinite(out["log_probs"]).all())
    active_per_frame = (codes > 0).sum(-1).mean()
    feature_diversity = ((codes > 0).any(axis=(0, 1))).mean()
    quality = int(finite) \
        + int(0 < active_per_frame <= cfg.model.sae.k) \
        + int(feature_diversity > 0.01)
    report["forward"] = {
        "finite_outputs": finite,
        "mean_active_per_frame": float(active_per_frame),
        "feature_diversity": float(feature_diversity),
        "quality_score": quality,  # 0-3
    }
    return report


def cmd_compare(args, cfg, model, loader):
    """Side-by-side temporal metrics of two run directories
    (reference: compare_temporal_models.py, compare_temporal_stability.py)."""
    from sls_tpu_torch.analysis.temporal import temporal_summary

    codes, _, _ = _collect_codes(model, loader, args.num_samples)
    report = {"primary": temporal_summary(codes, cfg.model.sae.window_size)}
    if args.compare_run_dir:
        cfg2, model2 = load_experiment(args.compare_run_dir, device=_device(model))
        codes2, _, _ = _collect_codes(model2, loader, args.num_samples)
        del model2
        report["secondary"] = temporal_summary(codes2, cfg2.model.sae.window_size)
        report["delta"] = {
            k: report["secondary"][k] - report["primary"][k]
            for k in report["primary"]
            if isinstance(report["primary"][k], float)
        }
    return report


def cmd_failure(args, cfg, model, loader):
    """Boundary-error correlation, transient spikes and discriminative
    transients (reference: analyze_boundary_error_correlation.py,
    analyze_window_limitations.py, improved_transient_analysis.py)."""
    from sls_tpu_torch.analysis.failure_modes import (
        boundary_error_correlation,
        discriminative_transients_probe,
        transient_spike_stats,
    )

    codes, _, labels = _collect_codes(model, loader, args.num_samples)
    report = {"spikes": transient_spike_stats(codes)}
    correct = None
    if labels is not None:
        with torch.inference_mode():
            logp = model.classify_codes(torch.from_numpy(codes).to(_device(model)))
            pred = logp.argmax(-1).cpu().numpy()
        correct = pred == labels
        report["boundary_error_correlation"] = boundary_error_correlation(
            codes, correct, cfg.model.sae.window_size)
        report["discriminative_transients"] = discriminative_transients_probe(codes, labels)
    if args.figures:
        from sls_tpu_torch.analysis.temporal import transient_persistent_split
        from sls_tpu_torch.analysis.visualize import (
            plot_boundary_discontinuity,
            plot_transient_persistent,
        )

        figdir = Path(args.figures)
        dt = report.get("discriminative_transients")
        thr = (dt["lifetime_threshold"] if dt
               else float(np.median(
                   transient_persistent_split(codes, 1.0)["lifetime"]) or 1.0))
        report["figures"] = [
            plot_boundary_discontinuity(
                codes, cfg.model.sae.window_size,
                figdir / "boundary_discontinuity_analysis.png",
                correct=correct,
            ),
            plot_transient_persistent(
                transient_persistent_split(codes, thr)["lifetime"], thr,
                figdir / "transient_vs_persistent.png",
                probe_acc=dt,
            ),
        ]
    return report


def cmd_global_cues(args, cfg, model, loader):
    """Utterance-global cue consistency
    (reference: analyze_global_cue_consistency.py)."""
    from sls_tpu_torch.analysis.failure_modes import global_cue_consistency

    codes, _, _ = _collect_codes(model, loader, args.num_samples)
    return global_cue_consistency(codes, top_k=args.top_k)


def cmd_gates(args):
    """The SLS head's layer gates over the data: which encoder layers it
    considers sensitive, overall and per class, with a bar chart.  Loads
    an SLS run directory itself (the other commands analyse detector
    runs)."""
    from sls_tpu_torch.models.sls import layer_gate_profile

    cfg, model = load_sls_experiment(args.run_dir, args.checkpoint)
    loader = _make_loader(args, cfg)
    wavs, labels, n = [], [], 0
    for batch in loader.epoch(0):
        v = batch.valid
        wavs.append(batch.wav[v])
        if batch.labels is not None:
            labels.append(batch.labels[v])
        n += int(v.sum())
        if n >= args.num_samples:
            break
    wav = np.concatenate(wavs)[: args.num_samples]
    report = layer_gate_profile(model, wav, return_gates=True)
    gates = report.pop("gates")  # [L, B]: one encoder forward for all
    if labels:
        lab = np.concatenate(labels)[: args.num_samples]
        for cls, name in ((0, "spoof"), (1, "bonafide")):
            sel = lab == cls
            if sel.any():
                report[f"mean_gate_per_layer_{name}"] = gates[:, sel].mean(axis=1).tolist()
    if args.figures:
        from sls_tpu_torch.analysis.visualize import plot_layer_gates

        plot_layer_gates(report["mean_gate_per_layer"], report["std_gate_per_layer"],
                         Path(args.figures) / "layer_gates.png")
    return report


COMMANDS = {
    "temporal": cmd_temporal,
    "sparsity": cmd_sparsity,
    "attribution": cmd_attribution,
    "importance": cmd_importance,
    "probe": cmd_probe,
    "handcrafted": cmd_handcrafted,
    "overlap": cmd_overlap,
    "inspect": cmd_inspect,
    "compare": cmd_compare,
    "failure": cmd_failure,
    "global-cues": cmd_global_cues,
    "gates": cmd_gates,
}


def build_parser():
    p = argparse.ArgumentParser(description="sls_tpu_torch analysis suite")
    p.add_argument("command", choices=sorted(COMMANDS))
    p.add_argument("--run_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--output", default=None, help="JSON report path")
    p.add_argument("--num_samples", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--ablation", action="store_true")
    p.add_argument("--database_path", default=None)
    p.add_argument("--protocol", default=None)
    p.add_argument("--audio_ext", default="flac")
    p.add_argument("--figures", default=None,
                   help="directory for PNG dashboards; emitted by temporal / attribution / "
                        "importance / probe / failure / gates")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic audio smoke run (no dataset needed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compare_run_dir", default=None,
                   help="second run dir for the 'compare' command")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "gates":
        report = cmd_gates(args)
    else:
        cfg, model = load_experiment(args.run_dir, args.checkpoint)
        loader = _make_loader(args, cfg)
        report = COMMANDS[args.command](args, cfg, model, loader)
    text = json.dumps(report, indent=2, default=float)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
