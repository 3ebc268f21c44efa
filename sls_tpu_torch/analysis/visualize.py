"""PNG dashboards for the analysis suite, counterpart of
``sls_tpu/analysis/visualize.py``:
- feature statistics dashboard (reference: analyze_sae_neurons.py:245
  visualize_features)
- temporal-stability / boundary-discontinuity figure (reference:
  analyze_boundary_semantics.py -> boundary_discontinuity_analysis.png)
- decision-feature activation vs mel-spectrogram panels (reference:
  visualize_decision_features.py)
- the attribution, acoustic-probe and transient / persistent dashboards.

matplotlib is imported by each function when it runs, on the Agg
backend (no display), never when this module is imported: a machine
without matplotlib imports the analysis suite and runs every command
that is not asked for figures.  All functions return the saved path.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_path) -> str:
    """Lay out, write and close ``fig``; the path written."""
    fig.tight_layout()
    out_path = str(out_path)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    _pyplot().close(fig)
    return out_path


def plot_feature_statistics(
    stats: Dict[str, np.ndarray], out_path, top_k: int = 30
) -> str:
    """Dashboard from per_feature_class_stats output: class means,
    selectivity ranking, activation-frequency histogram."""
    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(12, 8))

    sel = np.asarray(stats["selectivity"])
    order = np.argsort(-sel)[:top_k]
    axes[0, 0].bar(range(len(order)), sel[order], color="tab:purple")
    axes[0, 0].set_title(f"top-{top_k} selective features")
    axes[0, 0].set_xlabel("rank")
    axes[0, 0].set_ylabel("|freq(bona) - freq(spoof)|")

    axes[0, 1].scatter(stats["bonafide_freq"], stats["spoof_freq"], s=4,
                       alpha=0.4)
    axes[0, 1].plot([0, 1], [0, 1], "k--", lw=0.5)
    axes[0, 1].set_xlabel("bonafide activation freq")
    axes[0, 1].set_ylabel("spoof activation freq")
    axes[0, 1].set_title("per-feature class frequencies")

    axes[1, 0].hist(stats["bonafide_mean"], bins=50, alpha=0.6,
                    label="bonafide")
    axes[1, 0].hist(stats["spoof_mean"], bins=50, alpha=0.6, label="spoof")
    axes[1, 0].set_title("mean activation distribution")
    axes[1, 0].legend()

    both = np.asarray(stats["bonafide_freq"]) + np.asarray(stats["spoof_freq"])
    axes[1, 1].hist(both, bins=50, color="tab:gray")
    axes[1, 1].set_title("overall activation frequency")

    return _save(fig, out_path)


def plot_temporal_stability(
    jaccard_trace: np.ndarray, window: int, out_path,
    lifetimes: Optional[np.ndarray] = None,
) -> str:
    """Per-frame Jaccard trace with window-boundary markers + lifetime
    histogram (the boundary-discontinuity figure)."""
    plt = _pyplot()
    n_panels = 2 if lifetimes is not None else 1
    fig, axes = plt.subplots(n_panels, 1, figsize=(12, 4 * n_panels),
                             squeeze=False)

    trace = np.asarray(jaccard_trace)
    mean_trace = trace.mean(axis=0) if trace.ndim == 2 else trace
    ax = axes[0, 0]
    ax.plot(mean_trace, lw=1.0, label="frame-to-frame Jaccard")
    for b in range(window - 1, len(mean_trace), window):
        ax.axvline(b, color="tab:red", alpha=0.3, lw=0.8)
    ax.set_xlabel("frame transition")
    ax.set_ylabel("Jaccard")
    ax.set_title(f"temporal stability (window boundaries every {window})")
    ax.legend()

    if lifetimes is not None:
        axes[1, 0].hist(np.asarray(lifetimes), bins=40, color="tab:green")
        axes[1, 0].set_title("feature lifetime distribution (frames)")

    return _save(fig, out_path)


def plot_decision_features(
    wav: np.ndarray,
    codes: np.ndarray,
    feature_ids: Sequence[int],
    out_path,
    sr: int = 16000,
) -> str:
    """Mel-spectrogram with aligned activation traces of the top decision
    features for one utterance."""
    plt = _pyplot()
    from sls_tpu_torch.analysis.dsp import mel_spectrogram

    mel = mel_spectrogram(np.asarray(wav), sr=sr)  # [T, n_mels]
    T = min(len(mel), codes.shape[0])

    fig, axes = plt.subplots(2, 1, figsize=(12, 7), sharex=True,
                             gridspec_kw={"height_ratios": [2, 1]})
    axes[0].imshow(mel[:T].T, aspect="auto", origin="lower",
                   cmap="magma")
    axes[0].set_ylabel("mel bin")
    axes[0].set_title("mel spectrogram")

    for fid in feature_ids:
        axes[1].plot(codes[:T, fid], lw=1.0, label=f"f{fid}")
    axes[1].set_xlabel("frame")
    axes[1].set_ylabel("activation")
    axes[1].set_title("top decision features")
    axes[1].legend(ncol=min(len(feature_ids), 5), fontsize=8)

    return _save(fig, out_path)


def plot_boundary_discontinuity(
    codes: np.ndarray,
    window: int,
    out_path,
    correct: Optional[np.ndarray] = None,
) -> str:
    """The boundary-discontinuity dashboard (reference:
    analyze_boundary_semantics.py / analyze_boundary_error_correlation.py
    -> boundary_discontinuity_analysis.png): interior-vs-boundary
    Jaccard, the mean frame-transition trace with boundary markers, and
    (when ``correct`` is given) per-utterance discontinuity split by
    prediction correctness with the Welch t-test annotation."""
    plt = _pyplot()
    from scipy import stats as sstats

    from sls_tpu_torch.analysis.temporal import (
        boundary_discontinuity,
        jaccard_consecutive,
    )

    n_panels = 3 if correct is not None else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4))

    d = boundary_discontinuity(codes, window)
    ax = axes[0]
    ax.bar(["interior", "boundary"],
           [d["interior_jaccard"], d["boundary_jaccard"]],
           color=["tab:blue", "tab:red"])
    ax.set_ylim(0, 1.05)
    ax.set_ylabel("Jaccard")
    ax.set_title(f"discontinuity {100 * d['discontinuity']:.1f}% (w={window})")

    j = jaccard_consecutive(codes)
    trace = j.mean(axis=0)
    ax = axes[1]
    ax.plot(trace, lw=1.0)
    for b in range(window - 1, len(trace), window):
        ax.axvline(b, color="tab:red", alpha=0.3, lw=0.8)
    ax.set_xlabel("frame transition")
    ax.set_ylabel("mean Jaccard")
    ax.set_title("stability trace (boundaries marked)")

    if correct is not None:
        correct = np.asarray(correct, bool)
        disc = np.array([
            boundary_discontinuity(codes[b : b + 1], window)["discontinuity"]
            for b in range(codes.shape[0])
        ])
        ax = axes[2]
        groups = [disc[correct], disc[~correct]]
        ax.boxplot([g if len(g) else [0.0] for g in groups])
        # tick labels set apart: boxplot's own keyword changed name in matplotlib 3.9
        ax.set_xticks([1, 2], [f"correct (n={correct.sum()})",
                               f"error (n={(~correct).sum()})"])
        title = "discontinuity vs prediction"
        if len(groups[0]) >= 2 and len(groups[1]) >= 2:
            t, p = sstats.ttest_ind(groups[1], groups[0], equal_var=False)
            title += f"  (t={t:.2f}, p={p:.3g})"
        ax.set_title(title)
        ax.set_ylabel("per-utt discontinuity")

    return _save(fig, out_path)


def plot_attribution_report(
    scores: np.ndarray,
    out_path,
    top_k: int = 20,
    consistency: Optional[Dict[str, float]] = None,
    ablation: Optional[Dict] = None,
) -> str:
    """Decision-relevance dashboard (reference:
    analyze_decision_relevance.py:886 create_visualizations): global
    attribution ranking, attribution-mass concentration, within-class
    cue consistency, and the ablation validation scatter (gradient
    attribution vs measured probability drop)."""
    plt = _pyplot()
    n_panels = 2 + (consistency is not None) + (ablation is not None)
    fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 4))
    axes = np.atleast_1d(axes)

    g = np.asarray(scores).sum(axis=0)
    order = np.argsort(-g)[:top_k]
    ax = axes[0]
    ax.bar(range(len(order)), g[order], color="tab:purple")
    ax.set_xticks(range(len(order)))
    ax.set_xticklabels([str(i) for i in order], rotation=90, fontsize=6)
    ax.set_title(f"top-{top_k} attribution features")
    ax.set_ylabel("summed |attribution|")

    srt = np.sort(g)[::-1]
    cum = np.cumsum(srt) / max(srt.sum(), 1e-12)
    ax = axes[1]
    ax.plot(cum[: max(200, top_k)])
    ax.set_xlabel("feature rank")
    ax.set_ylabel("cumulative attribution mass")
    ax.set_title("attribution concentration")

    i = 2
    if consistency is not None:
        ax = axes[i]
        keys = list(consistency)
        ax.bar(keys, [consistency[k] for k in keys], color="tab:green")
        ax.set_ylim(0, 1.05)
        ax.set_title("cue-set consistency (Jaccard)")
        ax.tick_params(axis="x", rotation=20)
        i += 1
    if ablation is not None:
        ax = axes[i]
        feats = np.asarray(ablation["features"])
        drops = np.asarray(ablation["mean_prob_drop"])
        ax.scatter(g[feats], drops)
        ax.set_xlabel("gradient attribution")
        ax.set_ylabel("mean P(bonafide) drop on ablation")
        ax.set_title("ablation validation")

    return _save(fig, out_path)


def plot_acoustic_probe(probe_out: Dict[str, Dict], out_path) -> str:
    """Acoustic-correlation dashboard (reference:
    probe_acoustic_asvspoof.py): per-property top |correlation| heatmap
    with feature ids, plus the strongest correlate per property."""
    plt = _pyplot()
    props = sorted(probe_out)
    ranks = max(len(np.asarray(probe_out[p]["top_correlations"]))
                for p in props)
    mat = np.zeros((len(props), ranks))
    for r, p in enumerate(props):
        c = np.abs(np.asarray(probe_out[p]["top_correlations"], float))
        mat[r, : len(c)] = c

    fig, axes = plt.subplots(1, 2, figsize=(12, 0.6 * len(props) + 3))
    ax = axes[0]
    im = ax.imshow(mat, aspect="auto", cmap="viridis", vmin=0, vmax=1)
    ax.set_yticks(range(len(props)))
    ax.set_yticklabels(props, fontsize=8)
    ax.set_xlabel("feature rank")
    ax.set_title("|corr(feature, acoustic property)|")
    fig.colorbar(im, ax=ax, shrink=0.8)

    ax = axes[1]
    best = mat[:, 0] if ranks else np.zeros(len(props))
    ax.barh(range(len(props)), best, color="tab:orange")
    for r, p in enumerate(props):
        feats = np.asarray(probe_out[p]["top_features"])
        if len(feats):
            ax.text(best[r], r, f" f{int(feats[0])}", va="center",
                    fontsize=7)
    ax.set_yticks(range(len(props)))
    ax.set_yticklabels(props, fontsize=8)
    ax.set_xlim(0, 1.05)
    ax.set_title("strongest correlate per property")

    return _save(fig, out_path)


def plot_transient_persistent(
    lifetime: np.ndarray,
    threshold: float,
    out_path,
    probe_acc: Optional[Dict[str, float]] = None,
) -> str:
    """Transient-vs-persistent dashboard (reference:
    visualize_transient_features.py, improved_transient_analysis.py):
    the per-feature lifetime distribution colored by the split, plus the
    logistic-probe accuracy comparison when available (keys
    acc_transient_only / acc_persistent_only / acc_all)."""
    plt = _pyplot()
    lifetime = np.asarray(lifetime, float)
    active = lifetime > 0
    n_panels = 2 if probe_acc else 1
    fig, axes = plt.subplots(1, n_panels, figsize=(6 * n_panels, 4),
                             squeeze=False)

    ax = axes[0, 0]
    lt = lifetime[active]
    if len(lt):
        bins = np.linspace(0, max(lt.max(), threshold) * 1.05, 40)
        ax.hist(lt[lt < threshold], bins=bins, alpha=0.7,
                label=f"transient (n={(lt < threshold).sum()})",
                color="tab:red")
        ax.hist(lt[lt >= threshold], bins=bins, alpha=0.7,
                label=f"persistent (n={(lt >= threshold).sum()})",
                color="tab:blue")
    ax.axvline(threshold, color="k", ls="--", lw=1,
               label=f"threshold {threshold:.1f}")
    ax.set_xlabel("mean lifetime (frames)")
    ax.set_ylabel("features")
    ax.set_title("feature lifetime split")
    ax.legend(fontsize=8)

    if probe_acc:
        ax = axes[0, 1]
        keys = ["acc_transient_only", "acc_persistent_only", "acc_all"]
        vals = [probe_acc.get(k, 0.0) for k in keys]
        ax.bar(["transient", "persistent", "all"], vals,
               color=["tab:red", "tab:blue", "tab:gray"])
        ax.set_ylim(0, 1.05)
        ax.axhline(0.5, color="k", ls=":", lw=0.8)
        ax.set_ylabel("probe accuracy")
        ax.set_title("are discriminative cues transient?")

    return _save(fig, out_path)


def plot_layer_gates(mean: Sequence[float], std: Sequence[float], out_path) -> str:
    """The SLS head's mean sigmoid gate per encoder layer, with its std
    over the utterances as error bars (the analysis CLI's ``gates``)."""
    plt = _pyplot()
    mean, std = np.asarray(mean), np.asarray(std)
    fig, ax = plt.subplots(figsize=(9, 3.5))
    ax.bar(np.arange(len(mean)), mean, yerr=std, color="#4878a8")
    ax.set_xlabel("encoder layer")
    ax.set_ylabel("mean sigmoid gate")
    ax.set_title("SLS sensitive-layer gates")
    return _save(fig, out_path)
