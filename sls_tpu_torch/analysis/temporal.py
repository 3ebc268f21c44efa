"""Temporal stability of sparse SAE codes, own copy of
``sls_tpu/analysis/temporal.py``: consecutive-frame Jaccard, feature
lifetimes and flips, window-boundary discontinuity at one or several
scales, the transient / persistent split, window-to-window identity
carry-over and semantic drift, and the one-call summary the analysis
CLI and the report print.

Each function takes ``codes``, sparse activations or an active mask
[B, T, D] (numpy, or anything ``np.asarray`` takes), and returns plain
floats or numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _active(codes) -> np.ndarray:
    return np.asarray(codes) > 0


def _run_starts(a: np.ndarray) -> np.ndarray:
    """Where a run of active frames begins (a 0 -> 1 transition): [B, T, D]."""
    prev = np.concatenate([np.zeros_like(a[:, :1]), a[:, :-1]], axis=1)
    return a & ~prev


def jaccard_consecutive(codes) -> np.ndarray:
    """Jaccard similarity of the active-feature sets of consecutive
    frames: [B, T-1] (1 where both sets are empty)."""
    a = _active(codes)
    inter = (a[:, :-1] & a[:, 1:]).sum(-1)
    union = (a[:, :-1] | a[:, 1:]).sum(-1)
    return np.where(union > 0, inter / np.maximum(union, 1), 1.0)


def mean_temporal_jaccard(codes) -> float:
    """The headline stability number: the mean consecutive-frame Jaccard."""
    return float(jaccard_consecutive(codes).mean())


def feature_lifetimes(codes) -> Dict[str, float]:
    """Mean run length of consecutive active frames ("lifetime"), as total
    active frames over the number of runs, per (utterance, feature); its
    mean over the pairs with a run, the mean runs a pair, the longest."""
    a = _active(codes)
    total_active = a.sum(axis=1).astype(np.float64)  # [B, D]
    n_runs = _run_starts(a).sum(axis=1).astype(np.float64)  # [B, D]
    per_feature = np.where(n_runs > 0, total_active / np.maximum(n_runs, 1), 0.0)
    active_features = n_runs > 0
    return {
        "mean_lifetime": float(per_feature[active_features].mean())
        if active_features.any() else 0.0,
        "mean_runs_per_feature": float(n_runs.mean()),
        "max_lifetime": float(per_feature.max()) if per_feature.size else 0.0,
    }


def flip_counts(codes) -> np.ndarray:
    """Activation state changes per (utterance, feature): [B, D]."""
    a = _active(codes)
    return (a[:, 1:] != a[:, :-1]).sum(axis=1)


def boundary_discontinuity(codes, window: int, overlap: bool = False) -> Dict[str, float]:
    """Interior against window-boundary Jaccard, and the discontinuity
    ratio.  ``overlap=True`` puts the boundaries at the 50 %-overlap
    stride (window // 2) instead of every ``window`` frames."""
    j = jaccard_consecutive(codes)  # j[:, t] spans frames t -> t+1
    t = np.arange(j.shape[1])
    step = max(1, window // 2) if overlap else window
    is_boundary = (t + 1) % step == 0
    interior = float(j[:, ~is_boundary].mean()) if (~is_boundary).any() else 1.0
    boundary = float(j[:, is_boundary].mean()) if is_boundary.any() else 1.0
    disc = (interior - boundary) / interior if interior > 0 else 0.0
    return {
        "interior_jaccard": interior,
        "boundary_jaccard": boundary,
        "discontinuity": float(disc),
    }


def multi_scale_structure(codes, windows: Sequence[int] = (2, 4, 8, 16, 32)
                          ) -> Dict[str, Dict[str, float]]:
    """``boundary_discontinuity`` at each window size (``per_window``,
    keyed by the size as a string) and the size of least discontinuity
    (``optimal_window``, a float; the first of equals)."""
    per_window = {str(w): boundary_discontinuity(codes, w) for w in windows}
    best = min(per_window, key=lambda w: per_window[w]["discontinuity"])
    return {"per_window": per_window, "optimal_window": float(best)}


def transient_persistent_split(codes, lifetime_threshold: float) -> Dict[str, np.ndarray]:
    """Each feature's mean lifetime over the batch ([D]: its active frames
    over its runs), whether it was ever active, and the features ever
    active with a lifetime below (transient) or at least (persistent)
    ``lifetime_threshold``."""
    a = _active(codes)
    feat_total = a.sum(axis=1).astype(np.float64).sum(axis=0)
    feat_runs = _run_starts(a).sum(axis=1).astype(np.float64).sum(axis=0)
    lifetime = np.where(feat_runs > 0, feat_total / np.maximum(feat_runs, 1), 0.0)
    ever_active = feat_runs > 0
    return {
        "lifetime": lifetime,
        "ever_active": ever_active,
        "transient": ever_active & (lifetime < lifetime_threshold),
        "persistent": ever_active & (lifetime >= lifetime_threshold),
    }


def _window_sets(a: np.ndarray, window: int, n_win: int) -> np.ndarray:
    """The active set of each whole non-overlapping window: [B, n_win, D]."""
    B, _, D = a.shape
    return a[:, :n_win * window].reshape(B, n_win, window, D).any(axis=2)


def feature_identity_stability(codes, window: int) -> Dict[str, float]:
    """How much of each non-overlapping window's active set carries into
    the next window (the mean share of the earlier set), and each
    feature's P(active in w+1 | active in w) averaged over the features
    active in some w; 1.0 carry-over with fewer than two windows."""
    a = _active(codes)
    n_win = a.shape[1] // window
    if n_win < 2:
        return {"identity_carryover": 1.0, "n_windows": float(n_win)}
    aw = _window_sets(a, window, n_win)
    prev, nxt = aw[:, :-1], aw[:, 1:]
    inter = (prev & nxt).sum(-1)
    size_prev = prev.sum(-1)
    carry = np.where(size_prev > 0, inter / np.maximum(size_prev, 1), 1.0)
    feat_prev = prev.sum(axis=(0, 1))
    feat_both = (prev & nxt).sum(axis=(0, 1))
    persistence = np.where(feat_prev > 0, feat_both / np.maximum(feat_prev, 1), 0.0)
    active_feats = feat_prev > 0
    return {
        "identity_carryover": float(carry.mean()),
        "mean_feature_persistence": float(persistence[active_feats].mean())
        if active_feats.any() else 0.0,
        "n_windows": float(n_win),
    }


def semantic_drift(codes, window: int, top_k_features: int = 100) -> Dict[str, float]:
    """Context consistency of feature identities across windows.

    Every whole window gives a binary active set; each occurrence of a
    feature records its context (that set without the feature).  A
    feature's consistency is the mean pairwise cosine of its contexts
    over distinct occurrences, computed in O(n D) as (||sum u||^2 -
    sum ||u||^2) / (n (n - 1)) over the unit rows u (an empty context
    stays zero); the score averages the ``top_k_features`` most frequent
    features that occur at least twice.  1.0 when there is no such
    feature or no whole window."""
    a = _active(codes)
    B, T, D = a.shape
    n_win = T // window
    if n_win < 1:
        return {"semantic_consistency": 1.0, "n_windows": 0.0, "num_features_analyzed": 0.0}
    win_active = _window_sets(a, window, n_win).reshape(B * n_win, D).astype(np.float32)
    freq = win_active.sum(axis=0)
    top = np.argsort(-freq)[:top_k_features]
    scores = []
    for d in top:
        rows = win_active[win_active[:, d] > 0]
        n = rows.shape[0]
        if n < 2:
            continue
        ctx = rows.copy()
        ctx[:, d] = 0.0
        norms = np.linalg.norm(ctx, axis=1, keepdims=True)
        unit = np.divide(ctx, norms, out=np.zeros_like(ctx), where=norms > 0)
        s = unit.sum(axis=0)
        n_unit = float((norms[:, 0] > 0).sum())
        scores.append(float((s @ s - n_unit) / (n * (n - 1))))
    if not scores:
        return {"semantic_consistency": 1.0, "n_windows": float(n_win),
                "num_features_analyzed": 0.0}
    return {
        "semantic_consistency": float(sum(scores) / len(scores)),
        "n_windows": float(n_win),
        "num_features_analyzed": float(len(scores)),
    }


def temporal_summary(codes, window: int = 8) -> Dict[str, float]:
    """Jaccard, lifetime, flips, boundary discontinuity at ``window`` and
    semantic drift in one flat dict, as the analysis CLI reports them."""
    return {
        "mean_jaccard": mean_temporal_jaccard(codes),
        "mean_lifetime": feature_lifetimes(codes)["mean_lifetime"],
        "mean_flips": float(flip_counts(codes).mean()),
        **boundary_discontinuity(codes, window),
        **semantic_drift(codes, window),
    }
