"""DET curve and EER (own copy of ``compute_det_curve``, ``compute_eer``
and ``roc_eer`` from ``sls_tpu/metrics/eer.py``, the official ASVspoof
2021 scoring math).  Pure numpy on the host: score vectors are small."""

from __future__ import annotations

from typing import Tuple

import numpy as np

Array = np.ndarray


def compute_det_curve(target_scores: Array, nontarget_scores: Array
                      ) -> Tuple[Array, Array, Array]:
    """Detection error trade-off curve: (frr, far, thresholds), each of
    length ``len(target_scores) + len(nontarget_scores) + 1`` (a stable
    mergesort over the pooled scores, and a leading operating point below
    the minimum score)."""
    target_scores = np.asarray(target_scores, dtype=np.float64).ravel()
    nontarget_scores = np.asarray(nontarget_scores, dtype=np.float64).ravel()

    n_total = target_scores.size + nontarget_scores.size
    pooled = np.concatenate([target_scores, nontarget_scores])
    is_target = np.concatenate(
        [np.ones(target_scores.size), np.zeros(nontarget_scores.size)])

    order = np.argsort(pooled, kind="mergesort")
    is_target = is_target[order]

    # as the threshold sweeps up through the sorted scores, targets below
    # it are misses and nontargets at or above it false accepts
    n_miss = np.cumsum(is_target)
    n_fa = nontarget_scores.size - (np.arange(1, n_total + 1) - n_miss)

    frr = np.concatenate([[0.0], n_miss / target_scores.size])
    far = np.concatenate([[1.0], n_fa / nontarget_scores.size])
    thresholds = np.concatenate([[pooled[order[0]] - 0.001], pooled[order]])
    return frr, far, thresholds


def compute_eer(target_scores: Array, nontarget_scores: Array) -> Tuple[float, float]:
    """Equal error rate and its threshold: mean(frr, far) at the operating
    point minimising |frr - far|, as the official scorer computes it."""
    frr, far, thresholds = compute_det_curve(target_scores, nontarget_scores)
    idx = int(np.argmin(np.abs(frr - far)))
    return float((frr[idx] + far[idx]) / 2.0), float(thresholds[idx])


def roc_eer(scores: Array, labels: Array) -> float:
    """Training-time EER in percent from pooled scores and binary labels
    (1 = bonafide), the per-epoch train / val telemetry.  Non-finite
    scores are dropped; a degenerate input (empty, a single class, or
    all-equal scores) returns 50 %, chance level."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()

    keep = np.isfinite(scores)
    scores, labels = scores[keep], labels[keep]
    if scores.size == 0:
        return 50.0
    if not np.any(labels == 1) or not np.any(labels == 0):
        return 50.0
    if np.all(scores == scores[0]):
        # the DET sweep would land on frr = far = 1 by the sort order's
        # tie-breaking and report 100 %; the contract is chance level
        return 50.0

    frr, far, _ = compute_det_curve(scores[labels == 1], scores[labels == 0])
    idx = int(np.argmin(np.abs(frr - far)))
    eer = float((frr[idx] + far[idx]) / 2.0) * 100.0
    return eer if np.isfinite(eer) else 50.0
