"""ASVspoof detection metrics (own copy of ``sls_tpu/metrics/eer.py``,
the official ASVspoof 2021 scoring math): the DET curve, EER, the ASV
operating point, the tandem DCF (2021 and legacy 2019) and the
training-time ``roc_eer``.  Pure numpy on the host: score vectors are
small."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def asv_error_rates(tar_asv: Array, non_asv: Array, spoof_asv: Array, asv_threshold: float
                    ) -> Tuple[float, float, Optional[float], Optional[float]]:
    """(Pfa_asv, Pmiss_asv, Pmiss_spoof_asv, Pfa_spoof_asv) at a fixed ASV
    threshold; the spoof rates are None without spoof trials."""
    tar_asv = np.asarray(tar_asv, dtype=np.float64).ravel()
    non_asv = np.asarray(non_asv, dtype=np.float64).ravel()
    spoof_asv = np.asarray(spoof_asv, dtype=np.float64).ravel()

    p_fa = float(np.sum(non_asv >= asv_threshold) / non_asv.size)
    p_miss = float(np.sum(tar_asv < asv_threshold) / tar_asv.size)
    if spoof_asv.size == 0:
        return p_fa, p_miss, None, None
    p_miss_spoof = float(np.sum(spoof_asv < asv_threshold) / spoof_asv.size)
    p_fa_spoof = float(np.sum(spoof_asv >= asv_threshold) / spoof_asv.size)
    return p_fa, p_miss, p_miss_spoof, p_fa_spoof


# the ASVspoof 2021 LA cost model
DEFAULT_COST_MODEL: Dict[str, float] = {
    "Pspoof": 0.05,
    "Ptar": 0.95 * 0.99,
    "Pnon": 0.95 * 0.01,
    "Cmiss": 1.0,
    "Cfa": 10.0,
    "Cfa_spoof": 10.0,
}


def _check_soft_scores(bonafide_score_cm: Array, spoof_score_cm: Array) -> None:
    pooled = np.concatenate([bonafide_score_cm, spoof_score_cm])
    if np.isnan(pooled).any() or np.isinf(pooled).any():
        raise ValueError("scores contain nan or inf")
    if np.unique(pooled).size < 3:
        raise ValueError("soft scores required, not binary decisions")


def compute_tdcf(bonafide_score_cm: Array, spoof_score_cm: Array, p_fa_asv: float,
                 p_miss_asv: float, p_fa_spoof_asv: Optional[float],
                 cost_model: Optional[Dict[str, float]] = None) -> Tuple[Array, Array]:
    """(normalised t-DCF curve, CM thresholds), ASVspoof 2021 revision;
    its minimum is the "min t-DCF"."""
    cm = dict(DEFAULT_COST_MODEL if cost_model is None else cost_model)

    prior_sum = cm["Ptar"] + cm["Pnon"] + cm["Pspoof"]
    if min(cm["Ptar"], cm["Pnon"], cm["Pspoof"]) < 0 or abs(prior_sum - 1) > 1e-10:
        raise ValueError("priors must be positive and sum to one")
    if p_fa_spoof_asv is None:
        raise ValueError("Pfa_spoof_asv is required for the 2021 t-DCF")
    _check_soft_scores(bonafide_score_cm, spoof_score_cm)

    p_miss_cm, p_fa_cm, cm_thresholds = compute_det_curve(bonafide_score_cm, spoof_score_cm)

    # the constants of the 2021 cost decomposition (evaluation plan, eq. 10)
    c0 = cm["Ptar"] * cm["Cmiss"] * p_miss_asv + cm["Pnon"] * cm["Cfa"] * p_fa_asv
    c1 = cm["Ptar"] * cm["Cmiss"] - c0
    c2 = cm["Pspoof"] * cm["Cfa_spoof"] * p_fa_spoof_asv
    if c0 < 0 or c1 < 0 or c2 < 0:
        raise ValueError("negative t-DCF weights; check ASV error rates")

    tdcf = c0 + c1 * p_miss_cm + c2 * p_fa_cm
    tdcf_default = c0 + min(c1, c2)
    return tdcf / tdcf_default, cm_thresholds


def compute_tdcf_legacy(bonafide_score_cm: Array, spoof_score_cm: Array, p_fa_asv: float,
                        p_miss_asv: float, p_miss_spoof_asv: Optional[float],
                        cost_model: Dict[str, float]) -> Tuple[Array, Array]:
    """(normalised t-DCF curve, CM thresholds), ASVspoof 2019 form."""
    prior_sum = cost_model["Ptar"] + cost_model["Pnon"] + cost_model["Pspoof"]
    if abs(prior_sum - 1) > 1e-10:
        raise ValueError("priors must sum to one")
    if p_miss_spoof_asv is None:
        raise ValueError("Pmiss_spoof_asv is required for the legacy t-DCF")
    _check_soft_scores(bonafide_score_cm, spoof_score_cm)

    p_miss_cm, p_fa_cm, cm_thresholds = compute_det_curve(bonafide_score_cm, spoof_score_cm)
    c1 = (cost_model["Ptar"] * (cost_model["Cmiss_cm"] - cost_model["Cmiss_asv"] * p_miss_asv)
          - cost_model["Pnon"] * cost_model["Cfa_asv"] * p_fa_asv)
    c2 = cost_model["Cfa_cm"] * cost_model["Pspoof"] * (1 - p_miss_spoof_asv)
    if c1 < 0 or c2 < 0:
        raise ValueError("negative t-DCF weights; check ASV error rates")

    tdcf = c1 * p_miss_cm + c2 * p_fa_cm
    return tdcf / min(c1, c2), cm_thresholds


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
