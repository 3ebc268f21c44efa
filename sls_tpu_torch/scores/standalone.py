"""Standalone scorers (counterpart of ``sls_tpu/scores/standalone.py``):

- ``roc_interp_eer``: the EER where the interpolated ROC curve crosses
  1 - tpr = fpr (``brentq``), and its threshold;
- ``simplified_min_dcf``: a single system's detection cost, minimised
  over the DET curve;
- ``score_2019_protocol``: EER against a 5-column 2019 protocol, scores
  matched by utterance id;
- ``score_2021_metadata``: EER against a 2021 ``trial_metadata.txt``.

The reference takes its ROC curve from scikit-learn, which the port does
not use: ``roc_curve`` below follows scikit-learn 1.9.0's
``roc_curve(drop_intermediate=True)``, point for point, since which
points survive decides the interpolated EER.

    python -m sls_tpu_torch.scores.standalone SCORES [PROTOCOL | --metadata KEYS]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Tuple

import numpy as np

from sls_tpu_torch.data.protocols import parse_train_protocol
from sls_tpu_torch.metrics.eer import compute_det_curve, compute_eer
from sls_tpu_torch.scores.writer import read_score_file


def roc_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                                np.ndarray]:
    """(fpr, tpr, thresholds) of binary ``labels`` (1 positive) against
    ``scores``, as scikit-learn 1.9.0's ``roc_curve(labels, scores,
    pos_label=1)`` gives them: scores sorted descending (stable), tied
    scores one point, collinear intermediate points dropped, and a first
    point (0, 0) at threshold +inf."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    if labels.shape != scores.shape:
        raise ValueError(f"{labels.size} labels for {scores.size} scores")
    if not np.all(np.isfinite(scores)):
        raise ValueError("scores contain nan or inf")
    order = np.argsort(-scores, kind="stable")
    scores, positive = scores[order], (labels[order] == 1).astype(np.float64)
    idx = np.concatenate([np.nonzero(np.diff(scores))[0], [positive.size - 1]])
    tps = np.cumsum(positive, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = scores[idx]
    if fps.shape[0] > 2:
        keep = np.nonzero(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def roc_interp_eer(bonafide_scores: np.ndarray, spoof_scores: np.ndarray
                   ) -> Tuple[float, float]:
    """EER (a fraction) and its threshold by ROC interpolation and a
    ``brentq`` root."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    scores = np.concatenate([bonafide_scores, spoof_scores])
    labels = np.concatenate([np.ones(len(bonafide_scores)), np.zeros(len(spoof_scores))])
    fpr, tpr, thresholds = roc_curve(labels, scores)
    eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
    threshold = float(interp1d(fpr, thresholds)(eer))
    return float(eer), threshold


def simplified_min_dcf(bonafide_scores: np.ndarray, spoof_scores: np.ndarray,
                       p_target: float = 0.05, c_miss: float = 1.0, c_fa: float = 1.0
                       ) -> float:
    """min over thresholds of c_miss * P_miss * p_target + c_fa * P_fa *
    (1 - p_target)."""
    frr, far, _ = compute_det_curve(np.asarray(bonafide_scores), np.asarray(spoof_scores))
    dcf = c_miss * frr * p_target + c_fa * far * (1.0 - p_target)
    return float(np.min(dcf))


def _warn_partial(n_matched: int, n_keys: int, what: str) -> None:
    # a truncated score file (a killed job leaves a prefix) must not give
    # a quietly wrong headline EER
    print(f"WARNING: only {n_matched}/{n_keys} {what} have scores — EER below is computed "
          f"on a PARTIAL trial set", file=sys.stderr)


def _metrics(bona: np.ndarray, spoof: np.ndarray) -> Dict[str, float]:
    eer, threshold = compute_eer(bona, spoof)
    return {"eer": eer, "eer_interp": roc_interp_eer(bona, spoof)[0], "threshold": threshold,
            "min_dcf": simplified_min_dcf(bona, spoof)}


def score_2019_protocol(score_file: str, protocol_file: str) -> Dict[str, float]:
    """EER of a score file against a 2019 5-column protocol, scores
    matched to protocol rows by utterance id."""
    utt_ids, scores = read_score_file(score_file)
    labels_map, _ = parse_train_protocol(protocol_file)

    matched = [(s, labels_map[u]) for u, s in zip(utt_ids, scores) if u in labels_map]
    if len(matched) != len(utt_ids):
        raise ValueError(f"{len(utt_ids) - len(matched)} scored utterances missing from "
                         "protocol")
    if len(matched) < len(labels_map):
        _warn_partial(len(matched), len(labels_map), "protocol trials")
    arr = np.asarray([s for s, _ in matched])
    lab = np.asarray([lb for _, lb in matched])
    bona, spoof = arr[lab == 1], arr[lab == 0]
    res = {"n_trials": len(arr), "n_bonafide": int((lab == 1).sum()),
           "n_spoof": int((lab == 0).sum())}
    res.update(_metrics(bona, spoof))
    return res


def score_2021_metadata(score_file: str, metadata_file: str, phase: str = "eval"
                        ) -> Dict[str, float]:
    """EER of a score file against a 2021 ``trial_metadata.txt``: column 2
    the utterance, column 6 the label, column 8 the phase; only the rows
    of ``phase`` count."""
    utt_ids, scores = read_score_file(score_file)
    score_map = dict(zip(utt_ids, scores))
    bona, spoof = [], []
    n_keys = 0
    with open(metadata_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 8 and parts[7] == phase:
                n_keys += 1
                s = score_map.get(parts[1])
                if s is None:
                    continue
                (bona if parts[5] == "bonafide" else spoof).append(s)
    if not bona or not spoof:
        raise ValueError(f"no {'bonafide' if not bona else 'spoof'} trials matched "
                         f"phase={phase!r} in {metadata_file}")
    if len(bona) + len(spoof) < n_keys:
        _warn_partial(len(bona) + len(spoof), n_keys, f"phase={phase!r} trials")
    res = {"n_trials": len(bona) + len(spoof), "n_keys_in_phase": n_keys,
           "n_bonafide": len(bona), "n_spoof": len(spoof)}
    res.update(_metrics(np.asarray(bona), np.asarray(spoof)))
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="standalone EER scorer: 2019 protocol or 2021 trial-metadata key file")
    parser.add_argument("score_file")
    parser.add_argument("protocol_file", nargs="?", help="2019-style 5-column protocol")
    parser.add_argument("--metadata", help="2021 trial_metadata.txt key file")
    parser.add_argument("--phase", default="eval", choices=["progress", "eval", "hidden_track"])
    args = parser.parse_args(argv)
    if bool(args.protocol_file) == bool(args.metadata):
        parser.error("give exactly one of: protocol_file, --metadata")
    if args.metadata:
        res = score_2021_metadata(args.score_file, args.metadata, args.phase)
    else:
        res = score_2019_protocol(args.score_file, args.protocol_file)
    print(f"Total trials: {res['n_trials']}")
    print(f"Bonafide trials: {res['n_bonafide']}")
    print(f"Spoof trials: {res['n_spoof']}")
    print(f"EER: {100 * res['eer']:.4f}%")
    print(f"Threshold: {res['threshold']:.6f}")
    print(f"min DCF (simplified): {res['min_dcf']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
