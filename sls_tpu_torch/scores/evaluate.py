"""Official ASVspoof 2021 scoring against the organisers' key files,
counterpart of ``sls_tpu/scores/evaluate.py``:

- 2021 LA: EER and min t-DCF at the fixed ASV operating point, with the
  official scorer's check that negated scores do not do better;
- 2021 DF: EER;
- In-the-Wild: EER, bona fide written ``bona-fide``.

Key-file layout (the organisers' packages):
  <truth_dir>/LA/ASV/trial_metadata.txt        ASV keys (col 5 label, col 7 phase)
  <truth_dir>/LA/ASV/ASVTorch_Kaldi/score.txt  ASV scores (col 2)
  <truth_dir>/LA/CM/trial_metadata.txt         CM keys   (col 1 utt, col 5 label, col 7 phase)
  <truth_dir>/CM/trial_metadata.txt            DF CM keys

The reference reads the key files with pandas (``read_csv(sep=" ",
header=None)``) and joins them to the score file with an inner merge on
column 1.  Here they are read as single-space-separated tables of
strings, which gives the same rows: blank lines skipped, the column
count taken from the first line (a longer line raises, a shorter one
has missing cells), the score file's row count checked against the
whole key file before the phase filter, duplicate key rows kept (a
score joins each), and the ASV scores taken row by row beside their
key file's rows.

    python -m sls_tpu_torch.scores.evaluate {LA,DF,in-the-wild} SCORES TRUTH [PHASE]
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from sls_tpu_torch.metrics.eer import (
    DEFAULT_COST_MODEL,
    asv_error_rates,
    compute_eer,
    compute_tdcf,
)
from sls_tpu_torch.scores.writer import read_score_file

PHASES = ("progress", "eval", "hidden_track")

Table = List[List[Optional[str]]]


@dataclass
class ScoreResult:
    eer: float  # a fraction, not percent
    min_tdcf: Optional[float] = None
    inverted_is_better: bool = False

    def summary(self) -> str:
        out = ""
        if self.min_tdcf is not None:
            out += f"min_tDCF: {self.min_tdcf:.4f}\n"
        out += f"eer: {100 * self.eer:.2f}\n"
        return out


def read_key_table(path: str) -> Table:
    """The rows of a single-space-separated key file as lists of cells,
    padded with None to the first line's width; a wider line raises."""
    rows: Table = []
    width = None
    with open(path, "r") as f:
        for n, raw in enumerate(f, 1):
            line = raw.rstrip("\r\n")
            if not line.strip():
                continue
            cells: List[Optional[str]] = line.split(" ")
            if width is None:
                width = len(cells)
            elif len(cells) > width:
                raise ValueError(f"{path}: expected {width} fields in line {n}, "
                                 f"saw {len(cells)}")
            rows.append(cells + [None] * (width - len(cells)))
    return rows


def _column(rows: Table, col: int, path: str) -> List[Optional[str]]:
    if rows and col >= len(rows[0]):
        raise KeyError(f"{path} has no column {col}")
    return [r[col] for r in rows]


def _load_asv_operating_point(truth_dir: str, phase: str):
    """The ASV error rates at its EER threshold, for the tandem DCF."""
    key_path = os.path.join(truth_dir, "LA/ASV/trial_metadata.txt")
    scr_path = os.path.join(truth_dir, "LA/ASV/ASVTorch_Kaldi/score.txt")
    key, scr = read_key_table(key_path), read_key_table(scr_path)
    if len(scr) > len(key):
        # pandas cannot align a shorter key mask to the longer score table
        raise ValueError(f"{scr_path} has {len(scr)} rows and its key file {len(key)}")
    phases, labels = _column(key, 7, key_path), _column(key, 5, key_path)
    scores = _column(scr, 2, scr_path)
    by_label: Dict[str, List[float]] = {"target": [], "nontarget": [], "spoof": []}
    for i, s in enumerate(scores):
        if phases[i] == phase and labels[i] in by_label:
            by_label[labels[i]].append(float(s))
    tar, non, spoof = (np.asarray(by_label[k], np.float64)
                       for k in ("target", "nontarget", "spoof"))
    _, threshold = compute_eer(tar, non)
    return asv_error_rates(tar, non, spoof, threshold)


def _merge_scores_with_keys(score_file: str, cm_key_file: str, phase: Optional[str]
                            ) -> List[Tuple[float, Optional[str]]]:
    """(score, key label) for each join of a score line with a key row of
    the same utterance (in the phase, when one is given), in score-file
    order."""
    keys = read_key_table(cm_key_file)
    utt_ids, scores = read_score_file(score_file)
    if len(utt_ids) != len(keys):
        raise ValueError(f"submission has {len(utt_ids)} of {len(keys)} expected trials")
    ids = _column(keys, 1, cm_key_file)
    labels = _column(keys, 5, cm_key_file)
    in_phase = [True] * len(keys) if phase is None else [
        p == phase for p in _column(keys, 7, cm_key_file)]
    rows_of: Dict[str, List[int]] = {}
    for i, u in enumerate(ids):
        if in_phase[i]:
            rows_of.setdefault(u, []).append(i)
    return [(float(s), labels[i]) for u, s in zip(utt_ids, scores) for i in rows_of.get(u, ())]


def _split_by_label(merged, bonafide_literal: str) -> Tuple[np.ndarray, np.ndarray]:
    bona = np.asarray([s for s, lab in merged if lab == bonafide_literal], np.float64)
    spoof = np.asarray([s for s, lab in merged if lab == "spoof"], np.float64)
    return bona, spoof


def score_2021_la(score_file: str, truth_dir: str, phase: str = "eval",
                  cost_model: Optional[Dict[str, float]] = None) -> ScoreResult:
    """EER and min t-DCF for ASVspoof 2021 LA, and whether negated scores
    reach a lower min t-DCF (labels swapped in training)."""
    p_fa, p_miss, _, p_fa_spoof = _load_asv_operating_point(truth_dir, phase)
    merged = _merge_scores_with_keys(
        score_file, os.path.join(truth_dir, "LA/CM/trial_metadata.txt"), phase)
    bona, spoof = _split_by_label(merged, "bonafide")

    cm = DEFAULT_COST_MODEL if cost_model is None else cost_model
    eer = compute_eer(bona, spoof)[0]
    tdcf_curve, _ = compute_tdcf(bona, spoof, p_fa, p_miss, p_fa_spoof, cm)
    min_tdcf = float(np.min(tdcf_curve))

    inv_tdcf_curve, _ = compute_tdcf(-bona, -spoof, p_fa, p_miss, p_fa_spoof, cm)
    inverted_better = float(np.min(inv_tdcf_curve)) < min_tdcf
    return ScoreResult(eer=eer, min_tdcf=min_tdcf, inverted_is_better=inverted_better)


def score_2021_df(score_file: str, truth_dir: str, phase: str = "eval") -> ScoreResult:
    """EER for ASVspoof 2021 DF."""
    merged = _merge_scores_with_keys(
        score_file, os.path.join(truth_dir, "CM/trial_metadata.txt"), phase)
    bona, spoof = _split_by_label(merged, "bonafide")
    return ScoreResult(eer=compute_eer(bona, spoof)[0])


def score_in_the_wild(score_file: str, key_file: str) -> ScoreResult:
    """EER for In-the-Wild (no phase filter; bona fide is 'bona-fide')."""
    merged = _merge_scores_with_keys(score_file, key_file, phase=None)
    bona, spoof = _split_by_label(merged, "bona-fide")
    return ScoreResult(eer=compute_eer(bona, spoof)[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Official ASVspoof scoring")
    parser.add_argument("track", choices=["LA", "DF", "in-the-wild"])
    parser.add_argument("score_file")
    parser.add_argument("truth_dir", help="organizer keys dir (or key file for in-the-wild)")
    parser.add_argument("phase", nargs="?", default="eval", choices=PHASES)
    args = parser.parse_args(argv)

    if args.track == "LA":
        result = score_2021_la(args.score_file, args.truth_dir, args.phase)
    elif args.track == "DF":
        result = score_2021_df(args.score_file, args.truth_dir, args.phase)
    else:
        result = score_in_the_wild(args.score_file, args.truth_dir)

    print(result.summary(), end="")
    if result.inverted_is_better:
        print("CHECK: negated scores achieve a lower min t-DCF — "
              "class labels were likely swapped during training")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
