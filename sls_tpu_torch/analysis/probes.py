"""Acoustic and phoneme probes over SAE features, own copy of
``sls_tpu/analysis/probes.py``.

Library equivalents of the reference probe scripts:

- Acoustic probe (reference: probe_acoustic_asvspoof.py:18-390): Pearson
  correlation of every SAE feature's activation trajectory with per-frame
  acoustic descriptors (pitch, RMS, ZCR, spectral centroid/bandwidth/
  rolloff), optionally grouped by attack type.
- Phoneme probe (reference: probe_phonemes.py:16-304): align
  TIMIT-style phoneme segmentations (sample-range .PHN files) to the
  encoder's 50 Hz frame grid, then compute per-phoneme feature activation
  statistics and phoneme selectivity.

Both are pure numpy over precomputed codes — no model in the loop — so
they batch over the whole probe set at once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sls_tpu_torch.analysis.dsp import ENCODER_HOP, acoustic_features


def _pearson_matrix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Columnwise Pearson correlation: x [N, A], y [N, B] -> [A, B]."""
    xc = x - x.mean(0)
    yc = y - y.mean(0)
    xs = xc.std(0) + 1e-10
    ys = yc.std(0) + 1e-10
    return (xc / xs).T @ (yc / ys) / x.shape[0]


def acoustic_probe(
    codes: np.ndarray,
    wavs: np.ndarray,
    sr: int = 16000,
    top_k: int = 10,
) -> Dict[str, Dict]:
    """Correlate SAE features with acoustic properties.

    codes: [B, T, D] sparse activations; wavs: [B, S] waveforms whose
    frame grid matches T (hop 320).  Returns, per acoustic property, the
    top-k most correlated features and the full correlation vector.
    """
    B, T, D = codes.shape
    # Per-utterance property vectors are padded (edge mode) or cropped
    # to EXACTLY T frames: a single short utterance would otherwise
    # shift every later utterance's properties against the flattened
    # [B*T] code rows, silently correlating mismatched pairs.
    prop_frames: Dict[str, List[np.ndarray]] = {}
    for b in range(B):
        feats = acoustic_features(wavs[b], sr=sr)
        for name, v in feats.items():
            if len(v) == 0:
                v = np.zeros(T, np.float32)
            elif len(v) < T:
                v = np.pad(v, (0, T - len(v)), mode="edge")
            prop_frames.setdefault(name, []).append(v[:T])

    flat_codes = codes.reshape(B * T, D)
    out: Dict[str, Dict] = {}
    for name, per_utt in prop_frames.items():
        prop = np.concatenate(per_utt)[:, None]  # [B*T, 1], aligned
        corr = _pearson_matrix(flat_codes, prop)[:, 0]  # [D]
        order = np.argsort(-np.abs(corr))
        out[name] = {
            "correlations": corr,
            "top_features": order[:top_k],
            "top_correlations": corr[order[:top_k]],
        }
    return out


def acoustic_probe_by_group(
    codes: np.ndarray, wavs: np.ndarray, groups: Sequence[str], **kwargs
) -> Dict[str, Dict]:
    """Acoustic probe stratified by group label (e.g. attack type,
    reference: probe_acoustic_asvspoof.py per-attack analysis)."""
    groups = np.asarray(groups)
    out = {}
    for g in np.unique(groups):
        mask = groups == g
        out[str(g)] = acoustic_probe(codes[mask], wavs[mask], **kwargs)
    return out


# ---------------------------------------------------------------------------
# Phoneme probe


def parse_phn_file(path) -> List[Tuple[int, int, str]]:
    """Parse a TIMIT .PHN segmentation: lines of 'start end phoneme'
    in sample units (reference: probe_phonemes.py load_timit_phoneme_data)."""
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3:
                segs.append((int(parts[0]), int(parts[1]), parts[2]))
    return segs


def phoneme_frame_labels(
    segments: Sequence[Tuple[int, int, str]], n_frames: int,
    hop: int = ENCODER_HOP,
) -> List[Optional[str]]:
    """Assign each encoder frame the phoneme covering its center sample."""
    labels: List[Optional[str]] = [None] * n_frames
    for start, end, ph in segments:
        f_lo = max(0, int(np.ceil((start - hop / 2) / hop)))
        f_hi = min(n_frames, int(np.floor((end - hop / 2) / hop)) + 1)
        for f in range(f_lo, f_hi):
            center = f * hop + hop / 2
            if start <= center < end:
                labels[f] = ph
    return labels


def phoneme_probe(
    codes: np.ndarray,
    frame_labels: Sequence[Sequence[Optional[str]]],
    top_k: int = 10,
) -> Dict[str, Dict]:
    """Per-phoneme feature statistics and selectivity.

    codes: [B, T, D]; frame_labels: per-utterance frame phoneme labels.
    Returns {phoneme: {mean_activation [D], top_features, selectivity}}.
    """
    B, T, D = codes.shape
    by_ph: Dict[str, List[np.ndarray]] = {}
    for b in range(B):
        labels = frame_labels[b]
        for t in range(min(T, len(labels))):
            ph = labels[t]
            if ph is not None:
                by_ph.setdefault(ph, []).append(codes[b, t])

    if not by_ph:
        return {}
    global_mean = codes.reshape(-1, D).mean(0)
    out: Dict[str, Dict] = {}
    for ph, rows in by_ph.items():
        mat = np.stack(rows)
        mean = mat.mean(0)
        selectivity = mean - global_mean
        order = np.argsort(-selectivity)
        out[ph] = {
            "n_frames": len(rows),
            "mean_activation": mean,
            "top_features": order[:top_k],
            "selectivity": selectivity[order[:top_k]],
        }
    return out


def handcrafted_stability_comparison(
    codes: np.ndarray, wavs: np.ndarray, sr: int = 16000, top_k: int = 20
) -> Dict[str, Dict[str, float]]:
    """SAE vs MFCC vs mel-spectrogram temporal stability
    (reference: compare_handcrafted_features.py:19-386).

    Handcrafted features are binarized by per-frame top-k magnitude so the
    same Jaccard/lifetime metrics apply to all three representations.
    """
    from sls_tpu_torch.analysis.dsp import mel_spectrogram, mfcc
    from sls_tpu_torch.analysis.temporal import (
        feature_lifetimes,
        mean_temporal_jaccard,
    )

    def binarize_topk(x: np.ndarray, k: int) -> np.ndarray:
        thresh = np.sort(x, axis=-1)[..., -k][..., None]
        return (x >= thresh).astype(np.float32)

    B, T, D = codes.shape
    reps: Dict[str, np.ndarray] = {"sae": (np.asarray(codes) > 0).astype(np.float32)}
    mels, mfccs = [], []
    for b in range(B):
        mels.append(mel_spectrogram(wavs[b], sr=sr)[:T])
        mfccs.append(mfcc(wavs[b], sr=sr, n_mfcc=13)[:T])
    mel_arr = np.stack(mels)
    mfcc_arr = np.stack(mfccs)
    reps["mel"] = binarize_topk(mel_arr, min(top_k, mel_arr.shape[-1] - 1))
    reps["mfcc"] = binarize_topk(np.abs(mfcc_arr), min(5, mfcc_arr.shape[-1] - 1))

    out = {}
    for name, rep in reps.items():
        out[name] = {
            "mean_jaccard": mean_temporal_jaccard(rep),
            "mean_lifetime": feature_lifetimes(rep)["mean_lifetime"],
        }
    return out
