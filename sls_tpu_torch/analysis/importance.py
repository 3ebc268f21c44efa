"""Class-conditional feature importance, own copy of
``sls_tpu/analysis/importance.py``.

Library form of the reference's per-model ``analyze_feature_importance``
(reference: model.py:301-356) and the neuron-statistics script
(analyze_sae_neurons.py:83): bonafide-vs-spoof mean activation contrast
and discriminative-feature rankings, plus interpretability summaries
(reference: model.py:262-293 get_interpretability_info).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def interpretability_info(codes) -> Dict[str, np.ndarray]:
    """Per-sample interpretability dict (reference: model.py:262-293)."""
    codes = np.asarray(codes)  # [B, T, D]
    avg_activation = codes.mean(axis=1)  # [B, D]
    k = min(20, codes.shape[-1])
    top20 = np.argsort(-avg_activation, axis=-1)[:, :k]
    top20_values = np.take_along_axis(avg_activation, top20, axis=-1)
    active = codes > 0
    return {
        "avg_activation": avg_activation,
        "top20_features": top20,
        "top20_values": top20_values,
        "sparsity": active.mean(axis=(1, 2)),
        "activation_freq": active.mean(axis=1),
    }


def class_feature_importance(
    avg_activation: np.ndarray, labels: np.ndarray, top_k: int = 50
) -> Dict[str, np.ndarray]:
    """Bonafide/spoof activation contrast (reference: model.py:301-356).

    avg_activation: [N, D] per-sample time-averaged activations;
    labels: [N] with 1 = bonafide.
    """
    avg_activation = np.asarray(avg_activation)
    labels = np.asarray(labels)
    bona = avg_activation[labels == 1]
    spoof = avg_activation[labels == 0]
    bona_mean = bona.mean(axis=0) if len(bona) else np.zeros(avg_activation.shape[1])
    spoof_mean = (
        spoof.mean(axis=0) if len(spoof) else np.zeros(avg_activation.shape[1])
    )
    diff = np.abs(bona_mean - spoof_mean)
    order = np.argsort(-diff)
    return {
        "bonafide_mean_activation": bona_mean,
        "spoof_mean_activation": spoof_mean,
        "most_discriminative_features": order[:top_k],
        "discriminative_scores": diff[order[:top_k]],
        "bonafide_only_features": np.flatnonzero(bona_mean > spoof_mean * 2),
        "spoof_only_features": np.flatnonzero(spoof_mean > bona_mean * 2),
    }


def per_feature_class_stats(codes, labels) -> Dict[str, np.ndarray]:
    """Per-feature activation statistics split by class
    (reference: analyze_sae_neurons.py:83 analyze_feature_statistics)."""
    codes = np.asarray(codes)
    labels = np.asarray(labels)
    out = {}
    for name, mask in [("bonafide", labels == 1), ("spoof", labels == 0)]:
        cls = codes[mask]
        if len(cls) == 0:
            d = codes.shape[-1]
            out[f"{name}_mean"] = np.zeros(d)
            out[f"{name}_freq"] = np.zeros(d)
            continue
        out[f"{name}_mean"] = cls.mean(axis=(0, 1))
        out[f"{name}_freq"] = (cls > 0).mean(axis=(0, 1))
    out["selectivity"] = np.abs(out["bonafide_freq"] - out["spoof_freq"])
    return out
