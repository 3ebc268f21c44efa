"""SAE sparsity evaluation, own copy of ``sls_tpu/analysis/sparsity.py``:
active-fraction statistics, dead features, per-feature activation
frequencies and weight-only diagnostics.

Each function takes codes or weights as a tensor (on any device) or
anything ``np.asarray`` takes, and returns plain floats or numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def sparsity_stats(codes) -> Dict[str, float]:
    """Activation sparsity over [B, T, D] sparse codes."""
    a = _numpy(codes) > 0
    B, T, D = a.shape
    active_per_frame = a.sum(-1)  # [B, T]
    feature_freq = a.reshape(-1, D).mean(0)  # [D]
    return {
        "mean_active_per_frame": float(active_per_frame.mean()),
        "sparsity_fraction": float(a.mean()),
        "dead_feature_count": int((feature_freq == 0).sum()),
        "dead_feature_fraction": float((feature_freq == 0).mean()),
        "max_feature_freq": float(feature_freq.max()),
        "active_frame_fraction": float((active_per_frame > 0).mean()),
    }


def feature_activation_freq(codes) -> np.ndarray:
    """Per-feature activation frequency over all frames: [D]."""
    a = _numpy(codes) > 0
    return a.reshape(-1, a.shape[-1]).mean(0)


def weight_diagnostics(w_dec) -> Dict[str, float]:
    """Weight-only SAE health check: decoder atom norms and the pairwise
    coherence of the first 1024 atoms (w_dec [dict_size, activation_dim])."""
    w = _numpy(w_dec)
    norms = np.linalg.norm(w, axis=1)
    unit = w / np.maximum(norms[:, None], 1e-12)
    sub = unit[:min(len(w), 1024)]
    gram = np.abs(sub @ sub.T)
    np.fill_diagonal(gram, 0.0)
    return {
        "mean_atom_norm": float(norms.mean()),
        "min_atom_norm": float(norms.min()),
        "max_atom_norm": float(norms.max()),
        "max_coherence": float(gram.max()),
        "mean_coherence": float(gram.mean()),
    }


def dead_neuron_ratio(codes) -> float:
    """Fraction of dictionary atoms never active in the given codes."""
    return float((feature_activation_freq(codes) == 0).mean())
