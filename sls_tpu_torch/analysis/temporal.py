"""Temporal stability of sparse SAE codes (own copy of the parts of
``sls_tpu/analysis/temporal.py`` that overlap evaluation needs).

Each function takes ``codes``, sparse activations or an active mask
[B, T, D] (numpy, or anything ``np.asarray`` takes), and returns plain
floats or numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _active(codes) -> np.ndarray:
    return np.asarray(codes) > 0


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
