"""Host-side waveform utilities (own copy of the parts of
``sls_tpu/data/audio.py`` the scoring path needs)."""

from __future__ import annotations

import numpy as np

# ~4 seconds at 16 kHz; yields exactly 201 encoder frames (stride 320).
DEFAULT_CUT = 64600


def pad_or_tile(x: np.ndarray, max_len: int = DEFAULT_CUT) -> np.ndarray:
    """Crop to ``max_len`` samples, or repeat-tile short audio up to it
    (long clips are head-cropped, short clips tiled whole and cut)."""
    x = np.asarray(x)
    n = x.shape[0]
    if n == 0:
        return np.zeros(max_len, dtype=x.dtype if x.dtype.kind == "f" else np.float32)
    if n >= max_len:
        return x[:max_len]
    reps = max_len // n + 1
    return np.tile(x, reps)[:max_len]

