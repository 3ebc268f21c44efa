"""8-bit mu-law wire codec (own copy of ``sls_tpu/data/mulaw.py``).

LOSSY, opt-in.  Encode (host): y = sign(x) * ln(1 + 255|x|) / ln(256),
u = rint((y + 1) * 127.5).  Decode: x = sign(y) * (256^|y| - 1) / 255,
which ``train/steps.dequantize_wire`` repeats on the device.
"""

from __future__ import annotations

import numpy as np

_MU = 255.0
_LN256 = float(np.log(256.0))


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """float audio in [-1, 1] -> uint8 mu-law codes."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / _LN256
    return np.rint((y + 1.0) * 127.5).astype(np.uint8)


def mulaw_decode(u: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> float32 audio."""
    y = np.asarray(u, np.float32) / 127.5 - 1.0
    return (np.sign(y) * np.expm1(np.abs(y) * _LN256) / _MU).astype(np.float32)
