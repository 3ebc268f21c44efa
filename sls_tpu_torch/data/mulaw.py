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


_LUT_FROM_INT16: np.ndarray | None = None


def lut_from_int16() -> np.ndarray:
    """[65536] uint8 table from int16 PCM (offset by +32768) to mu-law
    codes: one table take companders the native decoder's int16 rows, in
    place of a log over every sample."""
    global _LUT_FROM_INT16
    if _LUT_FROM_INT16 is None:
        grid = np.arange(-32768, 32768, dtype=np.float32) / 32768.0
        _LUT_FROM_INT16 = mulaw_encode(grid)
    return _LUT_FROM_INT16


def mulaw_from_int16(wav_i16: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law codes through the table (exact on the
    int16 grid)."""
    return lut_from_int16()[wav_i16.astype(np.int32) + 32768]
