"""Host-side waveform utilities (own copy of ``sls_tpu/data/audio.py``):
the fixed-length crop / repeat-tile, WAV reading, polyphase resampling
and ``load_audio``, which dispatches FLAC to the native decoder
(``data/flac.py``) and WAV to the stdlib ``wave`` module.

A file that exists but does not decode (truncated, corrupt, not really
audio) loads as an empty array, which the loaders turn into a zero row so
that score files stay complete.  A missing file, an unsupported suffix or
a failing build of the decoder raises."""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path
from typing import Tuple, Union

import numpy as np

PathLike = Union[str, Path]

# ~4 seconds at 16 kHz; yields exactly 201 encoder frames (stride 320).
DEFAULT_CUT = 64600
SAMPLE_RATE = 16000


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


def read_wav(path: PathLike) -> np.ndarray:
    """A PCM WAV file as float32 in [-1, 1], channels averaged; no
    resampling (``resample`` does that)."""
    return read_wav_rate(path)[0]


def read_wav_rate(path: PathLike) -> Tuple[np.ndarray, int]:
    """(samples, sample_rate) of a PCM WAV file: 8-bit unsigned, 16-,
    24- or 32-bit signed, channels averaged."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample from ``sr`` to ``target_sr`` (scipy
    ``resample_poly``), float32; the input as is when the rates agree."""
    if sr == target_sr or x.size == 0:
        return x
    from scipy.signal import resample_poly

    g = gcd(target_sr, sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def resample_to_16k(x: np.ndarray, sr: int) -> np.ndarray:
    """``resample`` to the pipeline's 16 kHz."""
    return resample(x, sr, SAMPLE_RATE)


# the exceptions that mean the file itself is bad (truncated, corrupt, not
# audio); anything else (no scipy, a failed decoder build, permissions)
# is a fault of the setup and propagates instead of zero-filling the set
_CORRUPT_FILE_ERRORS = (wave.Error, ValueError, EOFError)


def load_audio(path: PathLike, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """A FLAC or WAV file as float32 mono at ``target_sr``; an empty array
    for a corrupt file.  A missing file raises ``FileNotFoundError``, an
    unsupported suffix ``ValueError``."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix not in (".wav", ".flac"):
        raise ValueError(f"unsupported audio format: {p.suffix}")
    try:
        if suffix == ".wav":
            data, sr = read_wav_rate(p)
        else:
            from sls_tpu_torch.data.flac import read_flac_rate

            data, sr = read_flac_rate(p)
    except FileNotFoundError:
        raise
    except _CORRUPT_FILE_ERRORS:
        return np.zeros(0, dtype=np.float32)
    return resample(data, sr, target_sr)
