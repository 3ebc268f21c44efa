"""Host-side DSP for the probes, own copy of ``sls_tpu/analysis/dsp.py``.

The reference probes use librosa (pitch, RMS, spectral centroid/bandwidth/
rolloff, ZCR, MFCC — reference: probe_acoustic_asvspoof.py:18-390,
compare_handcrafted_features.py:19).  The port does not depend on
librosa: the primitives are numpy here, with librosa's conventions
(hann window, center-padded STFT, Slaney mel filterbank, ortho DCT-II
MFCC).

Default hop is 320 samples = the XLS-R encoder frame stride, so acoustic
features align 1:1 with encoder/SAE frames without interpolation.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

ENCODER_HOP = 320  # XLS-R conv stack stride @ 16 kHz


def frame_signal(x: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    """Center-padded overlapping frames: [n_frames, frame_length]."""
    pad = frame_length // 2
    xp = np.pad(x, (pad, pad), mode="reflect" if len(x) > pad else "constant")
    n_frames = 1 + (len(xp) - frame_length) // hop
    idx = np.arange(frame_length)[None, :] + hop * np.arange(n_frames)[:, None]
    return xp[idx]


def stft_mag(x: np.ndarray, n_fft: int = 512, hop: int = ENCODER_HOP) -> np.ndarray:
    """Magnitude spectrogram [n_frames, n_fft//2 + 1] (hann window)."""
    frames = frame_signal(x, n_fft, hop)
    window = np.hanning(n_fft)
    return np.abs(np.fft.rfft(frames * window, axis=-1))


def hz_to_mel(f):
    """Slaney mel scale (librosa default)."""
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )
    return mel


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filterbank(
    sr: int = 16000, n_fft: int = 512, n_mels: int = 80,
    fmin: float = 0.0, fmax: float = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft//2+1]."""
    fmax = fmax or sr / 2
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, mid, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (freqs - lo) / max(mid - lo, 1e-10)
        down = (hi - freqs) / max(hi - mid, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization
        fb[i] *= 2.0 / max(hi - lo, 1e-10)
    return fb


def mel_spectrogram(
    x: np.ndarray, sr: int = 16000, n_fft: int = 512, hop: int = ENCODER_HOP,
    n_mels: int = 80,
) -> np.ndarray:
    """Log-mel spectrogram [n_frames, n_mels]."""
    power = stft_mag(x, n_fft, hop) ** 2
    mel = power @ mel_filterbank(sr, n_fft, n_mels).T
    return np.log(np.maximum(mel, 1e-10))


def mfcc(
    x: np.ndarray, sr: int = 16000, n_mfcc: int = 13, n_fft: int = 512,
    hop: int = ENCODER_HOP, n_mels: int = 80,
) -> np.ndarray:
    """MFCCs via ortho DCT-II of the log-mel spectrogram: [n_frames, n_mfcc]."""
    logmel = mel_spectrogram(x, sr, n_fft, hop, n_mels)  # [T, M]
    M = logmel.shape[1]
    n = np.arange(M)
    basis = np.cos(np.pi * (n[None, :] + 0.5) * np.arange(n_mfcc)[:, None] / M)
    scale = np.full(n_mfcc, np.sqrt(2.0 / M))
    scale[0] = np.sqrt(1.0 / M)
    return logmel @ (basis * scale[:, None]).T


def acoustic_features(
    x: np.ndarray, sr: int = 16000, n_fft: int = 512, hop: int = ENCODER_HOP,
    rolloff_pct: float = 0.85,
) -> Dict[str, np.ndarray]:
    """Per-frame acoustic descriptors aligned to encoder frames.

    Returns dict of [n_frames] arrays: rms, zcr, spectral_centroid,
    spectral_bandwidth, spectral_rolloff, pitch (autocorrelation f0,
    0 for unvoiced)."""
    frames = frame_signal(x, n_fft, hop)
    window = np.hanning(n_fft)
    spec = np.abs(np.fft.rfft(frames * window, axis=-1))  # [T, F]
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)

    rms = np.sqrt(np.mean(frames ** 2, axis=-1))
    zcr = np.mean(np.abs(np.diff(np.signbit(frames), axis=-1)), axis=-1)

    mag_sum = spec.sum(-1) + 1e-10
    centroid = (spec * freqs).sum(-1) / mag_sum
    bandwidth = np.sqrt(
        ((freqs[None, :] - centroid[:, None]) ** 2 * spec).sum(-1) / mag_sum
    )
    cum = np.cumsum(spec, axis=-1)
    thresh = rolloff_pct * cum[:, -1:]
    rolloff_idx = np.argmax(cum >= thresh, axis=-1)
    rolloff = freqs[rolloff_idx]

    # autocorrelation pitch: peak lag in the 60-400 Hz band
    lag_min, lag_max = sr // 400, sr // 60
    centered = frames - frames.mean(-1, keepdims=True)
    fft = np.fft.rfft(centered, n=2 * n_fft, axis=-1)
    ac = np.fft.irfft(fft * np.conj(fft), axis=-1)[:, : lag_max + 1]
    ac0 = np.maximum(ac[:, 0], 1e-10)
    band = ac[:, lag_min : lag_max + 1] / ac0[:, None]
    best = np.argmax(band, axis=-1)
    conf = np.take_along_axis(band, best[:, None], axis=-1)[:, 0]
    pitch = np.where(conf > 0.3, sr / (best + lag_min), 0.0)

    return {
        "rms": rms,
        "zcr": zcr,
        "spectral_centroid": centroid,
        "spectral_bandwidth": bandwidth,
        "spectral_rolloff": rolloff,
        "pitch": pitch,
    }
