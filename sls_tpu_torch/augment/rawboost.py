"""RawBoost waveform augmentation on the device, counterpart of
``sls_tpu/augment/rawboost.py``.

The three primitives of RawBoost (Tak et al. 2022; dispatch as the
reference's ``data_utils_SSL.py:141-203``):

1. LnL convolutive noise: the sum over powers x^(i+1), each through a
   random multi-band FIR notch filter;
2. ISD impulsive signal-dependent noise: a random subset of samples gets
   a multiplicative perturbation;
3. SSI stationary coloured additive noise: notch-filtered white noise at
   a random SNR;

and the composed algorithms 1-8 (series and parallel combinations).

The whole batch is augmented at once, with no loop over examples and no
host sync: every random parameter is drawn as a ``[B, ...]`` tensor from
one ``torch.Generator`` on the batch's device; each example's filter
cascade lies in a zero-padded ``[B, max_total]`` buffer with its length
as a tensor; every row is filtered by one batched FFT, and the
group-delay trim is a gather at each row's own offset.  ISD's exact
subset is the rank of a uniform draw (``argsort(argsort(z)) < n``).

Each primitive is a *draw* (``draw_lnl``, ``draw_isd``, ``draw_ssi``,
``draw_notch``) and a deterministic *apply* (``apply_lnl``,
``apply_isd``, ``apply_ssi``, ``notch_coeffs``), so the deterministic
half can be held to the JAX package on the same inputs.  The random
streams differ from ``jax.random``'s, so the composed algorithms agree
with the reference in distribution only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from sls_tpu_torch.config import RawBoostConfig
from sls_tpu_torch.device import DeviceLike, resolve_device

FREQZ_POINTS = 512  # scipy.signal.freqz's default grid over [0, pi)


def _fft_size(n: int) -> int:
    """The least power of two >= n."""
    return 1 << (n - 1).bit_length()


def _conv_fft(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full linear convolution of the last dims (leading dims broadcast),
    by one batched real FFT; the result is ``[..., n]`` with its first
    ``len(a) + len(b) - 1`` entries the convolution."""
    n = _fft_size(a.shape[-1] + b.shape[-1] - 1)
    return torch.fft.irfft(torch.fft.rfft(a, n) * torch.fft.rfft(b, n), n)


def firwin_bandstop(num_taps: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor, fs: float,
                    max_taps: int) -> torch.Tensor:
    """Hamming-windowed band-stop FIR design (``scipy.signal.firwin``
    with cutoff [f1, f2], ``pass_zero=True``) in a ``max_taps`` buffer:
    ``[..., max_taps]`` for ODD integer ``num_taps`` [...] <= max_taps,
    taps beyond each one's count zero.  Computed in ``f1``'s dtype."""
    n = torch.arange(max_taps, dtype=f1.dtype, device=f1.device)
    taps = num_taps.to(f1.dtype)[..., None]
    m = n - (taps - 1) / 2.0  # symmetric time index
    f1n = (2.0 * f1 / fs)[..., None]  # normalised to Nyquist = 1
    f2n = (2.0 * f2 / fs)[..., None]
    # passbands [0, f1n] and [f2n, 1]
    h = f1n * torch.sinc(f1n * m) + torch.sinc(m) - f2n * torch.sinc(f2n * m)
    win = 0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (taps - 1))
    h = torch.where(n < taps, h * win, 0.0)
    return h / h.sum(-1, keepdim=True)  # unit DC response


def _convolve_trunc(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Full convolution of the last dims truncated to ``out_len`` (the
    supports are known to fit, so the truncation is exact)."""
    return _conv_fft(a, b)[..., :out_len]


def _freqz_peak(b: torch.Tensor) -> torch.Tensor:
    """max |H(w)| over ``scipy.signal.freqz``'s default grid w_k = pi k /
    512 of each row of ``b`` [..., L], from an FFT of max(1024, 2 L)
    points (the grid is freqz's exactly when L <= 512, which
    ``_filter_sizes`` ensures)."""
    n = max(2 * FREQZ_POINTS, 2 * b.shape[-1])
    return torch.fft.rfft(b, n)[..., :FREQZ_POINTS].abs().amax(-1)


def filter_fir(x: torch.Tensor, b: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """FIR filtering with the reference's group-delay trim
    (RawBoost.py:45-50): y = conv(x, b)[(L + 1) // 2 :][: S] for each row,
    with ``b`` [..., max_total] holding a filter of ``length`` [...] taps.
    One batched FFT; the trim is a gather at each row's own offset."""
    s = x.shape[-1]
    full = _conv_fft(x, b)
    start = torch.div(length + 1, 2, rounding_mode="floor")
    idx = start[..., None] + torch.arange(s, device=x.device)
    return full.gather(-1, idx.expand(*full.shape[:-1], s))


def norm_wav(x: torch.Tensor, always: bool) -> torch.Tensor:
    """Peak normalisation of each row (RawBoost.py:14-19): always, or only
    where the peak exceeds 1."""
    peak = x.abs().amax(-1, keepdim=True)
    if always:
        return x / peak
    return torch.where(peak > 1.0, x / peak, x)


def _filter_sizes(cfg: RawBoostConfig) -> Tuple[int, int]:
    """(max_taps, max_total): the largest odd filter, and the largest
    cascade of ``nBands`` of them; raises beyond freqz's 512-point grid."""
    max_taps = cfg.maxCoeff + 2  # the odd adjustment can add 1
    max_total = cfg.nBands * (max_taps - 1) + 1
    if max_total > FREQZ_POINTS:
        raise ValueError(
            "filter cascade exceeds the 512-tap freqz grid; reduce nBands*maxCoeff")
    return max_taps, max_total


# -- draws -------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape: Sequence[int], lo, hi) -> torch.Tensor:
    """U(lo, hi) fp32 on the generator's device (``lo``, ``hi`` may be
    tensors broadcasting against ``shape``)."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device) * (hi - lo) + lo


@dataclass
class NotchDraw:
    """The random parameters of notch-filter cascades: per band centre
    ``fc``, width ``bw`` and odd tap count ``c`` ([..., nBands]), and the
    cascade's gain in dB ([...])."""

    fc: torch.Tensor
    bw: torch.Tensor
    c: torch.Tensor
    gain_db: torch.Tensor

    def to(self, device: DeviceLike, dtype: torch.dtype) -> "NotchDraw":
        """The same draw on ``device``, the real parameters in ``dtype``."""
        return NotchDraw(self.fc.to(device, dtype), self.bw.to(device, dtype),
                         self.c.to(device), self.gain_db.to(device, dtype))


def draw_notch(gen: torch.Generator, shape: Sequence[int], cfg: RawBoostConfig,
               min_g=None, max_g=None) -> NotchDraw:
    """Cascades of ``shape`` (RawBoost.py:22-42): band parameters
    uniform in the config's ranges, the tap count floor(U(minCoeff,
    maxCoeff)) forced odd, the gain U(min_g, max_g) dB (default the
    config's minG, maxG; tensors broadcasting against ``shape`` too)."""
    bands = (*shape, cfg.nBands)
    fc = _uniform(gen, bands, float(cfg.minF), float(cfg.maxF))
    bw = _uniform(gen, bands, float(cfg.minBW), float(cfg.maxBW))
    c = torch.floor(_uniform(gen, bands, float(cfg.minCoeff), float(cfg.maxCoeff))).long()
    c = torch.where(c % 2 == 0, c + 1, c)
    gain = _uniform(gen, shape, float(cfg.minG) if min_g is None else min_g,
                    float(cfg.maxG) if max_g is None else max_g)
    return NotchDraw(fc, bw, c, gain)


def notch_coeffs(draw: NotchDraw, cfg: RawBoostConfig, fs: float, max_taps: int,
                 max_total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(taps [..., max_total], cascade length [...]) of ``draw``: the
    bands' band-stop filters convolved in turn, scaled to the drawn gain
    at freqz's peak (the reference's ``gen_notch_coeffs``)."""
    f1 = torch.clamp(draw.fc - draw.bw / 2.0, min=1.0 / 1000.0)
    f2 = torch.clamp(draw.fc + draw.bw / 2.0, max=fs / 2.0 - 1.0 / 1000.0)
    taps = firwin_bandstop(draw.c, f1, f2, fs, max_taps)  # [..., nBands, max_taps]
    b = torch.zeros((*draw.gain_db.shape, max_total), dtype=taps.dtype, device=taps.device)
    b[..., 0] = 1.0
    for i in range(cfg.nBands):
        b = _convolve_trunc(taps[..., i, :], b, max_total)
    length = 1 + (draw.c - 1).sum(-1)
    gain = 10.0 ** (draw.gain_db / 20.0)
    return gain[..., None] * b / _freqz_peak(b)[..., None], length


# -- the primitives: draw, then apply ----------------------------------------------


def draw_lnl(gen: torch.Generator, shape: Sequence[int], cfg: RawBoostConfig) -> NotchDraw:
    """LnL's ``N_f`` cascades per row, [*shape, N_f]: the first at the
    config's gain, the others lowered by the linearity bias."""
    bias = (torch.arange(cfg.N_f, device=gen.device) > 0).float()  # no host copy
    return draw_notch(gen, (*shape, cfg.N_f), cfg, cfg.minG - bias * cfg.minBiasLinNonLin,
                      cfg.maxG - bias * cfg.maxBiasLinNonLin)


def apply_lnl(x: torch.Tensor, draw: NotchDraw, cfg: RawBoostConfig,
              fs: float = 16000.0) -> torch.Tensor:
    """Algorithm 1 (RawBoost.py:53-63) on rows ``x`` [..., S]: the power
    series through its cascades, mean removed, peak-bounded."""
    max_taps, max_total = _filter_sizes(cfg)
    b, length = notch_coeffs(draw, cfg, fs, max_taps, max_total)
    powers = torch.stack([torch.pow(x, i + 1) for i in range(cfg.N_f)], dim=-2)
    y = filter_fir(powers, b, length).sum(-2)
    return norm_wav(y - y.mean(-1, keepdim=True), always=False)


@dataclass
class ISDDraw:
    """ISD's draws: the share ``beta`` [...] (percent), the uniform ``z``
    whose ranks pick the subset, and the two uniforms of the
    perturbation (each [..., S])."""

    beta: torch.Tensor
    z: torch.Tensor
    u1: torch.Tensor
    u2: torch.Tensor


def draw_isd(gen: torch.Generator, shape: Sequence[int], cfg: RawBoostConfig) -> ISDDraw:
    """ISD's draws for rows of ``shape`` [..., S]."""
    beta = _uniform(gen, shape[:-1], 0.0, float(cfg.P))
    return ISDDraw(beta, *(_uniform(gen, shape, 0.0, 1.0) for _ in range(3)))


def apply_isd(x: torch.Tensor, draw: ISDDraw, cfg: RawBoostConfig) -> torch.Tensor:
    """Algorithm 2 (RawBoost.py:67-78): a uniformly random subset of
    floor(S * beta / 100) samples of each row, exactly (the ranks of a
    uniform draw), takes ``g_sd * x * f_r`` more."""
    n = (x.shape[-1] * draw.beta / 100.0).to(torch.int64)
    rank = draw.z.argsort(-1).argsort(-1)
    mask = (rank < n[..., None]).to(x.dtype)
    f_r = (2.0 * draw.u1 - 1.0) * (2.0 * draw.u2 - 1.0)
    return norm_wav(x + mask * (float(cfg.g_sd) * x * f_r), always=False)


@dataclass
class SSIDraw:
    """SSI's draws: white noise [..., S], its cascade, and the SNR [...]
    in dB."""

    noise: torch.Tensor
    notch: NotchDraw
    snr: torch.Tensor


def draw_ssi(gen: torch.Generator, shape: Sequence[int], cfg: RawBoostConfig) -> SSIDraw:
    """SSI's draws for rows of ``shape`` [..., S]."""
    noise = torch.randn(tuple(shape), generator=gen, device=gen.device)
    notch = draw_notch(gen, shape[:-1], cfg)
    return SSIDraw(noise, notch, _uniform(gen, shape[:-1], float(cfg.SNRmin), float(cfg.SNRmax)))


def apply_ssi(x: torch.Tensor, draw: SSIDraw, cfg: RawBoostConfig,
              fs: float = 16000.0) -> torch.Tensor:
    """Algorithm 3 (RawBoost.py:83-91): the noise through its cascade,
    peak-normalised, added at the drawn SNR of each row."""
    max_taps, max_total = _filter_sizes(cfg)
    b, length = notch_coeffs(draw.notch, cfg, fs, max_taps, max_total)
    noise = norm_wav(filter_fir(draw.noise, b, length), always=True)
    scale = x.norm(dim=-1, keepdim=True) / (10.0 ** (0.05 * draw.snr[..., None]))
    return x + noise / noise.norm(dim=-1, keepdim=True) * scale


def lnl_convolutive_noise(gen: torch.Generator, x: torch.Tensor, cfg: RawBoostConfig,
                          fs: float = 16000.0) -> torch.Tensor:
    return apply_lnl(x, draw_lnl(gen, x.shape[:-1], cfg), cfg, fs)


def isd_additive_noise(gen: torch.Generator, x: torch.Tensor,
                       cfg: RawBoostConfig) -> torch.Tensor:
    return apply_isd(x, draw_isd(gen, x.shape, cfg), cfg)


def ssi_additive_noise(gen: torch.Generator, x: torch.Tensor, cfg: RawBoostConfig,
                       fs: float = 16000.0) -> torch.Tensor:
    return apply_ssi(x, draw_ssi(gen, x.shape, cfg), cfg, fs)


def apply_rawboost(gen: torch.Generator, x: torch.Tensor, cfg: RawBoostConfig,
                   fs: float = 16000.0) -> torch.Tensor:
    """The composed algorithm ``cfg.algo`` on rows ``x`` [..., S]
    (data_utils_SSL.py:141-203); 0 or any other value returns ``x``."""
    algo = cfg.algo
    if algo == 1:
        return lnl_convolutive_noise(gen, x, cfg, fs)
    if algo == 2:
        return isd_additive_noise(gen, x, cfg)
    if algo == 3:
        return ssi_additive_noise(gen, x, cfg, fs)
    if algo == 4:  # 1 + 2 + 3 in series
        y = isd_additive_noise(gen, lnl_convolutive_noise(gen, x, cfg, fs), cfg)
        return ssi_additive_noise(gen, y, cfg, fs)
    if algo == 5:  # 1 + 2 in series
        return isd_additive_noise(gen, lnl_convolutive_noise(gen, x, cfg, fs), cfg)
    if algo == 6:  # 1 + 3 in series
        return ssi_additive_noise(gen, lnl_convolutive_noise(gen, x, cfg, fs), cfg, fs)
    if algo == 7:  # 2 + 3 in series
        return ssi_additive_noise(gen, isd_additive_noise(gen, x, cfg), cfg, fs)
    if algo == 8:  # 1 || 2 in parallel
        y = lnl_convolutive_noise(gen, x, cfg, fs) + isd_additive_noise(gen, x, cfg)
        return norm_wav(y, always=False)
    return x


def rawboost_batch(generator: torch.Generator, wavs, cfg: RawBoostConfig,
                   fs: float = 16000.0, device: DeviceLike = "cuda") -> torch.Tensor:
    """Augment float audio ``wavs`` [B, S] (tensor or array, moved to
    ``device``) with algorithm ``cfg.algo``, every random parameter drawn
    from ``generator``, which must lie on that device.  No host sync."""
    dev = resolve_device(device)
    x = wavs if torch.is_tensor(wavs) else torch.from_numpy(np.ascontiguousarray(wavs))
    x = x.to(dev)
    g = generator.device
    if g.type != x.device.type or g.index not in (None, x.device.index):
        raise ValueError(f"generator on {g}, batch on {x.device}")
    return apply_rawboost(generator, x, cfg, fs)

