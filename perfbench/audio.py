"""Synthetic audio from the seed, made on the device: noise with a tone
of its own in each row (0.1 sin(2 pi f t) + 0.05 N(0, 1), f uniform in
100-4000 Hz at 16 kHz), so rows differ.  It stands in for speech: the
work of every layer depends on the shapes alone."""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16000


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one named stream of a run's draws."""
    mixed = int(np.random.SeedSequence((seed % (2 ** 63), stream)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(mixed % (2 ** 63))


@torch.no_grad()
def rows(seed: int, stream: int, n: int, samples: int, device) -> torch.Tensor:
    """[n, samples] float32 rows on ``device``."""
    g = generator(seed, stream, device)
    f = 100.0 + 3900.0 * torch.rand(n, 1, generator=g, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    wav = torch.randn(n, samples, generator=g, device=device).mul_(0.05)
    return wav.add_(torch.sin((2 * math.pi) * f * t).mul_(0.1))


def to_int16(wav: torch.Tensor) -> np.ndarray:
    """Rows on the int16 wire (round(x * 32768), clipped), on the host."""
    return torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(torch.int16).cpu().numpy()


def int16_rows(seed: int, stream: int, n: int, samples: int, device, block: int = 256
               ) -> np.ndarray:
    """[n, samples] int16 rows on the host, made on the device a block at a
    time."""
    out = np.empty((n, samples), np.int16)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        out[lo:hi] = to_int16(rows(seed, stream * 1_000_003 + lo, hi - lo, samples, device))
    return out
