"""Whole-clip scoring's input rows, worked out again: the clip
repeat-tiled to the smallest frame bucket that holds it, or cut into
chunks of the largest bucket, each tiled (the ``--unwindowed``
contract).  A bucket of T frames is the shortest waveform at or above
the total conv stride times (T - 1), in steps of a tenth of the stride,
that gives T frames.  This file imports nothing of the program under
test."""

from __future__ import annotations

import math
from typing import List, Mapping, Sequence, Tuple

import numpy as np

from perfbench.reference.xlsr import num_frames


def bucket_samples(enc: Mapping, targets: Sequence[int]) -> List[Tuple[int, int]]:
    """[(frames, samples)] of each bucket, shortest first."""
    stride = math.prod(enc["conv_stride"])
    out = []
    for t in sorted(targets):
        n = stride * (t - 1)
        while num_frames(enc, n) < t:
            n += max(1, stride // 10)
        out.append((t, n))
    return out


def bucket(samples: int, enc: Mapping, targets: Sequence[int]) -> int:
    """The frames of the bucket a clip of ``samples`` is scored at."""
    return next((t for t, n in bucket_samples(enc, targets) if samples <= n), max(targets))


def tile(wav: np.ndarray, n: int) -> np.ndarray:
    if wav.shape[0] >= n:
        return wav[:n]
    return np.tile(wav, n // wav.shape[0] + 1)[:n]


def rows(wav: np.ndarray, enc: Mapping, targets: Sequence[int]) -> Tuple[np.ndarray, int]:
    """(the rows one forward scores for ``wav``, their bucket's frames)."""
    buckets = bucket_samples(enc, targets)
    for t, n in buckets:
        if wav.shape[0] <= n:
            return tile(wav, n)[None], t
    t, n = buckets[-1]
    return np.stack([tile(wav[i:i + n], n) for i in range(0, wav.shape[0], n)]), t
