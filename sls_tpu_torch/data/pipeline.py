"""Fixed-shape batches (own copy of the in-memory parts of
``sls_tpu/data/pipeline.py``): ``Batch``, ``to_wire`` and
``ArrayLoader`` with ``host_shard`` (the reference's
``DatasetIndex.host_shard`` for the in-memory loader).  The file-backed
loader and FLAC decoding are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from sls_tpu_torch.data.mulaw import mulaw_encode


@dataclass
class Batch:
    wav: np.ndarray  # [B, cut] float32 (or the int16 / mu-law wire)
    utt_ids: List[str]
    labels: Optional[np.ndarray]  # [B] int64 or None
    valid: np.ndarray  # [B] bool — False on repeated tail-fill rows


def to_wire(wavs: np.ndarray, wire_dtype: str) -> np.ndarray:
    """Decoded float32 audio -> the host->device wire format:
    ``float32`` as is; ``int16`` round(f * 32768), lossless for 16-bit
    sources; ``mulaw`` 8-bit companding, lossy."""
    if wire_dtype == "float32":
        return wavs
    if wire_dtype == "int16":
        return np.clip(
            np.rint(wavs.astype(np.float32) * 32768.0), -32768, 32767
        ).astype(np.int16)
    if wire_dtype == "mulaw":
        return mulaw_encode(wavs)
    raise ValueError(f"unknown wire_dtype: {wire_dtype!r}")


class ArrayLoader:
    """In-memory loader: fixed-shape batches, the short tail batch filled
    by repetition and masked by ``valid``.  With ``shuffle`` epoch ``e``
    takes its order from ``np.random.default_rng((seed, e))``, as the
    reference's loader does, so both packages see the same batches."""

    def __init__(self, wavs: np.ndarray, labels: Optional[np.ndarray],
                 utt_ids: Optional[List[str]] = None, batch_size: int = 8,
                 shuffle: bool = False, seed: int = 1234):
        self.wavs = wavs
        self.labels = labels
        self.utt_ids = utt_ids or [f"utt_{i}" for i in range(len(wavs))]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    def host_shard(self, process_index: int, process_count: int,
                   drop_remainder: bool = False) -> "ArrayLoader":
        """Per-process slice for multi-process runs: process i reads
        examples i, i+N, i+2N, ... (strided, so class balance is kept per
        process).  ``drop_remainder=True`` cuts every shard to the same
        length, floor(n / N), which training loaders need (every process
        runs the same number of steps); scoring shards keep the default
        and cover every example."""
        sel = list(range(process_index, len(self.wavs), process_count))
        if drop_remainder:
            sel = sel[: len(self.wavs) // process_count]
        return ArrayLoader(
            self.wavs[sel], None if self.labels is None else self.labels[sel],
            [self.utt_ids[i] for i in sel], self.batch_size, self.shuffle, self.seed)

    def num_batches(self) -> int:
        return (len(self.wavs) + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = np.arange(len(self.wavs))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        for lo in range(0, len(order), bs):
            sel = order[lo : lo + bs]
            valid = np.ones(bs, bool)
            if len(sel) < bs:
                valid[len(sel):] = False
                reps = int(np.ceil(bs / len(sel)))
                sel = np.tile(sel, reps)[:bs]
            yield Batch(
                wav=self.wavs[sel],
                utt_ids=[self.utt_ids[i] for i in sel],
                labels=None if self.labels is None else self.labels[sel],
                valid=valid,
            )
