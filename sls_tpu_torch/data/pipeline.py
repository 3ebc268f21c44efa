"""Host-side input pipeline (own copy of ``sls_tpu/data/pipeline.py``):
``DatasetIndex`` (a split's files), the thread-prefetched file-backed
``BatchLoader``, the in-memory ``ArrayLoader``, ``Batch`` and
``to_wire``.

Both loaders yield fixed-shape numpy batches: the short tail batch is
filled by repeating its rows and masked by ``valid``.  With ``shuffle``
epoch ``e`` takes its order from ``np.random.default_rng((seed, e))``,
as the reference's loaders do, so both packages see the same batches.
Decoding and the repeat-tile crop run on loader threads (FLAC in one
native call a batch, ``data/flac.py``); augmentation runs on the device,
and ``train/steps.py::to_device`` uploads.  A corrupt file decodes to a
zero row, which is valid and scored, so score files stay complete; a
missing file raises.  Building a batch is the span ``sls.load``
(``train/profiling.py``), keyed by its first utterance id.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from sls_tpu_torch.data.audio import DEFAULT_CUT, load_audio, pad_or_tile
from sls_tpu_torch.data.mulaw import mulaw_encode, mulaw_from_int16
from sls_tpu_torch.train.profiling import span

PathLike = Union[str, Path]


@dataclass
class DatasetIndex:
    """The resolved file list of one split."""

    utt_ids: List[str]
    paths: List[Path]
    labels: Optional[np.ndarray] = None  # int64 [N], 1 = bonafide

    def __len__(self) -> int:
        return len(self.utt_ids)

    @staticmethod
    def for_train(utt_ids: Sequence[str], labels: Dict[str, int], base_dir: PathLike,
                  ext: str = "flac") -> "DatasetIndex":
        """2019 LA layout: ``<base_dir>/flac/<utt>.<ext>``, with labels."""
        base = Path(base_dir)
        return DatasetIndex(utt_ids=list(utt_ids),
                            paths=[base / "flac" / f"{u}.{ext}" for u in utt_ids],
                            labels=np.asarray([labels[u] for u in utt_ids], np.int64))

    @staticmethod
    def for_eval(utt_ids: Sequence[str], base_dir: PathLike, ext: str = "flac"
                 ) -> "DatasetIndex":
        """2021 eval layout: ``<base_dir>/flac/<utt>.<ext>``."""
        base = Path(base_dir)
        return DatasetIndex(utt_ids=list(utt_ids),
                            paths=[base / "flac" / f"{u}.{ext}" for u in utt_ids])

    @staticmethod
    def for_in_the_wild(utt_ids: Sequence[str], base_dir: PathLike) -> "DatasetIndex":
        """In-the-Wild layout: the ids already carry ``.wav``."""
        base = Path(base_dir)
        return DatasetIndex(utt_ids=list(utt_ids), paths=[base / u for u in utt_ids])

    def host_shard(self, process_index: int, process_count: int,
                   drop_remainder: bool = False) -> "DatasetIndex":
        """Per-process slice: process i reads examples i, i+N, i+2N, ...
        (strided, so class balance is kept per process).
        ``drop_remainder=True`` cuts every shard to floor(n / N), which
        training needs (every process runs the same number of steps);
        scoring shards keep the default and cover every example."""
        sel = list(range(process_index, len(self.utt_ids), process_count))
        if drop_remainder:
            sel = sel[: len(self.utt_ids) // process_count]
        return DatasetIndex(utt_ids=[self.utt_ids[i] for i in sel],
                            paths=[self.paths[i] for i in sel],
                            labels=None if self.labels is None else self.labels[sel])


def _decode_one(path: Path, cut: int) -> np.ndarray:
    """One file as a float32 row of ``cut`` samples; zeros for a corrupt
    file."""
    wav = load_audio(path)
    if wav.shape[0] == 0:
        return np.zeros(cut, np.float32)
    return pad_or_tile(wav, cut).astype(np.float32)


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


class BatchLoader:
    """Thread-prefetched fixed-shape batches of a ``DatasetIndex``.

    ``num_threads`` producer threads each assemble whole batches (batch
    b on producer b % num_threads), at most ``prefetch`` of them queued;
    the consumer yields them in order from a reorder dict.  An all-FLAC
    index decodes each batch in one native call with ``decode_threads``
    threads (0: the host's cores spread over the producers), already on
    the int16 wire where that is asked for (mu-law: int16 companded
    through a table); other indexes decode file by file on the producer.
    ``limit_batches`` cuts every epoch short."""

    def __init__(self, index: DatasetIndex, batch_size: int, *, cut: int = DEFAULT_CUT,
                 shuffle: bool = False, seed: int = 1234, num_threads: int = 8,
                 prefetch: int = 4, limit_batches: Optional[int] = None,
                 wire_dtype: str = "float32", decode_threads: int = 0):
        self.index = index
        self.batch_size = batch_size
        self.cut = cut
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.decode_threads = decode_threads
        self.prefetch = prefetch
        self.limit_batches = limit_batches
        to_wire(np.zeros(1, np.float32), wire_dtype)  # an unknown wire raises here
        self.wire_dtype = wire_dtype

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.index))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        return order

    def num_batches(self) -> int:
        n = (len(self.index) + self.batch_size - 1) // self.batch_size
        if self.limit_batches is not None:
            n = min(n, self.limit_batches)
        return n

    def producers_and_decode_threads(self) -> tuple:
        """(producer threads, native decode threads per producer) of an
        epoch."""
        n_producers = min(self.num_threads, max(self.num_batches(), 1))
        return n_producers, self.decode_threads or max(1, (os.cpu_count() or 1) // n_producers)

    def _assemble(self, order: np.ndarray, batch_idx: int, all_flac: bool,
                  decode_threads: int) -> Batch:
        from sls_tpu_torch.data.flac import decode_batch

        lo = batch_idx * self.batch_size
        with span("sls.load", self.index.utt_ids[order[lo]]):
            sel = order[lo: lo + self.batch_size]
            valid = np.ones(self.batch_size, bool)
            if len(sel) < self.batch_size:  # static shapes: repeat the tail
                valid[len(sel):] = False
                sel = (np.resize(sel, self.batch_size) if len(sel)
                       else np.zeros(self.batch_size, np.int64))
            paths = [self.index.paths[i] for i in sel]
            if all_flac and self.wire_dtype == "mulaw":
                wavs = mulaw_from_int16(decode_batch(paths, self.cut, n_threads=decode_threads,
                                                     dtype="int16"))
            elif all_flac:
                wavs = decode_batch(paths, self.cut, n_threads=decode_threads,
                                    dtype=self.wire_dtype)
            else:
                wavs = to_wire(np.stack([_decode_one(p, self.cut) for p in paths]),
                               self.wire_dtype)
            return Batch(wav=wavs, utt_ids=[self.index.utt_ids[i] for i in sel],
                         labels=None if self.index.labels is None else self.index.labels[sel],
                         valid=valid)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """The batches of one epoch, in order.  A consumer that stops
        early (``break``) stops the producers; a decode error is raised
        here."""
        order = self._order(epoch)
        n_batches = self.num_batches()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        all_flac = all(p.suffix.lower() == ".flac" for p in self.index.paths)
        n_producers, decode_threads = self.producers_and_decode_threads()

        def safe_put(item) -> bool:
            # a put that gives up at shutdown: a consumer that broke off
            # must not leave a producer blocked on a full queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        # the producers' watermark: the queue bound alone is no
        # backpressure, since the consumer drains it to find the in-order
        # batch and one stalled batch would let the others run ahead into
        # the reorder dict.  Blocking the consumer instead would deadlock.
        max_ahead = self.prefetch + 2 * n_producers
        consumed = [0]  # the next in-order batch the consumer needs

        def producer(worker: int) -> None:
            for b in range(worker, n_batches, self.num_threads):
                while b > consumed[0] + max_ahead and not stop.is_set():
                    stop.wait(0.05)
                if stop.is_set():
                    return
                try:
                    item = self._assemble(order, b, all_flac, decode_threads)
                except Exception as exc:  # handed to the consumer, which raises it
                    safe_put((b, exc))
                    return
                if not safe_put((b, item)):
                    return

        threads = [threading.Thread(target=producer, args=(w,), daemon=True,
                                    name=f"batch-loader-{w}") for w in range(n_producers)]
        for t in threads:
            t.start()
        try:
            pending: Dict[int, Batch] = {}
            next_b = 0
            received = 0
            while next_b < n_batches:
                while next_b not in pending and received < n_batches:
                    b, item = out_q.get()
                    if isinstance(item, Exception):
                        raise item
                    pending[b] = item
                    received += 1
                yield pending.pop(next_b)
                next_b += 1
                consumed[0] = next_b
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=0.5)


class ArrayLoader:
    """In-memory loader with ``BatchLoader``'s batches: synthetic data,
    tests, and the decoded arrays of files."""

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
            with span("sls.load", self.utt_ids[order[lo]]):
                sel = order[lo : lo + bs]
                valid = np.ones(bs, bool)
                if len(sel) < bs:
                    valid[len(sel):] = False
                    reps = int(np.ceil(bs / len(sel)))
                    sel = np.tile(sel, reps)[:bs]
                batch = Batch(
                    wav=self.wavs[sel],
                    utt_ids=[self.utt_ids[i] for i in sel],
                    labels=None if self.labels is None else self.labels[sel],
                    valid=valid,
                )
            yield batch
