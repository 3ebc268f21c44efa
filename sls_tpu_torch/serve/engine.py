"""Dynamic batching engine, counterpart of ``sls_tpu/serve/engine.py``.

Callers ``submit()`` single utterances and get a ``Future``; a worker
thread assembles fixed-shape batches, waiting at most ``max_wait_ms`` to
fill one; a short batch dispatches on the smallest bucket shape that
fits, with row 0 tiled into the tail, and only real rows are answered.
One dispatched batch stays in flight while the next assembles: CUDA
launches are asynchronous, so ``score_fn`` returns before the device
finishes, and fetching batch N overlaps the compute of batch N+1.

Scores follow the offline contract (``scores/writer.log_probs_to_scores``),
so a served score equals the score-file entry for the same audio at the
same batch shape.  Every future is resolved through one guard: a future
that a caller cancelled, or that another path already resolved, is
skipped instead of raising ``InvalidStateError`` in the worker.  Long
clips are served by windows (``submit_windows``, ``score_long``) under
the offline full-utterance contract of ``evaluation/overlap.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from sls_tpu_torch.data.audio import DEFAULT_CUT, SAMPLE_RATE, pad_or_tile, resample
from sls_tpu_torch.data.pipeline import to_wire
from sls_tpu_torch.evaluation.overlap import aggregator, extract_windows
from sls_tpu_torch.scores.writer import log_probs_to_scores


@dataclass
class EngineStats:
    """Snapshot of serving counters (see BatchingEngine.stats)."""

    requests: int
    batches: int
    mean_fill: float  # real rows per batch / batch_size
    p50_ms: float
    p95_ms: float
    p99_ms: float

    def to_dict(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_fill": round(self.mean_fill, 4),
            "p50_ms": round(self.p50_ms, 3),
            "p95_ms": round(self.p95_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
        }


@dataclass
class _Request:
    wav: np.ndarray  # [cut] float32, already pad_or_tile'd
    future: Future
    t_submit: float


def _resolve(fut: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Set a future's result or exception unless it is already done
    (cancelled by its caller, or failed by stop())."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class BatchingEngine:
    """Collects single-utterance requests into fixed-shape batches.

    score_fn: (wav [B, cut] on the wire, numpy) -> log_probs [B, 2], a
        tensor that may still be in flight on the device.
    batch_size: the fixed batch of a full dispatch.
    max_wait_ms: how long a non-full batch waits for more requests.
    wire_dtype: "float32", "int16" or "mulaw" (data/pipeline.to_wire).
    bucket_sizes: optional smaller batch shapes for partial batches.
    """

    def __init__(
        self,
        score_fn: Callable,
        batch_size: int,
        *,
        cut: int = DEFAULT_CUT,
        max_wait_ms: float = 8.0,
        wire_dtype: str = "float32",
        queue_depth: int = 1024,
        bucket_sizes: Optional[tuple] = None,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        buckets = sorted(set(bucket_sizes or ()))
        if buckets and not (1 <= buckets[0] and buckets[-1] < batch_size):
            raise ValueError(
                f"bucket_sizes must lie in [1, batch_size); got "
                f"{bucket_sizes} with batch_size {batch_size}")
        to_wire(np.zeros(1, np.float32), wire_dtype)  # validate early
        self.score_fn = score_fn
        self.batch_size = batch_size
        self.shapes = tuple(buckets) + (batch_size,)
        self.cut = cut
        self.max_wait_ms = max_wait_ms
        self.wire_dtype = wire_dtype
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._fill_sum = 0.0
        self._latencies: deque = deque(maxlen=10_000)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingEngine":
        if self._worker is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run, name="sls-serve-batcher", daemon=True)
        self._worker.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        # every submit that passed its stop-check under _lock has landed
        # in the queue once we hold _lock; fail those stragglers
        with self._lock:
            pass
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            _resolve(req.future, exc=RuntimeError("engine stopped"))

    def __enter__(self) -> "BatchingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path ------------------------------------------------------

    def submit(self, wav: np.ndarray, sample_rate: int = 16000) -> Future:
        """Queue one utterance; resolves to float P(bonafide).  It is
        resampled to 16 kHz when ``sample_rate`` differs
        (``data/audio.resample``) and repeat-tiled / cropped to the fixed
        cut, on the caller's thread."""
        return self._submit_row(pad_or_tile(self._prepare(wav, sample_rate), self.cut))

    def _prepare(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32).reshape(-1)
        if wav.size == 0:
            raise ValueError("empty audio")
        if sample_rate != SAMPLE_RATE:
            wav = resample(wav, sample_rate, SAMPLE_RATE)
        return wav

    def submit_windows(self, wav: np.ndarray, sample_rate: int = 16000,
                       stride: Optional[int] = None) -> List[Future]:
        """One future per overlapping window of a long utterance (resampled
        to 16 kHz as in ``submit``).

        The windows are those of the offline full-utterance path
        (``evaluation/overlap.extract_windows``: stride cut // 2 by
        default, the last window right-aligned, short audio tiled to one
        window), so a served long-clip score aggregates the window scores
        that ``score_full_utterance`` aggregates.  They interleave with
        other requests in the batcher."""
        wav = self._prepare(wav, sample_rate)
        return [self._submit_row(row) for row in extract_windows(wav, self.cut, stride)]

    def score(self, wav: np.ndarray, sample_rate: int = 16000,
              timeout: Optional[float] = 30.0) -> float:
        """Blocking ``submit``."""
        return self.submit(wav, sample_rate).result(timeout)

    def score_long(self, wav: np.ndarray, sample_rate: int = 16000,
                   stride: Optional[int] = None, aggregate: str = "mean",
                   timeout: Optional[float] = 120.0):
        """Blocking long-clip score: (aggregated P(bonafide), n_windows);
        ``aggregate`` is 'mean', 'min' or 'max', as in
        ``score_full_utterance``."""
        agg = aggregator(aggregate)
        vals = [f.result(timeout) for f in self.submit_windows(wav, sample_rate, stride)]
        return float(agg(vals)), len(vals)

    def _submit_row(self, row: np.ndarray) -> Future:
        fut: Future = Future()
        req = _Request(wav=np.asarray(row, np.float32), future=fut,
                       t_submit=time.monotonic())
        with self._lock:
            if self._worker is None or self._stop.is_set():
                raise RuntimeError(
                    "engine is not running (start() it, and submit before stop())")
            try:
                self._q.put_nowait(req)
                self._requests += 1
                return fut
            except queue.Full:
                pass
        # queue full: block for backpressure outside the lock, then fail
        # our own future if stop()'s drain may already have passed it
        self._q.put(req)
        with self._lock:
            self._requests += 1
        if self._stop.is_set():
            _resolve(fut, exc=RuntimeError("engine stopped"))
        return fut

    # -- stats -------------------------------------------------------------

    def stats(self) -> EngineStats:
        with self._lock:
            lats = np.asarray(self._latencies, np.float64)
            requests, batches, fill = self._requests, self._batches, self._fill_sum
        if lats.size:
            p50, p95, p99 = np.percentile(lats, [50, 95, 99])
        else:
            p50 = p95 = p99 = 0.0
        return EngineStats(
            requests=requests,
            batches=batches,
            mean_fill=(fill / batches) if batches else 0.0,
            p50_ms=float(p50),
            p95_ms=float(p95),
            p99_ms=float(p99),
        )

    # -- worker ------------------------------------------------------------

    def _collect(self, have_pending: bool = False) -> List[_Request]:
        """Block for the first request (5 ms with a batch in flight, so
        its flush is not held back), then fill up to batch_size within
        the max_wait window."""
        try:
            first = self._q.get(timeout=0.005 if have_pending else 0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0:
                    items.append(self._q.get_nowait())
                else:
                    items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _dispatch(self, items: List[_Request]):
        rows = [r.wav for r in items]
        n_real = len(rows)
        shape = next(s for s in self.shapes if s >= n_real)
        if n_real < shape:
            rows = rows + [rows[0]] * (shape - n_real)
        wav = to_wire(np.stack(rows), self.wire_dtype)
        return items, self.score_fn(wav)

    def _flush(self, pending) -> None:
        items, out = pending
        try:
            scores = log_probs_to_scores(out)  # waits for the device here
        except Exception as e:  # every caller in the batch gets the error
            for r in items:
                _resolve(r.future, exc=e)
            return
        now = time.monotonic()
        with self._lock:
            self._batches += 1
            self._fill_sum += len(items) / self.batch_size
            for r in items:
                self._latencies.append((now - r.t_submit) * 1000.0)
        for r, s in zip(items, scores):
            _resolve(r.future, float(s))

    def _run(self) -> None:
        pending = None  # one batch in flight
        while not self._stop.is_set():
            items = self._collect(have_pending=pending is not None)
            if not items:
                if pending is not None:
                    self._flush(pending)
                    pending = None
                continue
            try:
                dispatched = self._dispatch(items)
            except Exception as e:
                for r in items:
                    _resolve(r.future, exc=e)
                continue
            if pending is not None:
                self._flush(pending)
            pending = dispatched
            if self._q.empty():
                # idle: answer now rather than hold the batch for a partner
                self._flush(pending)
                pending = None
        if pending is not None:
            self._flush(pending)
