"""Overlap-window and long-clip evaluation, counterpart of
``sls_tpu/evaluation/overlap.py``.

- ``make_scoring_step`` / ``overlap_stability_eval``: one forward gives
  the scores and the active-code masks, so the overlap-boundary
  stability statistics come with scoring.
- ``extract_windows`` / ``score_full_utterance`` /
  ``score_utterances_streamed``: variable-length clips scored by
  overlapping fixed-size waveform windows (``--full_utterance``).
- ``length_buckets`` / ``score_utterances_unwindowed``: one forward a
  clip with the whole waveform in context (``--unwindowed``); long
  buckets (T >= ``flash_long_t``) run attention through the hand-written
  kernel (``kernels/attention.py``); with ``sp_mesh`` each forward runs
  sequence-parallel over the mesh's ranks (``parallel/sequence.py``).

The functions take the port's ``Detector`` and a device (the card by
default) in place of ``(model, params)``, and run all compute under
``torch.inference_mode()``.  The full-utterance scorers use
``Detector.score`` (no decode) and the score contract of
``scores/writer.log_probs_to_scores``.  Device work is dispatched ahead
of the host fetches, which trail it by at most two batches.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.analysis.temporal import boundary_discontinuity, mean_temporal_jaccard
from sls_tpu_torch.data.audio import pad_or_tile
from sls_tpu_torch.device import DeviceLike, resolve_device
from sls_tpu_torch.metrics.eer import compute_eer
from sls_tpu_torch.parallel.sequence import sp_scoring_fn
from sls_tpu_torch.scores.writer import log_probs_to_scores
from sls_tpu_torch.train.profiling import keyed, span
from sls_tpu_torch.train.steps import dequantize_wire

_AGGREGATES = {"mean": np.mean, "min": np.min, "max": np.max}


def aggregator(name: str):
    """The reduction of window scores that ``name`` ('mean', 'min', 'max') picks."""
    if name not in _AGGREGATES:
        raise ValueError(f"aggregate must be one of {sorted(_AGGREGATES)}, got {name!r}")
    return _AGGREGATES[name]


def _to_device(wav, dev: torch.device) -> torch.Tensor:
    w = wav if torch.is_tensor(wav) else torch.from_numpy(np.ascontiguousarray(wav))
    return dequantize_wire(w.to(dev))


def _log_probs(model, rows: np.ndarray, dev: torch.device, fwd=None) -> torch.Tensor:
    """log_probs [n, 2] of float32 waveform rows, left in flight, through
    ``fwd`` (default: ``model.score``); spans ``sls.upload`` and
    ``sls.dispatch``."""
    with torch.inference_mode():
        with span("sls.upload"):
            wav = _to_device(rows.astype(np.float32, copy=False), dev)
        with span("sls.dispatch"):
            return (fwd or model.score)(wav)


def _tile_rows(rows: np.ndarray, batch_size: int) -> np.ndarray:
    """A short batch repeat-tiled to ``batch_size`` rows, so every
    dispatch has one shape; only the first ``len(rows)`` are read."""
    if len(rows) >= batch_size:
        return rows
    reps = -(-batch_size // len(rows))
    return np.tile(rows, (reps, 1))[:batch_size]


# ---------------------------------------------------------------------------
# Joint scoring and temporal stability


def make_scoring_step(model, device: DeviceLike = "cuda"):
    """(wav [B, S] on the wire, numpy or tensor) -> {"score": [B],
    "active": [B, T, M] bool}, left on ``device``: P(bonafide) and the
    mask of active SAE codes, from one full forward."""
    dev = resolve_device(device)

    def step(wav) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            out = model(_to_device(wav, dev))
            return {"score": out["score"], "active": out["codes"] > 0}

    return step


def overlap_stability_eval(model, loader, window: int = 8,
                           labels: Optional[Dict[str, int]] = None,
                           max_samples: Optional[int] = None,
                           device: DeviceLike = "cuda") -> Dict:
    """Score every utterance of ``loader`` (an ``ArrayLoader``) and
    accumulate the overlap-boundary stability of its codes.

    Returns the reference's dict: per-utterance scores, interior and
    boundary Jaccard at the overlap stride, mean Jaccard, and the EER in
    percent when ``labels`` ({utt_id: 1 bonafide / 0 spoof}) are given.
    Samples are counted when a batch is dispatched, so at most
    ``max_samples`` utterances are scored."""
    step = make_scoring_step(model, device)
    scores: Dict[str, float] = {}
    interior, boundary, jaccard = [], [], []
    n_seen = 0

    def consume(out, utt_ids, valid):
        s = out["score"].cpu().numpy()  # waits for the device here
        active = out["active"].cpu().numpy()
        for utt, ok, score in zip(utt_ids, valid, s):
            if ok:
                scores[utt] = float(score)
        # weight each batch's means by its valid rows, so a short tail
        # batch does not count as much as a full one
        n = int(valid.sum())
        stats = boundary_discontinuity(active[valid], window, overlap=True)
        interior.append((stats["interior_jaccard"], n))
        boundary.append((stats["boundary_jaccard"], n))
        jaccard.append((mean_temporal_jaccard(active[valid]), n))

    pending: deque = deque()
    for batch in loader.epoch(0):
        valid = np.asarray(batch.valid, bool).copy()
        if max_samples is not None:
            if n_seen >= max_samples:
                break
            valid &= np.cumsum(valid) <= max_samples - n_seen
        n_seen += int(valid.sum())
        pending.append((step(batch.wav), batch.utt_ids, valid))
        if len(pending) > 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())

    def wmean(pairs, default=1.0):
        tot = sum(w for _, w in pairs)
        if not tot:
            return default
        return float(sum(v * w for v, w in pairs) / tot)

    interior_m = wmean(interior)
    boundary_m = wmean(boundary)
    result = {
        "num_samples": n_seen,
        "scores": scores,
        "temporal_stability": {
            "mean_jaccard": wmean(jaccard),
            "interior": interior_m,
            "boundary": boundary_m,
            "discontinuity_pct": 100.0 * (interior_m - boundary_m) / max(interior_m, 1e-12),
        },
    }
    if labels:
        bona = np.array([s for u, s in scores.items() if labels.get(u) == 1])
        spoof = np.array([s for u, s in scores.items() if labels.get(u) == 0])
        if len(bona) and len(spoof):
            eer, _ = compute_eer(bona, spoof)
            result["eer_pct"] = 100.0 * eer
    return result


# ---------------------------------------------------------------------------
# Full-utterance windowed scoring


def extract_windows(wav: np.ndarray, window: int = 64600,
                    stride: Optional[int] = None) -> np.ndarray:
    """Overlapping fixed-size windows over a whole utterance: [n, window].

    Short audio is repeat-tiled to one window; the last window is
    right-aligned, so the tail is always covered."""
    stride = stride or window // 2
    n = wav.shape[0]
    if n <= window:
        return pad_or_tile(wav, window)[None, :]
    starts = list(range(0, n - window + 1, stride))
    if starts[-1] + window < n:
        starts.append(n - window)
    return np.stack([wav[s:s + window] for s in starts])


def score_full_utterance(model, wav: np.ndarray, window: int = 64600,
                         stride: Optional[int] = None, batch_size: int = 16,
                         aggregate: str = "mean", device: DeviceLike = "cuda") -> Dict:
    """Score one variable-length utterance by overlapping windows.

    The window scores are aggregated to one P(bonafide): 'mean'
    (default), 'min' (one spoofed span flags the clip) or 'max'.  A short
    last batch is repeat-tiled to ``batch_size``.  Returns {"score",
    "n_windows", "window_scores"}."""
    dev = resolve_device(device)
    agg = aggregator(aggregate)
    windows = extract_windows(np.asarray(wav, np.float32), window, stride)
    n = len(windows)
    in_flight = [(len(windows[lo:lo + batch_size]),
                  _log_probs(model, _tile_rows(windows[lo:lo + batch_size], batch_size), dev))
                 for lo in range(0, n, batch_size)]
    window_scores = np.concatenate([log_probs_to_scores(lp)[:k] for k, lp in in_flight])
    return {"score": float(agg(window_scores)), "n_windows": n,
            "window_scores": window_scores}


def score_utterances_streamed(model, audio_iter, window: int = 64600,
                              stride: Optional[int] = None, batch_size: int = 32,
                              aggregate: str = "mean", device: DeviceLike = "cuda"):
    """Full-utterance scoring of many variable-length clips, their windows
    packed into one stream of fixed-size batches.

    ``audio_iter`` yields (utt_id, waveform); this yields (utt_id, score)
    in submission order, one for every clip, the windows of the last,
    short batch included."""
    dev = resolve_device(device)
    stride = stride or window // 2
    agg = aggregator(aggregate)

    pending: list = []  # (utt_id, window) not yet dispatched
    counts: Dict[str, int] = {}
    acc: Dict[str, list] = {}
    order: deque = deque()
    in_flight: deque = deque()  # (rows, log_probs in flight)

    def flush_ready():
        while order and len(acc[order[0]]) == counts[order[0]]:
            utt = order.popleft()
            counts.pop(utt)
            yield utt, float(agg(np.asarray(acc.pop(utt))))

    def drain_one():
        rows, lp = in_flight.popleft()
        for (utt, _), s in zip(rows, log_probs_to_scores(lp)):
            acc[utt].append(float(s))

    def run_batch(rows):
        # ``rows`` is a list of its own: later edits of ``pending`` do not
        # reach the batch in flight
        wavs = _tile_rows(np.stack([w for _, w in rows]), batch_size)
        in_flight.append((rows, _log_probs(model, wavs, dev)))
        if len(in_flight) > 2:
            drain_one()

    for utt_id, wav in audio_iter:
        wins = extract_windows(np.asarray(wav, np.float32), window, stride)
        counts[utt_id] = len(wins)
        acc[utt_id] = []
        order.append(utt_id)
        pending.extend((utt_id, w) for w in wins)
        while len(pending) >= batch_size:
            run_batch(pending[:batch_size])
            del pending[:batch_size]
            yield from flush_ready()

    if pending:
        run_batch(pending)
        pending = []
    while in_flight:
        drain_one()
    yield from flush_ready()


# ---------------------------------------------------------------------------
# Unwindowed full-utterance scoring


def length_buckets(enc_cfg, t_targets=(256, 512, 1280, 2560, 5120)) -> Dict[int, int]:
    """{frame count: waveform samples giving it}, for unwindowed scoring.
    The targets are multiples of 256, so the long-T attention kernel's
    block constraint holds and every clip falls in one of
    ``len(t_targets)`` shapes.  Inverts ``enc_cfg.num_frames`` by an
    upward search from the total conv stride's bound, in steps of a tenth
    of that stride."""
    stride = 1
    for _, _, s in enc_cfg.conv_layers:
        stride *= s
    out = {}
    for t in t_targets:
        lo = stride * (t - 1)
        while enc_cfg.num_frames(lo) < t:
            lo += max(1, stride // 10)
        out[t] = lo
    return out


def unwindowed_batch(wav: np.ndarray, buckets: Dict[int, int]) -> Tuple[np.ndarray, int]:
    """The rows one unwindowed forward scores for a clip, and their
    bucket's frame count.  The clip is repeat-tiled up to the smallest
    bucket that holds it; a clip longer than the largest bucket is cut
    into chunks of that bucket, each tiled, one row each."""
    wav = np.asarray(wav, np.float32)
    sizes = sorted(buckets.values())
    size = next((s for s in sizes if wav.shape[0] <= s), sizes[-1])
    if wav.shape[0] <= size:
        rows = pad_or_tile(wav, size)[None, :]
    else:
        n_chunks = -(-wav.shape[0] // size)
        rows = np.stack([pad_or_tile(wav[i * size:(i + 1) * size], size)
                         for i in range(n_chunks)])
    t_bucket = next(t for t, s in buckets.items() if s == size)
    return rows, t_bucket


def score_utterances_unwindowed(model, audio_iter, enc_cfg,
                                t_targets=(256, 512, 1280, 2560, 5120), sp_mesh=None,
                                device: DeviceLike = "cuda"):
    """Unwindowed full-utterance scoring: one forward a clip, the whole
    waveform in context, so the head mean-pools over every frame.

    Clips are padded to length buckets (``unwindowed_batch``); a clip past
    the largest bucket scores the mean of its chunks.  Buckets at or above
    ``enc_cfg.flash_long_t`` run attention through the long-T kernel.

    With ``sp_mesh`` (a ('data', 'seq') mesh, ``parallel/sequence.py``)
    each forward runs sequence-parallel: the clip's frames are cut over
    the 'seq' ranks, so one long utterance uses the whole mesh.  ``model``
    must be built with ``sp_model_config`` then, and every rank of the
    mesh must iterate the same clips in the same order (the ranks meet in
    collectives inside each forward); every rank yields the same scores.

    Yields (utt_id, score, bucket frame count) in input order.  Spans
    (``train/profiling.py``), keyed by the utterance id: ``sls.tile``,
    ``sls.upload``, ``sls.dispatch``, ``sls.fetch``."""
    dev = resolve_device(device)
    fwd = sp_scoring_fn(model, sp_mesh) if sp_mesh is not None else None
    buckets = length_buckets(enc_cfg, t_targets)
    for utt_id, wav in audio_iter:
        with keyed(utt_id):
            with span("sls.tile"):
                rows, t_bucket = unwindowed_batch(wav, buckets)
            log_probs = _log_probs(model, rows, dev, fwd)
            with span("sls.fetch"):
                scores = log_probs_to_scores(log_probs)
        yield utt_id, float(scores.mean()), t_bucket
