"""Offline scoring in a closed loop: ``train/loop.py::produce_scores`` over
the family's eval step, fed by ``data/pipeline.py::ArrayLoader`` batches
of a seeded pool of utterances on the wire, the pool cycled until the
window closes.  This is how a score file of a trial list is made.

params: ``batch``, ``pool`` (utterances, a multiple of ``batch``),
``samples`` a row, ``wire`` (``int16``), ``check_rows`` (rows of the
window held to the reference).

End to end: ``score_utts_per_s``, every line written over the window,
from its start to ``produce_scores``' return (the last fetch done).
Compared: the log-probabilities that the window's eval steps returned,
for ``check_rows`` rows drawn from the seed, against the plain
reference's on the same rows: ``logp_gap``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench import audio, compare, flops
from perfbench.run import Outcome


class CyclingLoader:
    """``ArrayLoader`` epochs, one after another, until ``deadline``; the
    pool indices of every batch yielded, in order."""

    def __init__(self, loader, deadline: float, run):
        self.loader, self.deadline, self.run = loader, deadline, run
        self.indices: List[np.ndarray] = []

    def epoch(self, _epoch: int = 0):
        e = 0
        while True:
            batches = self.loader.epoch(e)
            while True:
                if time.perf_counter() >= self.deadline:
                    return
                with self.run.span("loader_next"):
                    batch = next(batches, None)
                if batch is None:
                    break
                self.indices.append(np.asarray([int(u[1:]) for u in batch.utt_ids]))
                yield batch
            e += 1


def run(r) -> Outcome:
    from sls_tpu_torch.data.pipeline import ArrayLoader
    from sls_tpu_torch.train.loop import produce_scores

    p = r.params
    batch, n = p["batch"], p["pool"]
    with r.span("inputs"):
        pool = audio.int16_rows(r.seed, 1, n, p["samples"], r.device)
    if (r.control or {}).get("reference"):
        # the control: the reference in its lower precision, in the
        # program's place, on rows drawn as a window's would be
        rows = compare.sample(r.seed, n, p["check_rows"])
        lp = compare.reference_log_probs(r, rows_of(pool, rows), r.control["reference"])
        return Outcome(0, 0, {}, {"pool": pool, "rows": rows, "log_probs": lp})
    model = r.family.build(r)
    step = r.family.eval_step(model, r.device)
    arrays = ArrayLoader(pool, None, utt_ids=[f"u{i}" for i in range(n)], batch_size=batch)
    kept: list = []
    enqueue: list = []
    work = {"flops": batch * flops.forward(r.cell.config, p["samples"])}
    wrapped = r.wrap(step, "eval_step", keep=kept, enqueue=enqueue,
                     counts=lambda: work)
    for _ in range(2):  # the one shape the window uses
        step(pool[:batch])
    t0 = r.end_setup()
    loader = CyclingLoader(arrays, t0 + r.seconds, r)
    with r.span("produce_scores"):
        lines = produce_scores(wrapped, loader, r.tmp / "scores.txt")
    t1 = time.perf_counter()
    r.counters["enqueue_s"] = enqueue
    rows = np.concatenate(loader.indices)
    pick = compare.sample(r.seed, len(rows), p["check_rows"])
    lp = torch.cat([out["log_probs"].float().cpu() for out in kept]).numpy()
    attempted = len(rows)
    return Outcome(attempted=attempted, failed=attempted - lines,
                   e2e={"score_utts_per_s": lines / (t1 - t0)},
                   check_data={"pool": pool, "rows": rows[pick], "log_probs": lp[pick]})


def rows_of(pool: np.ndarray, rows: np.ndarray) -> torch.Tensor:
    """Pool rows as float audio (exact: the int16 wire over 32768)."""
    return torch.from_numpy(pool[rows].astype(np.float32) / 32768.0)


def check(r, data) -> dict:
    ref = compare.reference_log_probs(r, rows_of(data["pool"], data["rows"]))
    return compare.held(r, compare.logp_numbers(data["log_probs"], ref))
