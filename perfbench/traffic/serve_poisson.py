"""Online scoring under open-loop arrivals: ``serve/engine.py::BatchingEngine``
over the family's eval step, single utterances arriving as a Poisson
stream at a fixed rate, whatever the engine's state (independent users).

params: ``rate_per_s``, ``batch``, ``max_wait_ms`` (the engine's, as
``cli.serve`` sets them; the int16 wire), ``pool`` (distinct
utterances), ``samples``, ``check_requests``, ``gap_seed``.  The
inter-arrival gaps are one exponential draw from ``gap_seed``, scaled to
fill the window exactly, so every seed gets the same gaps and the same
number of requests, in an order drawn from its own seed.

End to end: ``serve_p95_ms``, the 95th percentile over every request due
in the window of the time from when it was due to when its score came
back; a request that failed or got no answer within a minute of the
window's close counts as missing every limit.  The submitter's lateness
is printed on standard error.  Compared: the served scores of
``check_requests`` requests drawn from the seed, as log-probabilities,
against the plain reference's forward of their utterances: ``logp_gap``.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np
import torch

from perfbench import audio, compare
from perfbench.run import Outcome

LATE_ANSWER_S = 60.0


def offsets(r) -> np.ndarray:
    """Seconds after the window opens at which each request is due."""
    p = r.params
    n = int(round(p["rate_per_s"] * r.seconds))
    gaps = np.random.default_rng(p["gap_seed"]).exponential(1.0, n)
    gaps = np.random.default_rng((r.seed % (2 ** 63), 17)).permutation(gaps / gaps.sum() * r.seconds)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def percentile(values: np.ndarray, q: float) -> float:
    """The nearest-rank percentile (missing requests are +inf)."""
    ordered = np.sort(values)
    return float(ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)])


def run(r) -> Outcome:
    from sls_tpu_torch.serve.engine import BatchingEngine

    p = r.params
    with r.span("inputs"):
        pool = audio.int16_rows(r.seed, 4, p["pool"], p["samples"], r.device)
    wavs = pool.astype(np.float32) / 32768.0  # exact on the int16 wire
    if (r.control or {}).get("reference"):
        # the control: the reference in its lower precision, in the
        # program's place, on requests drawn as a window's would be
        chosen = wavs[compare.sample(r.seed, len(wavs), p["check_requests"])]
        lp = compare.reference_log_probs(r, torch.from_numpy(chosen), r.control["reference"])
        return Outcome(0, 0, {}, {"wav": chosen, "scores": np.exp(lp[:, 1])})
    model = r.family.build(r)
    step = r.family.eval_step(model, r.device)
    enqueue: list = []
    score_fn = r.wrap(lambda wav: step(wav)["log_probs"], "score_fn",
                      enqueue=enqueue)
    due_at = offsets(r)
    n = len(due_at)
    which = np.random.default_rng((r.seed % (2 ** 63), 19)).integers(0, p["pool"], n)
    done = np.full(n, np.inf)
    sent = np.full(n, np.nan)
    futures = [None] * n
    engine = BatchingEngine(score_fn, p["batch"], cut=p["samples"], max_wait_ms=p["max_wait_ms"],
                            wire_dtype="int16").start()
    try:
        for rows in (wavs[:p["batch"]], wavs[:1]):  # a full batch, and one tiled up to it
            for f in [engine.submit(w) for w in rows]:
                f.result(timeout=600)
        enqueue.clear()
        before = engine.stats()
        t0 = r.end_setup()

        def submit() -> None:
            for i in range(n):
                delay = t0 + due_at[i] - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                sent[i] = time.perf_counter()
                try:
                    with r.span("submit"):
                        fut = engine.submit(wavs[which[i]])
                except RuntimeError:
                    continue
                fut.add_done_callback(lambda f, i=i: done.__setitem__(
                    i, time.perf_counter() if f.exception() is None else np.inf))
                futures[i] = fut

        submitter = threading.Thread(target=submit, name="perfbench-submit")
        submitter.start()
        submitter.join()
        close = t0 + r.seconds + LATE_ANSWER_S
        scores = np.full(n, np.nan)
        for i, fut in enumerate(futures):
            try:
                if fut is not None:
                    scores[i] = fut.result(timeout=max(0.0, close - time.perf_counter()))
            except Exception:  # noqa: BLE001 - a failed or late request is counted missing
                done[i] = np.inf
        after = engine.stats()
    finally:
        engine.stop()
    r.counters["enqueue_s"] = enqueue
    batches = after.batches - before.batches
    if batches:
        r.counters["batch_fill"] = (after.mean_fill * after.batches
                                    - before.mean_fill * before.batches) / batches
    latency_ms = (done - (t0 + due_at)) * 1e3
    late = (sent - (t0 + due_at)) * 1e3
    quarters = [float(np.median(q)) for q in np.array_split(latency_ms, 4)]
    print(f"serve: {n} requests at {p['rate_per_s']}/s; submitter late p50 "
          f"{np.nanmedian(late):.3f} ms, p95 {np.nanpercentile(late, 95):.3f} ms, max "
          f"{np.nanmax(late):.3f} ms; {batches} batches; median latency by quarter of the "
          f"window {quarters} ms", file=sys.stderr)
    ok = np.flatnonzero(np.isfinite(latency_ms) & np.isfinite(scores))
    pick = ok[compare.sample(r.seed, len(ok), p["check_requests"])]
    return Outcome(attempted=n, failed=int(n - len(ok)),
                   e2e={"serve_p95_ms": percentile(latency_ms, 95.0)},
                   check_data={"wav": wavs[which[pick]], "scores": scores[pick]})


def check(r, data) -> dict:
    wav = torch.from_numpy(data["wav"])
    ref = compare.reference_log_probs(r, wav)
    prog = compare.log_probs_of_scores(data["scores"])
    numbers = compare.logp_numbers(prog, ref)
    numbers["logp_env"] = compare.envelope_rms(prog, ref,
                                               compare.reference_log_probs(r, wav, "bf16"))
    return compare.held(r, numbers)
