"""Whole long clips, one forward a clip: ``evaluation/overlap.py::
score_utterances_unwindowed`` over the family's model, one clip at a time
in input order, as ``cli.main --is_eval --full_utterance --unwindowed``
scores a list.  The pool's clip lengths are spread evenly over
[``min_s``, ``max_s``] seconds (the same lengths for every seed, in an
order drawn from it); the pool is cycled until the window closes.  The
lengths follow no published length mix: they are chosen to fill the
frame buckets that the long-T attention kernel serves.

params: ``min_s``, ``max_s``, ``pool`` (clips), ``t_targets`` (the frame
buckets), ``check_clips``.

End to end: ``long_audio_s_per_s``, the seconds of the clips' own audio
scored over the window, from its start to the last clip's score (each
score is fetched as it comes).  Compared: the scores of ``check_clips``
distinct clips of the pool drawn from the seed, each at one of its
scorings in the window drawn from the seed, as log-probabilities,
against the plain reference's forward over the same tiled rows:
``logp_rms`` and ``logp_gap``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import audio, compare, flops
from perfbench.reference import long_clip
from perfbench.run import Outcome


def lengths(r) -> np.ndarray:
    p = r.params
    secs = np.linspace(p["min_s"], p["max_s"], p["pool"])
    order = np.random.default_rng((r.seed % (2 ** 63), 13)).permutation(p["pool"])
    return np.round(secs[order] * audio.SAMPLE_RATE).astype(np.int64)


def run(r) -> Outcome:
    from sls_tpu_torch.evaluation.overlap import score_utterances_unwindowed

    p, cfg = r.params, r.cell.config
    enc = cfg["encoder"]
    with r.span("inputs"):
        clips = [audio.rows(r.seed, 3 + i, 1, int(n), r.device)[0].cpu().numpy()
                 for i, n in enumerate(lengths(r))]
    if (r.control or {}).get("reference"):
        # the control: the reference in its lower precision, in the
        # program's place, on clips drawn as a window's would be
        pick = compare.sample(r.seed, len(clips), p["check_clips"])
        chosen = [clips[i] for i in pick]
        lp = reference_clips(r, chosen, r.control["reference"])
        return Outcome(0, 0, {}, {"clips": chosen, "scores": np.exp(lp[:, 1])})
    model = r.family.build(r)
    enc_cfg = model.config.encoder
    current: dict = {}
    enqueue: list = []
    model.score = r.wrap(model.score, "forward", enqueue=enqueue, counts=lambda: current)

    def feed(order, deadline=None):
        for i in order:
            if deadline is not None and time.perf_counter() >= deadline:
                return
            t = long_clip.bucket(len(clips[i]), enc, p["t_targets"])
            current.clear()
            current.update({"flops": flops.forward(cfg, len(clips[i])), f"T{t}": 1})
            yield str(i), clips[i]

    by_len = np.argsort([len(c) for c in clips])
    for _ in score_utterances_unwindowed(model, feed([by_len[0], by_len[-1]]), enc_cfg,
                                         p["t_targets"], device=r.device):
        pass  # one forward at each bucket the pool uses
    enqueue.clear()
    t0 = r.end_setup()
    deadline = t0 + r.seconds

    def cycle():
        while True:
            yield from range(len(clips))

    scored, seconds = [], 0.0
    for utt, score, _ in score_utterances_unwindowed(model, feed(cycle(), deadline), enc_cfg,
                                                     p["t_targets"], device=r.device):
        scored.append((int(utt), score))
        seconds += len(clips[int(utt)]) / audio.SAMPLE_RATE
    t1 = time.perf_counter()
    r.counters["enqueue_s"] = enqueue
    pick = one_scoring_each(r.seed, [i for i, _ in scored], p["check_clips"])
    return Outcome(attempted=len(scored), failed=0, e2e={"long_audio_s_per_s": seconds / (t1 - t0)},
                   check_data={"clips": [clips[scored[j][0]] for j in pick],
                               "scores": [scored[j][1] for j in pick]})


def one_scoring_each(seed: int, clip_of: list, k: int) -> list:
    """Positions in the window's scorings (``clip_of``: the pool clip of
    each) of ``k`` distinct clips drawn from the seed, one scoring each,
    drawn from the seed too."""
    rng = np.random.default_rng((seed % (2 ** 63), 7))
    at: dict = {}
    for j, i in enumerate(clip_of):
        at.setdefault(i, []).append(j)
    clips = sorted(at)
    chosen = rng.choice(len(clips), size=min(k, len(clips)), replace=False)
    return sorted(at[clips[c]][rng.integers(len(at[clips[c]]))] for c in chosen)


def reference_clips(r, clips, precision: str = "fp32") -> np.ndarray:
    """[n, 2] log-probabilities of each clip's score by the reference: its
    rows' P(bonafide) averaged (a chunked clip scores its chunks' mean)."""
    enc, targets = r.cell.config["encoder"], r.params["t_targets"]
    out = []
    for wav in clips:
        rows, _ = long_clip.rows(wav, enc, targets)
        lp = compare.reference_log_probs(r, torch.from_numpy(rows), precision)
        out.append(np.log(np.exp(lp).mean(axis=0)))
    return np.stack(out)


def check(r, data) -> dict:
    prog = compare.log_probs_of_scores(data["scores"])
    return compare.held(r, compare.logp_numbers(prog, reference_clips(r, data["clips"])))
