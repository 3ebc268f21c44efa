"""Training: the family's trainer (``train/loop.py::BaseTrainer.train_epoch``
over the family's train step) fed by ``ArrayLoader`` epochs of in-memory
crops on the wire, one epoch after another until the window closes.

params: ``batch``, ``pool`` (crops, a multiple of ``batch``: one epoch),
``samples`` a crop, ``bonafide_share`` ([bonafide, spoof] counts whose
ratio the pool's labels keep), ``checked_steps``; the workload's
``recipe`` gives the ``TrainConfig`` fields.

Set-up builds the trainer (model, optimizer state) and drives it through
``checked_steps`` steps, each a one-batch ``train_epoch`` on rows of its
own, then hands the same trainer to the window.  End to end:
``train_utts_per_s``, the utterances of every epoch finished over the
window, from its start to the end of the last epoch (each epoch ends in
the trainer's one fetch).  Compared, against the plain reference's steps
from the same weights on the same rows: each checked step's loss
(``loss_gap``), the first gradient as Adam takes it, read back from the
first moment (``grad1_gap``), and the parameters' change over the
checked steps (``change_gap``), both by the worst leaf.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import audio, compare, flops
from perfbench.reference import train as ref_train
from perfbench.reference.numerics import Ops, no_tf32
from perfbench.run import Outcome

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by rounding alone: its change is not compared
ROUNDING_GRAD = 1e-3


def labels_of(seed: int, n: int, share) -> np.ndarray:
    bonafide = int(round(n * share[0] / (share[0] + share[1])))
    labels = np.zeros(n, np.int64)
    labels[:bonafide] = 1
    return np.random.default_rng((seed % (2 ** 63), 11)).permutation(labels)


def leaf_norms(state, flat: torch.Tensor, names: List[str], leaf_name) -> Dict[str, float]:
    """Each parameter's slice of a flat buffer, its norm, by reference name."""
    sizes = [p.numel() for p in state.params]
    norms = torch.stack([torch.linalg.vector_norm(t) for t in flat.split(sizes)]).cpu()
    return {leaf_name(n): float(v) for n, v in zip(names, norms)}


def checked_batches(r, pool, labels):
    b = r.params["batch"]
    return [(torch.from_numpy(pool[s * b:(s + 1) * b].astype(np.float32) / 32768.0),
             torch.from_numpy(labels[s * b:(s + 1) * b]))
            for s in range(r.params["checked_steps"])]


def reference_steps(r, batches, precision: str) -> Dict:
    from perfbench import weights

    state = weights.make_state(r.cell.config, r.seed, r.device)
    recipe = r.cell.workload["recipe"]
    with no_tf32():
        out = ref_train.run_steps(
            r.family.reference_train_forward(r.cell.config, Ops(precision)), state,
            [(w.to(r.device), y.to(r.device)) for w, y in batches], recipe["lr"],
            recipe["weight_decay"], recipe["loss_weights"])
    del state
    return out


def run(r) -> Outcome:
    from sls_tpu_torch.data.pipeline import ArrayLoader

    p, recipe = r.params, r.cell.workload["recipe"]
    b, n = p["batch"], p["pool"]
    labels = labels_of(r.seed, n, p["bonafide_share"])
    with r.span("inputs"):
        pool = audio.int16_rows(r.seed, 2, n, p["samples"], r.device)
    batches = checked_batches(r, pool, labels)
    if (r.control or {}).get("reference"):
        # the control: the reference in its lower precision, in the
        # program's place; no window
        program = reference_steps(r, batches, r.control["reference"])
        return Outcome(0, 0, {}, {"batches": batches, "program": program})
    trainer = r.family.build_trainer(r, recipe)
    enqueue: list = []
    work = {"flops": b * flops.train_step(r.cell.config, p["samples"])}
    outputs: list = []
    trainer.train_step = r.wrap(trainer.train_step, "train_step", enqueue=enqueue,
                                counts=lambda: work, keep=outputs)
    st, names, leaf = trainer.state, trainer.state.names, r.family.leaf_name
    start = torch.cat([q.detach().reshape(-1) for q in st.params])
    losses, grad1 = [], {}
    for s in range(p["checked_steps"]):
        rows = slice(s * b, (s + 1) * b)
        losses.append(trainer.train_epoch(ArrayLoader(pool[rows], labels[rows], batch_size=b),
                                          s).loss)
        if s == 0:
            grad1 = leaf_norms(st, trainer.state.exp_avg / (1.0 - ref_train.B1), names, leaf)
    now = torch.cat([q.detach().reshape(-1) for q in st.params])
    change = leaf_norms(st, now - start, names, leaf)
    del start, now
    # each checked step's P(bonafide) a row, as its metrics return them
    scores = torch.cat([m["scores"].double().cpu() for _, m in outputs]).numpy()
    outputs.clear()
    enqueue.clear()
    loader = ArrayLoader(pool, labels, batch_size=b, shuffle=True, seed=r.seed % (2 ** 32))
    t0 = r.end_setup()
    epoch, done = p["checked_steps"], 0
    while time.perf_counter() < t0 + r.seconds:
        with r.span("train_epoch"):
            trainer.train_epoch(loader, epoch)
        done += n
        epoch += 1
    t1 = time.perf_counter()
    r.counters["enqueue_s"] = enqueue
    return Outcome(attempted=done, failed=0, e2e={"train_utts_per_s": done / (t1 - t0)},
                   check_data={"batches": batches, "program": {
                       "losses": losses, "grad1": grad1, "change": change,
                       "log_probs": compare.log_probs_of_scores(scores)}})


def check(r, data) -> dict:
    ref = reference_steps(r, data["batches"], "fp32")
    rounded = reference_steps(r, data["batches"], "bf16")
    prog = data["program"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_at = compare.norm_gap(prog["grad1"], ref["grad1"])
    median = float(np.median(list(ref["grad1_raw"].values())))
    moved = [k for k, v in ref["grad1_raw"].items() if v >= ROUNDING_GRAD * median]
    change_gap, change_at = compare.norm_gap(prog["change"], ref["change"], moved)
    print(f"train check: losses {prog['losses']} against {ref['losses']}", file=sys.stderr)
    print(f"train check: worst grad1 leaf {grad_at}, worst change leaf {change_at}; "
          f"{len(ref['change']) - len(moved)} leaves left out of the change", file=sys.stderr)
    changes = sorted(compare.norm_gap(prog["change"], ref["change"], [k])[0] for k in moved)
    loss_env = (max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
                / max(abs(a - b) for a, b in zip(rounded["losses"], ref["losses"])))
    return compare.held(r, {"loss_gap": loss_gap, "grad1_gap": grad_gap, "change_gap": change_gap,
                            "median_change_gap": changes[len(changes) // 2],
                            "loss_env": loss_env,
                            "logp_env": compare.envelope_rms(prog["log_probs"], ref["log_probs"],
                                                             rounded["log_probs"])})
