"""Plain train steps: the published recipe's loss and optimizer over a
detector's plain forward, in float32 (or the control's precision).

Loss: ``CrossEntropyLoss(weight=(0.1, 0.9))`` on the model's
log-probabilities, which is their weighted NLL (log_softmax of a
log_softmax changes nothing).  Optimizer: ``torch.optim.Adam(lr,
weight_decay)``: the decay added to the gradient before the moments, b1
0.9, b2 0.999, eps 1e-8.  The trained leaves are every parameter, the
positional conv as its folded weight (``xlsr.encoder_params``); the
BatchNorm's running statistics are no leaves.  This file imports nothing
of the program under test.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from perfbench.reference import xlsr

B1, B2, EPS = 0.9, 0.999, 1e-8
RUNNING = ("first_bn.running_mean", "first_bn.running_var")


def weighted_nll(log_probs: torch.Tensor, labels: torch.Tensor,
                 weights: Sequence[float]) -> torch.Tensor:
    w = torch.as_tensor(weights, dtype=torch.float32, device=log_probs.device)[labels]
    picked = log_probs.gather(1, labels[:, None])[:, 0]
    return -(w * picked).sum() / w.sum()


def leaves(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trained tensors, float32 copies, named as the reference names
    them (the encoder's without ``ssl_model.model.``)."""
    out = {k: v.detach().clone().requires_grad_(True)
           for k, v in xlsr.encoder_params(state).items()}
    for k, v in state.items():
        if not k.startswith(xlsr.FAIRSEQ) and k not in RUNNING:
            out[k] = v.detach().float().clone().requires_grad_(True)
    return out


def run_steps(forward: Callable, state: Mapping[str, torch.Tensor],
              batches: List[Tuple[torch.Tensor, torch.Tensor]], lr: float, weight_decay: float,
              class_weights: Sequence[float]) -> Dict:
    """Adam steps over ``batches`` ((float audio, labels) each), from the
    weights of ``state``.  ``forward(state, leaves, wav) -> log_probs``
    runs the model on the current leaves.  Returns each step's loss, each
    leaf's norm of the first gradient with the decay added (what Adam's
    moments take) and of the raw gradient, and of its change over all
    the steps, as floats by leaf name, and every step's [rows, 2]
    log-probabilities, stacked."""
    p = leaves(state)
    names = list(p)
    start = {n: t.detach().clone() for n, t in p.items()}
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    losses, first, first_raw, log_probs = [], {}, {}, []
    for step, (wav, labels) in enumerate(batches, start=1):
        lp = forward(state, p, wav)
        log_probs.append(lp.detach().double().cpu())
        loss = weighted_nll(lp, labels, class_weights)
        grads = torch.autograd.grad(loss, [p[n] for n in names], allow_unused=True)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = torch.zeros_like(p[n]) if g is None else g
                if step == 1:
                    first_raw[n] = float(torch.linalg.vector_norm(g))
                g = g + weight_decay * p[n]
                if step == 1:
                    first[n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(B1).add_(g, alpha=1 - B1)
                v[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                mhat = m[n] / (1 - B1 ** step)
                vhat = v[n] / (1 - B2 ** step)
                p[n].add_(mhat / (vhat.sqrt() + EPS), alpha=-lr)
        del grads, loss
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n])) for n in names}
    return {"losses": losses, "grad1": first, "grad1_raw": first_raw, "change": change,
            "log_probs": torch.cat(log_probs).numpy()}
