"""Decision-relevance attribution over SAE features, counterpart of
``sls_tpu/analysis/attribution.py``.

The port's ``Detector.classify_codes`` is the classifier on given codes,
so gradient attribution is one ``torch.autograd.grad`` of the decision
margin (in place of ``jax.grad``), and ablation is a batch of masked
classifier forwards a chunk of features (in place of ``jax.vmap``).
Codes from an ``inference_mode`` forward (``Detector.encode_sae`` there)
are inference tensors, which autograd cannot save, so both functions
take a normal copy of them first.  The cue functions are numpy copies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _codes_on(model, codes) -> torch.Tensor:
    """``codes`` as a normal tensor (never an inference tensor) on the
    model's device."""
    dev = next(model.parameters()).device
    if torch.is_tensor(codes):
        return codes.to(dev).clone()
    return torch.from_numpy(np.ascontiguousarray(codes)).to(dev)


def gradient_attribution(model, codes) -> np.ndarray:
    """d(log P(bonafide) - log P(spoof)) / d codes: [B, T, D], numpy.

    codes: sparse SAE activations [B, T, D] (a tensor on any device, or
    numpy).  The log-probability difference is the decision margin;
    positive attribution pushes toward bonafide."""
    with torch.inference_mode(False), torch.enable_grad():
        c = _codes_on(model, codes).requires_grad_(True)
        logp = model.classify_codes(c)
        (grad,) = torch.autograd.grad((logp[:, 1] - logp[:, 0]).sum(), c)
    return grad.cpu().numpy()


def attribution_scores(model, codes) -> np.ndarray:
    """Per-feature decision relevance: |grad x activation| summed over
    time (gradient times input), [B, D]."""
    grads = gradient_attribution(model, codes)
    c = codes.detach().cpu().numpy() if torch.is_tensor(codes) else np.asarray(codes)
    return np.abs(grads * c).sum(axis=1)


def ablation_attribution(model, codes, feature_ids, batch_features: int = 256) -> np.ndarray:
    """Causal attribution: zero feature d at every frame and measure the
    drop in P(bonafide).  Returns [B, len(feature_ids)], numpy.

    A chunk of F features is one classifier forward over F masked copies
    of ``codes``, which takes F x B x T x D x 4 bytes on the device (20
    features of 100 flagship utterances, the analysis CLI's defaults:
    20 x 100 x 201 x 4096 x 4 = 6.6 GB); ``batch_features`` caps F."""
    with torch.no_grad():
        c = _codes_on(model, codes)
        base_p = torch.exp(model.classify_codes(c)[:, 1])
        ids = torch.as_tensor(np.asarray(feature_ids), dtype=torch.long, device=c.device)
        deltas = []
        for lo in range(0, len(ids), batch_features):
            chunk = ids[lo:lo + batch_features]
            keep = 1.0 - torch.nn.functional.one_hot(chunk, c.shape[-1]).to(c.dtype)  # [F, D]
            masked = c[None] * keep[:, None, None, :]  # [F, B, T, D]
            logp = model.classify_codes(masked.reshape(-1, *c.shape[1:]))
            p = torch.exp(logp[:, 1]).reshape(len(chunk), c.shape[0])
            deltas.append((base_p[None, :] - p).cpu())
            del masked
    return torch.cat(deltas, dim=0).T.numpy()


def top_k_cues(scores: np.ndarray, k: int = 20) -> np.ndarray:
    """Indices of the k most decision-relevant features per sample."""
    return np.argsort(-scores, axis=-1)[:, :k]


def cue_jaccard_stability(cues_a: np.ndarray, cues_b: np.ndarray) -> float:
    """Mean Jaccard overlap between two top-k cue sets per sample
    (reference: DecisionCueStabilityAnalyzer,
    analyze_decision_relevance.py:164)."""
    sims = []
    for a, b in zip(cues_a, cues_b):
        sa, sb = set(a.tolist()), set(b.tolist())
        union = len(sa | sb)
        sims.append(len(sa & sb) / union if union else 1.0)
    return float(np.mean(sims))


def within_class_cue_consistency(
    cues: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Average pairwise cue overlap within bonafide and spoof groups
    (reference: CueConsistencyAnalyzer,
    analyze_decision_relevance.py:324)."""

    def group_overlap(group: np.ndarray) -> float:
        if len(group) < 2:
            return 1.0
        sets = [set(c.tolist()) for c in group]
        sims = []
        for i in range(len(sets)):
            for j in range(i + 1, len(sets)):
                union = len(sets[i] | sets[j])
                sims.append(len(sets[i] & sets[j]) / union if union else 1.0)
        return float(np.mean(sims))

    labels = np.asarray(labels)
    n_pair = int(min((labels == 1).sum(), (labels == 0).sum()))
    return {
        "bonafide_consistency": group_overlap(cues[labels == 1]),
        "spoof_consistency": group_overlap(cues[labels == 0]),
        # single-class inputs have no cross-class pairs: report 0.0
        # rather than np.mean([]) = NaN leaking into JSON reports
        "cross_class_overlap": (
            cue_jaccard_stability(
                cues[labels == 1][:n_pair], cues[labels == 0][:n_pair]
            )
            if n_pair > 0
            else 0.0
        ),
    }
