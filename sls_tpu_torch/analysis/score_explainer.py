"""Walk-through of the discrimination-score math, own copy of
``sls_tpu/analysis/score_explainer.py``.

Equivalent of the reference's explainer scripts
(reference: demo_score_calculation.py, explain_score_calculation.py,
explain_score_meaning.py): simulates the pipeline's score computation on
seeded synthetic sparse features — no model or data required — and
returns every intermediate quantity with prose explanations, so the
"what does score 0.83 mean" question has an executable answer.

Run: ``python -m sls_tpu_torch.analysis.score_explainer``
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def simulate_score_pipeline(
    seed: int = 0, T: int = 201, D: int = 4096, k: int = 128
) -> Dict:
    """End-to-end simulation: sparse codes -> pooling -> logits ->
    log-softmax -> P(bonafide)."""
    rng = np.random.default_rng(seed)

    # seeded random sparse features (what the SAE would emit)
    codes = np.zeros((T, D), np.float32)
    for t in range(T):
        idx = rng.choice(D, k, replace=False)
        codes[t, idx] = rng.uniform(0.1, 2.0, k)

    pooled = codes.mean(axis=0)  # AdaptiveAvgPool1d(1) over time

    # a toy 2-class linear head standing in for LayerNorm/MLP
    w = rng.normal(0, 0.02, (D, 2))
    logits = pooled @ w
    log_probs = logits - np.log(np.exp(logits).sum())
    score = float(np.exp(log_probs[1]))

    return {
        "explanation": [
            "1. The SAE emits k sparse activations per 20 ms frame "
            f"(k={k} of {D} dictionary atoms).",
            "2. Mean-pooling over the ~201 frames gives one "
            f"{D}-dim utterance vector; each entry is the feature's "
            "average strength over the clip.",
            "3. The classifier maps that vector to 2 logits "
            "(class 0 = spoof, class 1 = bonafide).",
            "4. log-softmax normalizes them; the score file stores "
            "exp(log_prob[1]) = P(bonafide).",
            "5. Higher score = more bonafide-like.  EER scoring only uses "
            "the ranking, so any monotone rescaling is equivalent.",
        ],
        "frame_sparsity": float((codes > 0).mean()),
        "pooled_l2": float(np.linalg.norm(pooled)),
        "logits": logits.tolist(),
        "log_probs": log_probs.tolist(),
        "score": score,
        "decision": "bonafide" if score >= 0.5 else "spoof",
    }


def main() -> int:
    out = simulate_score_pipeline()
    for line in out["explanation"]:
        print(line)
    print(f"\nlogits          : {out['logits']}")
    print(f"log-probs       : {out['log_probs']}")
    print(f"P(bonafide)     : {out['score']:.4f} -> {out['decision']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
