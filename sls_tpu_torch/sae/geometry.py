"""Geometric median for SAE initialisation, counterpart of
``sls_tpu/sae/geometry.py`` (the reference's Weiszfeld routine for
median-initialising ``b_dec`` from a sample of features)."""

from __future__ import annotations

import torch


def geometric_median(points, max_iter: int = 100, tol: float = 1e-5) -> torch.Tensor:
    """Weiszfeld iteration for the geometric median of [N, D] points, fp32,
    from their mean: each step reweights the points by 1 / max(distance,
    1e-12); it stops after ``max_iter`` steps or once a step moves the
    guess by less than ``tol`` (L2), whichever comes first."""
    pts = torch.as_tensor(points).float()
    guess = pts.mean(dim=0)
    for _ in range(max_iter):
        dists = torch.linalg.vector_norm(pts - guess, dim=1)
        weights = 1.0 / torch.clamp(dists, min=1e-12)
        weights = weights / weights.sum()
        new = (weights[:, None] * pts).sum(dim=0)
        moved = float(torch.linalg.vector_norm(new - guess))
        guess = new
        if moved < tol:
            break
    return guess
