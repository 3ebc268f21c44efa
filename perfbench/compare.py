"""The comparisons that decide ``correct``: the numbers compared, and the
reference run over the rows a check samples.

Each number has its limit in the cell's workload file (``limits``), set
from the lower reading (the largest that sound runs of the program give
over a dozen seeds or more) and the upper reading (the smallest that
the cell's control gives), as ``PERF.md`` records.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from perfbench import weights
from perfbench.reference.numerics import Ops, no_tf32

REF_BLOCK = 12  # rows a reference forward takes at once


def sample(seed: int, n: int, k: int, stream: int = 7) -> np.ndarray:
    """``k`` of ``range(n)`` drawn from the seed, in order."""
    rng = np.random.default_rng((seed % (2 ** 63), stream))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def log_probs_of_scores(scores: Iterable[float]) -> np.ndarray:
    """[n, 2] log-probabilities of served P(bonafide): log(1 - s), log s."""
    s = np.asarray(list(scores), np.float64)
    with np.errstate(divide="ignore"):
        return np.stack([np.log1p(-s), np.log(s)], axis=1)


def logp_numbers(program: np.ndarray, reference: np.ndarray) -> Dict[str, float]:
    """The gaps between the program's log-probabilities and the
    reference's over the rows and both classes: the widest
    (``logp_gap``) and their root mean square (``logp_rms``)."""
    gap = np.abs(np.asarray(program, np.float64) - np.asarray(reference, np.float64))
    if not np.all(np.isfinite(gap)):
        return {"logp_gap": float("inf"), "logp_rms": float("inf")}
    return {"logp_gap": float(np.max(gap)), "logp_rms": float(np.sqrt(np.mean(gap ** 2)))}


def envelope_rms(program: np.ndarray, reference: np.ndarray, rounded: np.ndarray) -> float:
    """The program's root-mean-square gap from the reference over the
    reference's own when its products take bfloat16 operands (the
    rounding the configuration states): about 1 for a program that
    computes in that precision, whatever the weights' sensitivity."""
    num = np.sqrt(np.mean((np.asarray(program, np.float64) - reference) ** 2))
    den = np.sqrt(np.mean((np.asarray(rounded, np.float64) - reference) ** 2))
    return float(num / den) if den > 0 else float("inf")


def held(run, numbers: Dict[str, float]) -> Dict[str, Tuple[float, float]]:
    """The numbers that the cell's ``limits`` name, each beside its limit;
    all of them are kept for the record (``run.counters["numbers"]``)."""
    run.counters["numbers"] = dict(numbers)
    return {k: (numbers[k], lim) for k, lim in run.cell.workload["limits"].items()}


def norm_gap(program: Mapping[str, float], reference: Mapping[str, float],
             names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(the worst leaf's gap, its name): |program norm - reference norm|
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = list(reference if names is None else names)
    median = float(np.median([reference[n] for n in names]))
    worst, at = 0.0, ""
    for n in names:
        p = program.get(n, float("nan"))
        gap = abs(p - reference[n]) / max(reference[n], median)
        if not np.isfinite(gap):
            return float("inf"), n
        if gap > worst:
            worst, at = gap, n
    return worst, at


@torch.no_grad()
def reference_log_probs(run, wav: torch.Tensor, precision: str = "fp32") -> np.ndarray:
    """The plain reference's [n, 2] log-probabilities of float audio rows
    ``wav`` (host), on the run's device in blocks, from weights drawn
    again from the seed."""
    state = weights.make_state(run.cell.config, run.seed, run.device)
    fam, ops = run.family, Ops(precision)
    out = []
    with no_tf32():
        for lo in range(0, wav.shape[0], REF_BLOCK):
            block = wav[lo:lo + REF_BLOCK].to(run.device)
            out.append(fam.reference_log_probs(state, run.cell.config, block, ops).cpu())
    del state
    return torch.cat(out).double().numpy()

