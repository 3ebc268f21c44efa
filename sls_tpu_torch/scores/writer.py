"""Score-file emission: the ``utt_id score`` contract (own copy of
``sls_tpu/scores/writer.py``).  Lines are ``<utt_id> <float>`` with the
float P(bonafide); writes are flushed per batch so a killed job leaves a
usable prefix."""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]


def log_probs_to_scores(log_probs) -> np.ndarray:
    """The score contract: P(bonafide) = exp(min(log_probs, 0))[:, 1],
    exponentiated in float64 so confident trials do not collapse into
    float32 ties; the clamp keeps scores in [0, 1] where a float32
    log-softmax rounds to a tiny positive value.  Accepts a tensor on
    any device (fetched here) or an array."""
    if hasattr(log_probs, "detach"):
        log_probs = log_probs.detach().cpu().numpy()
    logp = np.asarray(log_probs)
    return np.exp(np.minimum(logp, 0.0).astype(np.float64))[:, 1]


class ScoreWriter:
    """Incremental score-file writer with per-batch flush."""

    def __init__(self, path: PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "w")
        self.count = 0

    def write_batch(self, utt_ids: Sequence[str], scores: Iterable[float]) -> None:
        for utt_id, score in zip(utt_ids, scores):
            self._fh.write(f"{utt_id} {float(score)}\n")
            self.count += 1
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "ScoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_score_file(path: PathLike) -> Tuple[List[str], np.ndarray]:
    """Read a score file back into (utt_ids, scores)."""
    utt_ids: List[str] = []
    scores: List[float] = []
    with open(path, "r") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            fields = line.split()
            if len(fields) != 2:
                raise ValueError(f"{path}: malformed score line: {line!r}")
            utt_ids.append(fields[0])
            scores.append(float(fields[1]))
    return utt_ids, np.asarray(scores, dtype=np.float64)
