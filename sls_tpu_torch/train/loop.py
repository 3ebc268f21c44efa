"""Score-file production, counterpart of ``Trainer.produce_scores`` in
``sls_tpu/train/loop.py``.  The Trainer and checkpoints are not ported
yet (ROADMAP)."""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Union

import numpy as np

from sls_tpu_torch.parallel import distributed as dist
from sls_tpu_torch.scores.writer import ScoreWriter, log_probs_to_scores


def produce_scores(eval_step: Callable, loader, out_path: Union[str, Path]) -> int:
    """Write the ``utt score`` file for every valid row the loader yields;
    returns the number of lines written.

    Multi-process: each process scores its own shard of the set
    (``ArrayLoader.host_shard``) on its own device and writes a part
    file; the primary concatenates the parts in process order, and every
    process returns the global count.  Every process must make the call.

    Depth-2 pipeline: batch N is fetched from the device (and written)
    only after batches N+1 and N+2 are queued, so host batching, device
    compute and score writing overlap."""
    n = 0
    with ScoreWriter(dist.part_path(out_path)) as writer:
        pending = []

        def flush(item) -> None:
            nonlocal n
            utt_ids, valid, out = item
            score = log_probs_to_scores(out["log_probs"])  # waits for the device
            writer.write_batch([u for u, ok in zip(utt_ids, valid) if ok], score[valid])
            n += int(valid.sum())

        for batch in loader.epoch(0):
            out = eval_step(batch.wav)
            pending.append((list(batch.utt_ids), np.asarray(batch.valid, bool), out))
            if len(pending) > 2:
                flush(pending.pop(0))
        for item in pending:
            flush(item)
    dist.merge_part_files(out_path)
    return int(dist.allreduce_sum_scalars([float(n)])[0])
