"""Rank functions for ``parallel/launch.py``: what one rank of a
multi-process scoring job does.  They live here, not beside their
callers, because spawned ranks import them by module path.  Arguments
and results are plain picklable values (configs, numpy arrays, lists).

- ``sp_score_rank``: sequence-parallel scoring jobs on one or more
  meshes of the job's ranks, with the kernel launch counts of each.
- ``produce_scores_rank``: this rank's shard of a score file.
- ``collectives_rank``: every host-array helper of
  ``parallel/distributed.py`` once, for the tests.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.evaluation.overlap import score_utterances_unwindowed
from sls_tpu_torch.kernels import attention, frontend, sae_kernels
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import distributed as dist
from sls_tpu_torch.parallel.mesh import SeqShard
from sls_tpu_torch.parallel.sequence import sp_mesh, sp_scoring_fn
from sls_tpu_torch.train.loop import produce_scores
from sls_tpu_torch.train.steps import make_eval_step


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count in this process, by name."""
    return {name: fn.launches
            for module in (sae_kernels, attention, frontend)
            for name, fn in vars(module).items()
            if callable(fn) and hasattr(fn, "launches")}


def _delta(before: Mapping[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def build_model(model_cfg, weights: Mapping, device: torch.device) -> Detector:
    """The rank's Detector: ``{"seed": s}`` draws the weights on the
    device from seed ``s`` (the same on every rank of one device type),
    ``{"state": {name: array}}`` loads them."""
    if "seed" in weights:
        gen = torch.Generator(device=device).manual_seed(int(weights["seed"]))
        return Detector(model_cfg, device=device, generator=gen)
    model = Detector(model_cfg, device=device)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in weights["state"].items()}, strict=True)
    return model


def sp_score_rank(models: Sequence[Tuple], device_type: str,
                  meshes: Sequence[Tuple[int, int]], jobs: Sequence[Mapping]) -> List[Dict]:
    """Run ``jobs`` sequence-parallel; returns one result dict a job.

    ``models`` lists (``sp_model_config``, weights as ``build_model``
    takes them) and ``meshes`` (n_seq, n_data) of the meshes to build
    over the job's ranks; a job names one of each by index (``"model"``,
    ``"mesh"``, default 0).  A job's ``"kind"`` is one of the names below
    or a module-level function ``fn(job, model, mesh, device) -> dict``
    of the caller's (a measurement, say), run under ``inference_mode``:

    - ``"forward"`` (``wav`` [B, S]): ``log_probs`` and ``sae_loss`` of
      ``Detector.forward``;
    - ``"unwindowed"`` (``clips`` [(utt, wav)], ``t_targets``):
      ``scores`` [(utt, score, bucket)] of ``score_utterances_unwindowed``
      and ``per_clip`` launch counts;
    - ``"encoder"`` (``wav``): the encoder's output, gathered over the
      mesh, as ``features`` on rank 0 (None elsewhere);
    - ``"attention"`` (``q``, ``k``, ``v`` [B, T, C] float32, ``dtype``,
      ``num_heads``): ``sp_flash_attention_long`` on this rank's shards
      of the arrays rounded to ``dtype``, gathered, as ``out`` (float32)
      on rank 0.

    Every result carries ``launches`` (kernel launches during the job, by
    wrapper) and ``sp_calls``: how often the job took the
    ``sp_flash_attention_long`` route, its launches plus the calls that
    reached its plain version (the CPU's route)."""
    device = dist.local_device(device_type)
    built_models = [build_model(cfg, weights, device) for cfg, weights in models]
    built_meshes = [sp_mesh(n_seq, n_data) for n_seq, n_data in meshes]
    unknown = [job["kind"] for job in jobs
               if not callable(job["kind"]) and job["kind"] not in _JOBS]
    if unknown:
        raise ValueError(f"unknown job kind(s) {unknown}; known: {sorted(_JOBS)}")
    plain, plain_calls = attention.sp_flash_attention_long_plain, [0]

    def counted_plain(*args, **kwargs):
        plain_calls[0] += 1
        return plain(*args, **kwargs)

    out = []
    for job in jobs:
        model, mesh = built_models[job.get("model", 0)], built_meshes[job.get("mesh", 0)]
        run = job["kind"] if callable(job["kind"]) else _JOBS[job["kind"]]
        before, plain_before = launch_counts(), plain_calls[0]
        with mock.patch.object(attention, "sp_flash_attention_long_plain", counted_plain), \
                torch.inference_mode():
            res = run(job, model, mesh, device)
        res["launches"] = _delta(before)
        res["sp_calls"] = (res["launches"]["sp_flash_attention_long"]
                           + plain_calls[0] - plain_before)
        out.append(res)
    return out


def _wav(job: Mapping, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(job["wav"], np.float32)).to(device)


def _gathered_on_primary(shard: SeqShard, x: torch.Tensor) -> Optional[np.ndarray]:
    x = shard.gather_rows(shard.gather_frames(x.float()))
    return x.cpu().numpy() if dist.is_primary() else None


def _forward_job(job, model, mesh, device) -> Dict:
    full = model(_wav(job, device), mesh=mesh)
    return {"log_probs": full["log_probs"].cpu().numpy(), "sae_loss": float(full["sae_loss"])}


def _unwindowed_job(job, model, mesh, device) -> Dict:
    res: Dict = {"scores": [], "per_clip": []}
    seen = launch_counts()
    for item in score_utterances_unwindowed(
            model, iter(job["clips"]), model.config.encoder,
            t_targets=tuple(job["t_targets"]), sp_mesh=mesh, device=device):
        res["scores"].append(item)
        res["per_clip"].append(_delta(seen))
        seen = launch_counts()
    return res


def _encoder_job(job, model, mesh, device) -> Dict:
    wav = _wav(job, device)
    shard = model.encoder.shard_for(wav, mesh)
    return {"features": _gathered_on_primary(shard, model.encoder(wav, shard=shard))}


def _attention_job(job, model, mesh, device) -> Dict:
    dtype = getattr(torch, job["dtype"])
    q, k, v = (torch.from_numpy(np.asarray(job[n], np.float32)).to(device, dtype)
               for n in ("q", "k", "v"))
    shard = SeqShard(mesh, "seq", q.shape[0], q.shape[1])
    q, k, v = (shard.take_frames(shard.take_rows(x)).contiguous() for x in (q, k, v))
    out = attention.sp_flash_attention_long(q, k, v, int(job["num_heads"]), shard.seq_group)
    return {"out": _gathered_on_primary(shard, out)}


_JOBS = {"forward": _forward_job, "unwindowed": _unwindowed_job, "encoder": _encoder_job,
         "attention": _attention_job}


def produce_scores_rank(model_cfg, weights: Mapping, device_type: str, wire: np.ndarray,
                        utt_ids: Sequence[str], batch_size: int, out_path: str) -> Dict:
    """Score this rank's ``host_shard`` of the set into its part of
    ``out_path`` (``produce_scores`` merges the parts); returns the global
    ``count``, this rank's ``local`` count and its kernel ``launches``."""
    device = dist.local_device(device_type)
    model = build_model(model_cfg, weights, device)
    loader = ArrayLoader(wire, None, list(utt_ids), batch_size).host_shard(
        dist.process_index(), dist.process_count())
    step = make_eval_step(model, device=device)
    before = launch_counts()
    count = produce_scores(step, loader, out_path)
    return {"count": count, "local": len(loader.wavs), "launches": _delta(before)}


def collectives_rank(tmp_dir: str) -> Dict:
    """What this rank sees of each host-array helper: a ragged gather of
    ``rank + 1`` rows, a sum of scalars, the part-file names, a merge of
    complete parts, and a merge with one part missing (the error must
    reach every rank)."""
    rank, n = dist.process_index(), dist.process_count()
    res: Dict = {"rank": rank, "count": n, "primary": dist.is_primary()}
    res["rows"] = dist.allgather_rows(np.full((2, 3), rank, np.float32))
    res["ragged"] = dist.allgather_ragged_rows(np.full((rank + 1, 2), rank, np.int64))
    res["sum"] = dist.allreduce_sum_scalars([1.0, float(rank)])
    out = os.path.join(tmp_dir, "merged.txt")
    res["part"] = os.path.basename(dist.part_path(out))
    with open(dist.part_path(out), "w") as f:
        f.write(f"line of rank {rank}\n")
    dist.merge_part_files(out)
    with open(out) as f:
        res["merged"] = f.read()
    res["parts_left"] = sorted(p for p in os.listdir(tmp_dir) if p.startswith("merged.txt.part"))
    lost = os.path.join(tmp_dir, "lost.txt")
    if rank != n - 1:  # the last rank writes no part
        with open(dist.part_path(lost), "w") as f:
            f.write("x\n")
    try:
        dist.merge_part_files(lost)
        res["missing_part_error"] = None
    except FileNotFoundError as e:
        res["missing_part_error"] = str(e)
    return res
