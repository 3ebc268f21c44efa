"""Sequence parallelism: one clip's frames cut across ranks, for
long-context (unwindowed) scoring and for training, counterpart of
``sls_tpu/parallel/sequence.py``.

A ``('data', 'seq')`` mesh of ranks (``sp_mesh``), ``XLSRConfig.seq_axis
= 'seq'`` (``sp_model_config``), and the mesh handed to the model: by a
scoring function (``sp_scoring_fn``), or by the train and eval steps
(``train/steps.py::make_train_step`` / ``make_eval_step`` with
``mesh=``, and ``Trainer(..., mesh=)``).  The reference only annotates
and lets its compiler derive the program, the backward included; the
port writes the program out, one process per rank:

- the conv front-end, projection and pos-conv run on the whole clip on
  every rank (O(T), and a halo exchange through seven strided convs buys
  nothing at these sizes);
- the transformer layers run on each rank's chunk of frames; LayerNorm
  and the FFN are row-parallel in T, attention all-gathers keys and
  values over the 'seq' group once a layer; at eval, where the strips
  divide evenly, it runs the hand-written long-T kernel on its q strip
  (``kernels/attention.py::sp_flash_attention_long``), else, and always
  in training, the einsum path;
- the per-timestep SAE is row-parallel; the window variants reduce over
  frames, so the features are gathered over 'seq' before them (a halo
  exchange of one window would move less: a later refinement);
- the head's mean-pool is a local sum, one all-reduce over 'seq', and a
  division by the global T.

Scoring: every rank of a mesh is handed the same waveforms in the same
order and holds the same weights (``sp_scoring_fn`` checks that once);
rows cut over 'data' are gathered at the end, so every rank returns every
row's log-probs.

Training: each rank is handed its data coordinate's rows (the
data-parallel step's convention) and the model cuts frames only.  The
gathers and sums over 'seq' are differentiable (``parallel/mesh.py::
SeqShard``), their backward summing the seq ranks' gradients, so each
rank's loss is its share of the global one and one all-reduce over the
mesh sums the gradient.  A term computed whole on every seq rank after a
reduction over 'seq' (the head's NLL, the window variants' SAE and CPC
losses) enters each rank's share at 1 / n_seq; a sum over this rank's
frames (the per-timestep SAE loss) enters as it is; the front-end's
gradient reaches each rank through its own frames only, and the sum
over the mesh makes it whole.  Dropout masks are drawn at the whole T
and cut, so a sequence-parallel step draws what the unsharded step
draws on the same rows.  No Pallas kernel runs in the reference's
sequence-parallel train step, and no hand-written kernel here.

Like every layout knob ``seq_axis`` changes no result beyond summation
order; ``tests/test_torch_sequence_parallel.py`` holds the scores to the
single-process program and to the JAX package's sequence-parallel one,
``tests/test_torch_sp_train.py`` the train step's loss terms, scores and
every gradient to the one-process and data-parallel steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sls_tpu_torch.parallel.distributed import allgather_rows, process_count
from sls_tpu_torch.parallel.mesh import Mesh, make_mesh


def sp_mesh(n_seq: int, n_data: int = 1) -> Mesh:
    """('data', 'seq') mesh: n_data x n_seq over the first ranks of the
    job.  Every rank of the job must make the call."""
    if n_data * n_seq > process_count():
        raise ValueError(
            f"dp{n_data} x sp{n_seq} needs {n_data * n_seq} ranks, have {process_count()}")
    return make_mesh(("data", "seq"), shape=(n_data, n_seq), ranks=range(n_data * n_seq))


def sp_model_config(model_cfg, axis: str = "seq"):
    """ModelConfig adjusted for sequence-parallel execution.

    Sets ``encoder.seq_axis`` and clears ``encoder.fused_frontend`` and
    ``sae.use_pallas``, as the reference does, where the cleared flags
    are a limit of its compiler (a Pallas call does not shard through
    it).  In the port the cleared ``use_pallas`` keeps the SAE on the
    reference's plain route; the cleared ``fused_frontend`` only keeps the
    CPU's front-end on the reference's route, since on a card the eval
    front-end takes its kernel whatever the flag says (it runs on the
    whole clip on every rank, before the cut).  The long-T attention
    kernel stays on at eval: the encoder runs it per strip
    (``sp_flash_attention_long``) where the layout divides evenly; the
    train route never calls it."""
    enc = model_cfg.encoder
    if enc.seq_axis != axis or enc.fused_frontend:
        model_cfg = dataclasses.replace(
            model_cfg, encoder=dataclasses.replace(enc, seq_axis=axis, fused_frontend=False))
    if getattr(model_cfg, "sae", None) is not None and model_cfg.sae.use_pallas:
        model_cfg = dataclasses.replace(
            model_cfg, sae=dataclasses.replace(model_cfg.sae, use_pallas=False))
    return model_cfg


def weights_checksum(model: torch.nn.Module) -> np.ndarray:
    """[sum, sum of squares] over every parameter, in float64."""
    with torch.no_grad():
        sums = [torch.stack([p.double().sum(), p.double().square().sum()])
                for p in model.parameters()]
        return torch.stack(sums).sum(0).cpu().numpy()


def sp_scoring_fn(model, mesh: Mesh):
    """``fwd(wav) -> log_probs [B, 2]`` (a tensor on the model's device)
    running sequence-parallel on ``mesh``.  The reference's returns
    P(bonafide); the port's scorers take the log-probs through the score
    contract themselves (``scores/writer.py::log_probs_to_scores``).

    ``model.config.encoder.seq_axis`` must name an axis of ``mesh`` (use
    ``sp_model_config``).  Every rank of the job calls this (it compares
    the ranks' weights, a collective) and then calls ``fwd`` with the same
    waveforms, float32 ``[B, S]`` on the model's device, in the same
    order; every rank gets every row's log-probs."""
    axis = model.config.encoder.seq_axis
    if not axis or axis not in mesh.axis_names:
        raise ValueError(
            f"model seq_axis={axis!r} is not an axis of mesh "
            f"{mesh.axis_names}; build the config with sp_model_config()")
    sums = allgather_rows(weights_checksum(model)[None, :])
    if not np.all(sums == sums[0]):
        raise ValueError(f"the ranks hold different weights: checksums {sums.tolist()}")

    def fwd(wav: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.score(wav, mesh=mesh)

    return fwd
