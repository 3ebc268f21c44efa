#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``sls_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # one card; exits nonzero without one
    python3 chip_smoke.py --device cpu    # rehearsal: tiny size, plain versions

Phases:
  1. device and build: the card's name and power limit, the torch / CUDA
     versions and TF32 flags (both off), and the nvcc build of every
     kernel source with its seconds;
  2. each kernel against its plain PyTorch version at the flagship
     shapes (N = 36*201, D 1024, M 4096, k 128, window 8; the front-end
     tail on conv 0's [36, 12919, 512] output), timed with CUDA events
     beside its plain version, a PyTorch library call computing the same
     function where there is one (a yardstick only; the port never calls
     it) and its bound; the front-end tail also beside the unfused route
     it replaces; the attention rows also with the form the kernel took,
     its floor of exponentials, the long form against its emulation, and
     the kernel's and SDPA's times replayed from a CUDA graph (device
     time without the host's launch cost); the fp32 encode (3xTF32) also
     against an fp64 product, within 1.5x of the plain version's error
     (also at N 1, 68, 127 over several draws), with its split pass and
     GEMM timed apart, the bf16 encode + top-k's cast pass, GEMM and
     select timed apart, and the front-end tail's LN0 pass timed alone on
     the path's h0 and on a channels-first one; with ``--parent DIR``
     (``git archive <commit> sls_tpu_torch | tar -x -C DIR``) that
     commit's wrappers of rows 1-5 and 8, with its kernels built from
     DIR, timed beside them (old, new, new, old); the vote kernel (row
     5) also logged with the bytes its design moves (halo chunks
     included), and its streamed form (M 8192 at window 8, window 32 at
     M 4096, M 32768) held bit-equal to the plain version and timed,
     beside the parent's kernel with ``--parent``;
  3. the main path at full width: the flagship Detector (24 layers,
     1024/4096, 16 heads, bf16, dict 4096, k 128, use_pallas) with seeded
     random weights, scored through make_eval_step and produce_scores
     over batches of 36 synthetic utterances on the int16 wire; launch
     counters are zeroed just before and read just after, and each
     kernel of the path must have launched once per batch and no other
     kernel at all; the kernel path is held against the plain versions
     end to end on a small input; utts/s of the eval step and of the
     score() path;
  4. serving: a BatchingEngine over build_scorer_from_params answers a
     partial batch and more than one batch, each score equal to the
     offline score() of the same audio at the same batch shape;
  5. the window-overlap path, as phases 3 and 4: the same Detector with
     the window-overlap SAE (window 8), holding the flagship's weights,
     through sae_encode_fused, window_vote_fused and sae_decode_fused;
  6. long-clip unwindowed scoring on the flagship's weights:
     score_utterances_unwindowed over clips of 4, 40, 90 and 150 s
     (buckets T 256, 2560, 5120 and 5120 in two chunks), with
     flash_attention_long launched once per layer at T >= 2560 and never
     below; held against the same weights on the einsum route
     (flash_long_t=0); ms per forward and audio-seconds per second at
     T 2560 and 5120; score_full_utterance, score_utterances_streamed and
     BatchingEngine.score_long over the same clips;
  7. the fused_attention=True flagship, as phases 3 and 4, on the
     flagship's weights: fused_attention launched once per layer and
     batch, log-probs held against the default path's;
  8. the fused_frontend=True flagship, as phase 7: frontend_tail_fused
     launched once per batch (and never on another path), log-probs held
     against the default path's; then one T 5120 unwindowed forward on
     each front-end route, with its ms and peak device memory;
  9. the int8 serving flagship (int8_serving, scope "ffn": bench.py's
     serving config), as phases 3 and 4, held to the reference's own
     bounds against the default path (per-frame encoder cosine > 0.99,
     P(bonafide) within 0.05);
 10. sequence-parallel unwindowed scoring at full width: four ranks (one
     process each, all on the one card, joined over gloo; on a host with
     four cards the same rule picks NCCL and a card a rank), each with
     the flagship's weights under sp_model_config, score phase 6's clips
     through score_utterances_unwindowed(sp_mesh=sp_mesh(4)); every rank
     must give the same scores, within ROUTE_TOL of the single-process
     scores, with sp_flash_attention_long launched once per layer and
     forward at T >= 2560 on every rank and no other kernel at all; the
     150 s clip (two rows) again on a dp2 x sp2 mesh; the gathered
     encoder output at T 2560 held to ROUTE_ENVELOPE; ms per forward and
     per all-gather, which are of ranks time-sharing one card;
 11. a multi-process score file: two ranks each score their host_shard
     of phase 3's utterances through produce_scores into a part file;
     the merged file holds every utterance once with phase 3's score,
     every rank returns the global count, and no part file is left;
 12. the flagship train step at full width and depth (make_train_step,
     TrainConfig defaults: lr 1e-6, weight decay 1e-4, class weights
     (0.1, 0.9), SAE weight 0.1) on the flagship's weights, int16 wire
     batches with seeded labels: (a) utts/s on the host clock over 5
     steps after 2 warm-up steps, and peak device memory, at batch 14
     and 36; (b) sae_encode_topk_fused and sae_decode_fused launched
     once a step through their autograd Functions, no other kernel;
     (c) one step's loss and every gradient through the kernels against
     their plain versions (swapped in here), within TRAIN_ENVELOPE of
     the fp32 SAE route, and the rows whose top-k support differs;
     (d) remat at batch 36: its peak memory, the same loss; (e) one
     batch fitted at FIT_LR: the loss finite and falling; (f) a batch
     with a NaN sample: not finite, the state bit-equal after it; (g)
     remat at the encoder's dropout 0.1 against the step without it:
     the same loss, each gradient within REMAT_GRAD_REL or 2x the
     step's own run-to-run difference;
 13. the window-overlap train step at batch 14, as 12 (a) and (b):
     sae_encode_fused, window_vote_fused and sae_decode_fused once a
     step;
 14. the Trainer on the flagship's weights (TrainConfig defaults, batch
     14, RawBoost algorithm 3; int16-wire synthetic audio, seeded
     labels; run directories under TMPDIR, whose free space is checked
     first, deleted at the end): (a) RawBoost's algorithms 1-8 at
     [14, 64600], finite, ms a batch by CUDA events, ISD's modified
     share, SSI's SNR, the cascade, filter_fir and the freqz peak
     against fp64 on the CPU; (b) Trainer A fits one epoch (40
     utterances shuffled, 20 to validate): the CSV row, last.ckpt and
     best.ckpt, seconds, GB a save, peak memory, sae_encode_topk_fused
     and sae_decode_fused once a train step and a validation batch
     and no other kernel; (c) Trainer B, fresh with other weights,
     resumes from A's last.ckpt (step, calls and every tensor equal
     bit for bit), then, under deterministic algorithms, A (in memory)
     and B fit epoch 1: their CSV rows and every tensor bit-equal; a
     third run resumed with a planted fault (``calls`` not restored, so
     other dropout masks) must differ from A; (d) utts/s of
     train_epoch on the host clock (140 utterances, its one fetch
     included) beside phase 12's step at batch 14, and of validate; the
     host syncs of the epoch loop, which must be 0, and its bounding
     waits, one for ten steps; (e)
     Trainer.produce_scores against the eval step's scores;
 15. offline evaluation from files on disk, on the flagship's weights
     (files under TMPDIR, whose free space is checked first, deleted at
     the end): (a) the weights written in the reference's namings, a
     detector ``epoch_7.pth`` (``module.`` prefixes), a fairseq encoder
     ``.pt`` with an argparse payload and an HF-named one, read back with
     ``detector_state_from_reference`` and ``load_pretrained_encoder``:
     every tensor bit-equal, the pos-conv (through weight norm) within
     POS_CONV_REL_L2; GB and seconds of each file; (b) a fresh Trainer
     with other weights resumes from the ``.pth`` at epoch 8 holding
     those weights (W) bit for bit; (c) 170 seeded FLAC files of
     0.5-10 s under the 2021 DF layout (one at 8 kHz, one at 44.1 kHz,
     one cut in its header, one stereo), 20 WAVs under In-the-Wild's,
     the eval lists and a 2019 protocol; (d) eval list ->
     DatasetIndex -> BatchLoader (int16 wire) -> produce_scores with
     sae_encode_topk_fused and sae_decode_fused once a batch and no
     other kernel, the score file bit-equal to the eval step over the
     same decoded arrays, the float32 wire bit-equal on the 16 kHz mono
     files (the others' differences printed), the cut file scored as
     silence, a missing file raising, the WAVs through the non-FLAC
     branch; (e) build_scorer over a port run directory serving the
     files through BatchingEngine, bit-equal to the score file; (f) the
     official scorers (2021 LA with min t-DCF, DF, In-the-Wild, the 2019
     protocol, the 2021 metadata) over organiser key files written here,
     each EER equal to compute_eer on the in-memory scores; (g) utts/s of
     produce_scores from files (20 batches, the files listed again,
     page-cached), of BatchLoader decoding alone, and the card's busy
     share of that run's wall time (CUDA events around each step);
 16. the SLS family at full width (XLS-R-300M, the SLS head, use_sae
     off, bf16, seeded weights, int16 wire): (a) make_sls_eval_step
     through produce_scores at batch 36 with no hand-written kernel
     launched, its utts/s beside phase 3's, and its log-probs held to
     the head with fc1 in fp32 on the same hidden states, within
     ROUTE_ENVELOPE of the reference's own bf16 rounding of fc1; (b) the
     train step (TrainConfig defaults) at batch 14 and 36, utts/s over 5
     steps after 2 warm-up steps and peak memory, the running statistics
     moved once a committed step (0.9 old + 0.1 the batch's), a NaN
     batch leaving parameters, moments, step and running statistics
     bit-equal, one batch fitted at FIT_LR; (c) SLSTrainer fits one epoch
     (28 utterances, 14 to validate; run directory under TMPDIR, its
     free space checked first, deleted at the end): the CSV row,
     last.ckpt and best.ckpt, a fresh trainer resumed bit for bit; (d) an
     upstream-named .pth (``module.`` prefixes,
     ``first_bn.num_batches_tracked``) written, read back bit for bit
     (the pos-conv within POS_CONV_REL_L2) and resumed from; (e)
     build_scorer over (c)'s run directory through BatchingEngine,
     bit-equal to the eval step; (f) layer_gate_profile: 24 gates a row
     in (0, 1);
 17. the CPC variant at full width on the flagship's weights
     (window_hard, window 8, use_pallas, CPC steps 1, 2, 4, cpc_weight
     0.5, batch 14): (a) the train step's utts/s beside phase 13's; (b)
     sae_encode_fused and sae_decode_fused once a step through their
     Functions and no other kernel; (c) the loss, the CPC loss and every
     gradient through the kernels against their plain versions, in
     TRAIN_ENVELOPE's form with the SAE's forward in fp64 as the
     reference (the plain versions are the fp32 route itself), or within
     CPC_GRAD_FLOOR of the plain step's; (d) the eval step: both kernels
     once a batch, the CPC head never run;
 18. the entry points on the flagship's weights, saved as a port run
     directory (a Trainer's whole state), with 216 DF FLAC files (phase
     15's writer), a 2019 LA train / dev layout and In-the-Wild clips of
     3, 12 and 40 s under TMPDIR (its free space checked first, deleted
     at the end): (a) ``cli.main --is_eval --track DF --pallas_sae
     --wire_int16`` in this process, rows 1 and 2 once a batch and no
     other kernel, the score file bit-equal to ``produce_scores`` over
     the same files, its scoring span's utts/s; (b) the same as ``python
     -m sls_tpu_torch.cli.main``, its file equal to (a)'s, its start-up,
     model build and weight load, and scoring seconds; (c)
     ``--full_utterance`` (equal to ``score_full_utterance``) and
     ``--full_utterance --unwindowed`` (row 6 once a layer on the 40 s
     clip's T 2560 bucket, never on the others), then
     ``--seq_parallel 4`` on four ranks sharing the card over gloo, each
     running ``cli.main`` inside the job: row 7 once a layer at T 2560 on
     every rank, scores within ROUTE_TOL; (d) ``cli.main`` trains
     (``--quick_test --batch_size 14 --pallas_sae --profile_steps 2``):
     the run directory named by ``model_tag()``, its CSV row, last.ckpt,
     a trace in which ``op_histogram`` names rows 1 and 2,
     ``cli.profile_diff`` and ``cli.monitor`` over it; (e) ``cli.export
     --batch 36 --wire int16 --verify`` of the flagship, the
     ``fused_attention`` + ``fused_frontend`` and the window-overlap run
     directories: each graph holds its custom ops, the reloaded program
     launches them once a call (row 9 once a layer) and is held to the
     live scorer, ms a batch and the host's enqueue ms of both; (f)
     ``cli.serve`` over the run directory and over the flagship's
     artifact, as child processes: ``/healthz``, ``/score`` (PCM16),
     ``/score_batch``, ``/score_long``, ``/stats``, each score within
     SERVE_TOL of the score file or ``score_full_utterance``, and
     requests/s with p50 / p99 latency at 1 and 36 clients over 10 s;
     (g) the analysis path: ``cli.report`` over the flagship's run
     directory with the window-overlap one to compare (``--synthetic``,
     16 samples at batch 8, the report's defaults; figures where
     matplotlib imports, each one checked), every section's launches
     counted around its command (row 1 once a batch of ``encode_sae``,
     row 2 only in ``inspect``'s and ``overlap``'s full forwards, rows 3
     and 5 in ``compare``), its seconds and the model loads'; then
     ``cli.analyze attribution --ablation`` at the CLI's defaults (100
     samples, batch 16) and ``cli.analyze gates`` over a full-width SLS
     run directory (weights only) through ``main``; ``encode_sae``'s
     codes equal to ``forward``'s bit for bit on four utterances, and the
     gradient attribution on the kernel's codes within ROUTE_ENVELOPE of
     the plain version's against the SAE encode in fp32; (h) the
     training runners and the parity tools: ``cli.parity_kit`` on the
     flagship's weights as a reference-named ``.pth`` (its pos-conv as
     the plain weight, which the converters take beside weight norm's
     pair) over
     (a)'s DF files, its topology inferred from the weights, rows 1 and 2
     once a batch, its scores within SERVE_TOL of (a)'s file (bit-equal
     expected) and exit 1 against that file shifted by 1e-2; then
     ``encoder.parity`` on the same encoder as a fairseq file, fp32 with
     TF32 off: ``PARITY OK``; ``cli.autotrain`` driving one ``cli.main``
     training subprocess at the tiny width to its target epoch; and
     ``cli.sweep --dry_run`` over the reference preset (seven autotrain
     commands);
 19. training across ranks and serving over several devices, on the
     flagship's seeded weights at full width and depth: two ranks spawned
     once, sharing the card over gloo, run (a) the data-parallel flagship
     step, 14 rows a rank, against the one-process step on the 28 rows in
     TRAIN_ENVELOPE's form (loss within E2E_TOL; rows 1 and 2 once a step
     on each rank; a NaN in rank 1's rows leaves both ranks' state bit for
     bit; step ms and the gradient all-reduce's ms, gloo staging it through
     host memory); (b) the data-parallel CPC step, 7 rows a rank, in phase
     17's envelope and CPC_GRAD_FLOOR (rows 3 and 2); (c) the data-parallel
     SLS step, its running statistics equal on both ranks and 0.9 old +
     0.1 the global batch's; (d) a Trainer epoch across the ranks (one CSV
     row and the checkpoints, the primary's; the same figures on both
     ranks); (e) a model_parallel 2 step against the one-process step on
     the plain SAE route, no SAE kernel launched, peak GiB a rank; (g) a
     dp1 x sp2 sequence-parallel flagship step (``sp_model_config``, the
     201 frames cut 101 / 100, 14 rows, the encoder's dropout 0.1 and the
     head's 0.3) against the one-process step on the same rows, masks and
     route: each gradient within 2x the encoder's bf16 rounding, the loss
     within E2E_TOL or 2x that rounding's, no kernel launched, step ms,
     the all-reduce's ms over the mesh and peak GiB a rank; then in this
     process (f) build_scorer_from_params over two replicas on the card at
     batch 36, within SERVE_TOL of one replica on the halves, its utts/s
     beside phase 3's (time-sharing one card: no claim).

Any failed check raises and the script exits nonzero.  The line before
the last is the ``{"kernels": [...]}`` JSON, after a ``{"run": ...}``
line with the card and the throughputs; the last line is
``{"ok": true, "device": {...}}``.  The rehearsal prints none of them.
``--profile`` adds each path's eval-step device time by kernel, a T 5120
forward's, the conv front-end's on both routes, every rank's
sequence-parallel forward at both long buckets, and the flagship train
step's at batch 14 with its SAE backward GEMMs and its optimizer update
timed alone (torch.profiler, CUDA events), as ``{"profile": ...}``
lines.  The train figures go into the ``{"run": ...}`` line under
``"train"``, phase 14's under ``"trainer"``, phase 15's under
``"offline"``, phase 16's under ``"sls"``, phase 17's under ``"cpc"``,
phase 18's under ``"cli"``, phase 19's under ``"parallel"``.
``--cli-only`` runs phases 1 and 18 alone (a partial run, for work on the
entry points: no result lines); ``--parallel-only`` phases 1 and 19.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

# data-sheet peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# exponentials a second on the special-function units of an H100 SXM
# (FlashAttention-3, Shah et al. 2024): the attention kernel's second floor
PEAK_EXP = 3.9e12

ENCODE_TOL = 1e-3      # same bf16 operands, fp32 sums over D=1024 in another order
ENCODE_F32_TOL = 1e-4  # fp32 operands, fp32 sums over D=1024 in another order
# the fp32 encode (3xTF32 on the tensor cores) may lie at most this many
# times further from an fp64 product (relative L2) than the plain fp32 one
ENCODE_F64_ENVELOPE = 1.5
ENCODE_F64_SEEDS = 16  # inputs drawn at each of N = 1, 68, 127 for the envelope check
DECODE_TOL = 1e-4      # fp32 sums of ~k terms in another order
TOPK_TOL = 0.0         # the same 31-step search on the same bits: exact
VOTE_TOL = 0.0         # the same bf16 steps, chunk sums in the same order: exact
E2E_TOL = 1e-3         # log-probs through kernels vs plain versions
SERVE_TOL = 1e-4       # served vs offline P(bonafide) at the same batch shape
ATTN_REL_TOL = 1e-2    # of max|plain|: bf16 p rounded either side of a near-tie
ROUTE_TOL = 2e-2       # long-T log-probs, attention kernel route vs the einsum route
# Against the einsum route at bf16, the kernel routes differ by the bf16
# noise of a 24-layer encoder: the einsum route's own error against the
# same weights in fp32 is the envelope.  A kernel route must lie within
# 1.5x of it from fp32 and within 2x of it from the einsum route (two
# roundings of that size), as tests/test_torch_encoder.py holds the
# port's bf16 encoder.  Measured on the long-T encoder output (relative
# L2) and on the fused_attention path's log-probs (max abs).
ROUTE_ENVELOPE = (1.5, 2.0)
# The front-end tail kernel's tensor cores round its fp32 conv sums
# otherwise than cuDNN's fp32 convs, so some bf16 level roundings flip
# and the flips travel on through six levels.  The plain version with
# fp64 sums is another rounding of the same function: its distance from
# the plain version is the noise, and the kernel must lie within 2x of
# it (relative L2, on the batch's first utterances), with no output
# further off than 1e-2 of max|plain| (one or two ulps at the largest).
FRONTEND_ENVELOPE = 2.0
FRONTEND_REL_TOL = 1e-2
# int8 serving against the default path: the reference's own acceptance
# (tests/test_int8.py): per-frame encoder-output cosine and P(bonafide)
INT8_COS_MIN = 0.99
INT8_SCORE_TOL = 0.05
WINDOW = 8             # the window-overlap variant's window (SAEConfig default)

SAE_KERNELS = ("sae_encode_topk_fused", "sae_encode_fused", "topk_sparsify",
               "window_vote_fused", "sae_decode_fused")
ATTN_KERNELS = ("flash_attention_long", "sp_flash_attention_long", "fused_attention",
                "fused_attention_heads")
FRONTEND_KERNELS = ("frontend_tail_fused",)
KERNELS = SAE_KERNELS + ATTN_KERNELS + FRONTEND_KERNELS


def path_kernels(layers: int) -> dict:
    """Each batch path's launches per batch by kernel; every other kernel
    never."""
    sae = {"sae_encode_topk_fused": 1, "sae_decode_fused": 1}
    return {
        "flagship": sae,
        "window_overlap": {"sae_encode_fused": 1, "window_vote_fused": 1,
                           "sae_decode_fused": 1},
        "fused_attention": {**sae, "fused_attention": layers},
        "fused_frontend": {**sae, "frontend_tail_fused": 1},
        "int8_ffn": sae,
    }


# the hand-written kernels' names as the profiler shows them
OWN_KERNELS = ("cast_x_bf16_kernel", "cast_w_bf16_kernel", "encode_bf16_wgmma_kernel",
               "topk_radix_select_kernel", "split_x_kernel", "split_w_kernel",
               "encode_tf32x3_kernel", "window_vote_kernel",
               "decode_stream_kernel", "attention_short_kernel", "attention_long_kernel",
               "frontend_ln0_bf16_kernel", "frontend_ln0_rows_bf16_kernel",
               "frontend_conv_wgmma_kernel")
ATTN_KERNEL_NAMES = ("attention_short_kernel", "attention_long_kernel")
LONG_CLIP_SECONDS = (4, 40, 90, 150)  # buckets T 256, 2560, 5120, 5120 x 2

# Phases 12-13, the train step.  Kernel step against plain step (the
# SAE wrappers swapped for their plain versions inside the Functions):
# every trainable tensor's gradient is held to the envelope of the SAE's
# own rounding, its gradient on the plain route against the same step
# through the fp32 SAE route (use_pallas off, fp32 operands).  The kernel
# step must lie within 1.5x of that from the fp32 route and within 2x of
# it from the plain step (relative L2 per tensor), as ROUTE_ENVELOPE.
TRAIN_ENVELOPE = (1.5, 2.0)
TRAIN_BATCHES = (14, 36)  # TrainConfig.batch_size, and the eval paths' batch
TRAIN_WARMUP, TRAIN_TIMED = 2, 5  # steps before and inside the timed window
REMAT_LOSS_REL = 1e-5  # remat replays the same forward: the same loss
FIT_LR, FIT_STEPS = 1e-4, 6  # fitting one batch: the loss must fall
WINDOW_TRAIN_STEPS = 2  # phase 13's timed steps, after one warm-up step

# Phase 12 (g): remat against the step without it at the encoder's
# dropout 0.1 (the masks replayed in the backward): the loss within
# REMAT_LOSS_REL, each gradient within REMAT_GRAD_REL (relative L2, the
# CPU test's bound in tests/test_torch_train_modes.py) or within 2x of
# the step's own run-to-run difference on the card, whichever is larger.
REMAT_DROPOUT = 0.1
REMAT_GRAD_REL = 1e-6

# Phase 14, the Trainer: TrainConfig's batch, a shuffled train set of
# three batches (the last with 12 valid rows), a val set whose tail batch
# has 6, and a throughput set of ten batches (the validation pipeline
# then drains as it fills: ten batches against a depth of eight).
TRAINER_SIZES = {"cuda": (14, 40, 20, 140), "cpu": (4, 10, 6, 20)}  # batch, train, val, timed
RAWBOOST_DET_TOL = 1e-5  # card fp32 against CPU fp64, of max|fp64| (FFT sums)
RAWBOOST_SNR_TOL = 1e-2  # dB: SSI scales its noise to the drawn SNR exactly, up to rounding
CKPT_FILES_FREE = 5  # checkpoint files the run directory's disk must hold (4 and a .tmp)
SCORES_TOL = 1e-6  # Trainer.produce_scores against the eval step's scores, same batches

FULL_BATCHES = 3   # main-path run: three full batches and a short tail
SP_RANKS = 4       # phase 10: ranks of the sequence-parallel job
SP_MESHES = ((SP_RANKS, 1), (2, 2))  # its meshes as (n_seq, n_data): sp4 and dp2 x sp2
SCORE_RANKS = 2    # phase 11: ranks writing one score file
RANKS_TIMEOUT_S = 420.0  # a multi-process phase that outlasts this is killed and fails


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    """Each card's name and power limit, one line a card."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip()


def timed(torch, fn, device, iters: int) -> float:
    """Mean milliseconds per call after warm-up: CUDA events on the card,
    the host clock on the CPU rehearsal."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_timed(torch, fn, device, iters: int):
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph of
    ``iters`` calls: the device's time without the host's cost of a launch,
    which at the T 201 attention shape is of the kernel's order.  None off
    the card."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def alternate(torch, new, old, device, iters) -> dict:
    """The kernel's and its parent's ms on the same inputs, timed in turns
    (old, new, new, old): ``ms`` and ``parent_ms`` each the mean of their
    two runs."""
    runs = [timed(torch, fn, device, iters) for fn in (old, new, new, old)]
    return {"ms": (runs[1] + runs[2]) / 2, "parent_ms": (runs[0] + runs[3]) / 2,
            "parent_alternation_ms": runs}


def time_row(torch, row, new, old, device, iters) -> None:
    """``row["ms"]`` of ``new``, or with a parent wrapper ``old`` both in
    turns (old, new, new, old)."""
    if old is None:
        row["ms"] = timed(torch, new, device, iters)
    else:
        row.update(alternate(torch, new, old, device, iters))


def parent_wrapper(parent, module: str, name: str):
    """The parent's wrapper ``name`` of ``module``, or None without one."""
    return None if parent is None else getattr(parent[module], name)


def load_parent(root):
    """The parent commit's kernel wrapper modules, ``sae_kernels`` and
    ``frontend``, imported from ``root``, a ``git archive`` of that
    commit's ``sls_tpu_torch/``, so that phase 2 can time any row's
    wrapper beside the kernel that replaces it (``--parent``).  They
    build that commit's sources into ``root/build/`` at first use.  The
    port's own modules are set aside while the parent's import and put
    back after."""
    import importlib

    root = Path(root).resolve()

    def ours(name):
        return name == "sls_tpu_torch" or name.startswith("sls_tpu_torch.")

    saved = {name: sys.modules.pop(name) for name in list(sys.modules) if ours(name)}
    sys.path.insert(0, str(root))
    try:
        tk = importlib.import_module("sls_tpu_torch.kernels.sae_kernels")
        tf = importlib.import_module("sls_tpu_torch.kernels.frontend")
        check(Path(tk.__file__).resolve().is_relative_to(root),
              f"the parent's wrappers are imported from {root}")
    finally:
        sys.path.remove(str(root))
        for name in [name for name in sys.modules if ours(name)]:
            del sys.modules[name]
        sys.modules.update(saved)
    return {"sae_kernels": tk, "frontend": tf}


def vote_bytes_moved(tk, batch, frames, m, blocks) -> float:
    """Bytes the vote kernel moves through device memory: every frame of
    a stripe's chunks below T read once per stripe (halo chunks included;
    frames after the last window's never read), and every frame written
    once, fp32."""
    stride, n_windows, n_chunks = tk._window_geometry(frames, WINDOW)
    read = 0
    for _, _, c0, c1 in tk.vote_stripes(batch, n_chunks, blocks):
        if c0 <= n_windows:
            j0, j1 = max(c0 - 1, 0), min(c1 + 1, n_windows + 1)
            read += min(j1 * stride, frames) - j0 * stride
    return 4.0 * m * (read + batch * frames)


def phase_vote_streamed(torch, tk, acts3, k, old, device, iters) -> dict:
    """The vote kernel's streamed form, which takes every shape the resident
    form cannot hold (M > 4096, M % 8 != 0, a large window): at M 8192 and
    window 8 (the flagship's activations and their mirror image side by
    side), at window 32 on the flagship's, and at M 32768 (eight copies
    side by side, eight utterances), too wide to carry its chunk sums on
    chip, held bit-equal to the plain version and timed, beside the
    parent's kernel ``old`` in turns where there is one."""
    cases = {"double_m_window8": (torch.cat((acts3, acts3.flip(-1)), -1), 8),
             "window32": (acts3, 32),
             "eightfold_m_window8": (torch.cat([acts3] * 8, -1)[:8].contiguous(), 8)}
    res = {}
    for label, (a, w) in cases.items():
        out = tk.window_vote_fused(a, k, w)
        sync(torch, device)
        ref = tk.window_vote_fused_plain(a, k, w)
        equal = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
        check(equal, f"vote kernel's streamed form ({label}) equals the plain version")
        row = {"bit_equal": equal}
        time_row(torch, row, lambda: tk.window_vote_fused(a, k, w),
                 old and (lambda: old(a, k, w)), device, iters)
        log(f"window_vote streamed form, {label} {list(a.shape)}: {row['ms']:.4f} ms; the "
            f"parent's kernel {row.get('parent_ms')} ms (old, new, new, old: "
            f"{row.get('parent_alternation_ms')})")
        res[label] = row
    return res


def encode_f64_sweep(torch, tk, device, d, m) -> float:
    """The fp32 encode's relative L2 error against fp64 over the plain fp32
    version's, worst over N = 1, 68, 127 (one row, and ragged 128-row
    tiles, where cuBLAS's fp32 product is at its most accurate) and
    ``ENCODE_F64_SEEDS`` draws each of phase 2's inputs."""
    worst = 0.0
    for n in (1, 68, 127):
        for seed in range(ENCODE_F64_SEEDS):
            g = torch.Generator(device=device).manual_seed(1000 * n + seed)
            x = torch.randn(n, d, device=device, generator=g)
            w_dec = torch.rand(m, d, device=device, generator=g) * 2 - 1
            w_enc = (w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True)).t().contiguous()
            b_enc = torch.randn(m, device=device, generator=g) * 0.1
            b_dec = torch.randn(d, device=device, generator=g) * 0.1
            truth = torch.relu((x.double() - b_dec.double()) @ w_enc.double() + b_enc.double())
            worst = max(worst, rel_l2(tk.sae_encode_fused(x, w_enc, b_enc, b_dec), truth)
                        / rel_l2(tk.sae_encode_fused_plain(x, w_enc, b_enc, b_dec), truth))
    return worst


def phase_kernels(torch, tk, device, shape, iters, parent=None):
    batch, frames, d, m, k = shape
    n = batch * frames
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(n, d, device=device, generator=g)
    w_dec = torch.rand(m, d, device=device, generator=g) * 2 - 1
    w_dec = w_dec / torch.linalg.vector_norm(w_dec, dim=1, keepdim=True)
    w_enc = w_dec.t().contiguous()
    b_enc = torch.randn(m, device=device, generator=g) * 0.1
    b_dec = torch.randn(d, device=device, generator=g) * 0.1
    f32 = 4

    # kernel 1: encode + exact top-k
    codes = tk.sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k)
    sync(torch, device)
    acts = tk.sae_encode_acts_plain(x, w_enc, b_enc, b_dec)
    ref = tk.topk_threshold_mask_plain(acts, k)
    kept, kept_ref = codes > 0, ref > 0
    both = kept & kept_ref
    err1 = float((codes[both] - ref[both]).abs().max())
    kth = torch.where(kept_ref, acts, torch.inf).amin(-1, keepdim=True)
    flipped = kept ^ kept_ref
    flip_gap = float((acts - kth).abs()[flipped].max()) if bool(flipped.any()) else 0.0
    log(f"encode_topk: max_abs_err {err1:.3e} on the common support; "
        f"{int(flipped.sum())} support flips, all within {flip_gap:.3e} of the threshold "
        f"(tolerance {ENCODE_TOL})")
    check(err1 <= ENCODE_TOL, "encode kernel values agree with the plain version")
    check(flip_gap <= ENCODE_TOL, "encode kernel support differs only at near-ties")
    check(bool((kept.sum(-1) >= k).all()), "every row keeps at least k entries")

    w_bf16 = w_enc.to(torch.bfloat16)

    def library_encode():
        a = torch.relu(torch.addmm(b_enc.to(torch.bfloat16), (x - b_dec).to(torch.bfloat16),
                                   w_bf16).float())
        t = torch.topk(a, k, dim=-1).values[:, -1:]
        return a * (a >= t)

    ops1 = 2.0 * n * d * m
    bytes1 = f32 * (x.numel() + w_enc.numel() + b_enc.numel() + b_dec.numel() + n * m)
    bound1, by1 = bound(bytes1, ops1, PEAK_BF16_FLOPS)
    enc = {
        "name": "sae_encode_topk_fused", "route": "cuda",
        "source": "sls_tpu_torch/kernels/csrc/sae_encode_topk.cu",
        "replaces": "sls_tpu/kernels/sae_kernels.py:143",
        "max_abs_err": err1, "tolerance": ENCODE_TOL,
        "plain_ms": timed(torch, lambda: tk.sae_encode_topk_fused_plain(x, w_enc, b_enc, b_dec, k),
                          device, max(iters // 4, 1)),
        "library_ms": timed(torch, library_encode, device, iters),
        "bound_ms": bound1, "bound_by": by1, "ops": ops1, "bytes": bytes1,
    }
    new1 = lambda: tk.sae_encode_topk_fused(x, w_enc, b_enc, b_dec, k)  # noqa: E731
    old1 = parent_wrapper(parent, "sae_kernels", "sae_encode_topk_fused")
    time_row(torch, enc, new1, old1 and (lambda: old1(x, w_enc, b_enc, b_dec, k)), device, iters)
    if device.type == "cuda":
        # the cast pass, the GEMM and the select apart, from the profiler
        by_name = device_time_by_kernel(new1, reps=iters)["by_name_ms"]
        for key, part in (("cast_ms", "cast_"), ("gemm_ms", "encode_bf16_wgmma"),
                          ("select_ms", "topk_radix_select")):
            enc[key] = sum(ms for name, ms in by_name.items() if part in name)
    log(f"encode_topk: {enc['ms']:.4f} ms (cast pass {enc.get('cast_ms')}, GEMM "
        f"{enc.get('gemm_ms')}, select {enc.get('select_ms')}), library {enc['library_ms']:.4f} "
        f"ms, bound {bound1:.4f} ms ({by1}); the parent's kernel {enc.get('parent_ms')} ms "
        f"(old, new, new, old: {enc.get('parent_alternation_ms')})")

    # kernel 2: decode of the plain version's codes
    recon = tk.sae_decode_fused(ref, w_dec, b_dec)
    sync(torch, device)
    recon_ref = tk.sae_decode_fused_plain(ref, w_dec, b_dec)
    err2 = float((recon - recon_ref).abs().max())
    log(f"decode: max_abs_err {err2:.3e} (tolerance {DECODE_TOL})")
    check(err2 <= DECODE_TOL, "decode kernel agrees with the plain version")
    nnz = int((ref != 0).sum())
    ops2 = 2.0 * nnz * d  # the sparse product these codes need
    bytes2 = f32 * (ref.numel() + w_dec.numel() + b_dec.numel() + n * d)
    bound2, by2 = bound(bytes2, ops2, PEAK_FP32_FLOPS)
    dec = {
        "name": "sae_decode_fused", "route": "cuda",
        "source": "sls_tpu_torch/kernels/csrc/sae_decode.cu",
        "replaces": "sls_tpu/kernels/sae_kernels.py:440",
        "max_abs_err": err2, "tolerance": DECODE_TOL,
        "plain_ms": timed(torch, lambda: tk.sae_decode_fused_plain(ref, w_dec, b_dec),
                          device, iters),
        "library_ms": timed(torch, lambda: torch.addmm(b_dec, ref, w_dec), device, iters),
        "bound_ms": bound2, "bound_by": by2, "ops": ops2, "bytes": bytes2, "nnz": nnz,
    }
    old2 = parent_wrapper(parent, "sae_kernels", "sae_decode_fused")
    time_row(torch, dec, lambda: tk.sae_decode_fused(ref, w_dec, b_dec),
             old2 and (lambda: old2(ref, w_dec, b_dec)), device, iters)
    # bytes from L2, computed from the two designs (not measured): the
    # gather form (a block a row) read each row's codes and gathered each
    # selected W_dec row; the streamed form reads, per block of a row tile
    # and a column slice, every window's codes tile and (a cluster sharing
    # it) its part of W_dec
    rows_, cols_, win = tk.DECODE_TILE_ROWS, tk.DECODE_TILE_COLS, tk.DECODE_WINDOW
    row_tiles = -(-n // rows_)
    row_tiles = -(-row_tiles // tk.DECODE_CLUSTER) * tk.DECODE_CLUSTER
    blocks = row_tiles * -(-d // cols_) * -(-m // win)
    l2_gathered = f32 * (n * m + nnz * d)
    l2_streamed = f32 * blocks * (rows_ * win + win * cols_ / tk.DECODE_CLUSTER)
    log(f"decode: {dec['ms']:.4f} ms, addmm {dec['library_ms']:.4f} ms, bound {bound2:.4f} ms "
        f"({by2}); L2 bytes of the gather form {l2_gathered / 1e9:.3f} GB, streamed "
        f"now {l2_streamed / 1e9:.3f} GB (computed); the parent's kernel "
        f"{dec.get('parent_ms')} ms (old, new, new, old: {dec.get('parent_alternation_ms')})")

    # kernel 3: fp32 encode, no top-k
    acts32 = tk.sae_encode_fused(x, w_enc, b_enc, b_dec)
    sync(torch, device)
    acts_ref = tk.sae_encode_fused_plain(x, w_enc, b_enc, b_dec)
    err3 = float((acts32 - acts_ref).abs().max())
    log(f"encode (fp32): max_abs_err {err3:.3e} (tolerance {ENCODE_F32_TOL})")
    check(err3 <= ENCODE_F32_TOL, "fp32 encode kernel agrees with the plain version")
    truth = torch.relu((x.double() - b_dec.double()) @ w_enc.double() + b_enc.double())
    f64 = {"rel_l2_vs_fp64": rel_l2(acts32, truth), "plain_rel_l2_vs_fp64": rel_l2(acts_ref, truth)}
    del truth
    log(f"encode (fp32): relative L2 against fp64 {f64['rel_l2_vs_fp64']:.3e}, the plain "
        f"version's {f64['plain_rel_l2_vs_fp64']:.3e} (x{ENCODE_F64_ENVELOPE})")
    check(f64["rel_l2_vs_fp64"] <= ENCODE_F64_ENVELOPE * f64["plain_rel_l2_vs_fp64"],
          "fp32 encode kernel lies within the plain version's fp64 envelope")
    f64["fp64_ratio_worst_small_n"] = encode_f64_sweep(torch, tk, device, d, m)
    check(f64["fp64_ratio_worst_small_n"] <= ENCODE_F64_ENVELOPE,
          "fp32 encode kernel lies within the fp64 envelope at every small N and seed")
    # the function's own bytes, and its three TF32 products at the TF32 peak
    ops3 = 3 * 2.0 * n * d * m
    bound3, by3 = bound(bytes1, ops3, PEAK_TF32_FLOPS)
    enc32 = {
        "name": "sae_encode_fused", "route": "cuda",
        "source": "sls_tpu_torch/kernels/csrc/sae_encode.cu",
        "replaces": "sls_tpu/kernels/sae_kernels.py:74",
        "max_abs_err": err3, "tolerance": ENCODE_F32_TOL, **f64,
        "plain_ms": timed(torch, lambda: tk.sae_encode_fused_plain(x, w_enc, b_enc, b_dec),
                          device, iters),
        "library_ms": timed(torch, lambda: torch.relu(torch.addmm(b_enc, x - b_dec, w_enc)),
                            device, iters),
        "bound_ms": bound3, "bound_by": f"{by3}, 3xTF32", "ops": ops3, "bytes": bytes1,
    }
    new3 = lambda: tk.sae_encode_fused(x, w_enc, b_enc, b_dec)  # noqa: E731
    old3 = parent_wrapper(parent, "sae_kernels", "sae_encode_fused")
    time_row(torch, enc32, new3, old3 and (lambda: old3(x, w_enc, b_enc, b_dec)), device, iters)
    if device.type == "cuda":
        # the split pass and the GEMM apart, from the profiler's device times
        by_name = device_time_by_kernel(new3, reps=iters)["by_name_ms"]
        enc32["split_ms"] = sum(ms for name, ms in by_name.items() if "split_" in name)
        enc32["gemm_ms"] = sum(ms for name, ms in by_name.items() if "encode_tf32x3" in name)
    log(f"encode (fp32): {enc32['ms']:.4f} ms (split pass {enc32.get('split_ms')}, GEMM "
        f"{enc32.get('gemm_ms')}), addmm {enc32['library_ms']:.4f} ms, bound {bound3:.4f} ms "
        f"(3xTF32; fp32 SIMT {bound(bytes1, ops3 / 3, PEAK_FP32_FLOPS)[0]:.4f}); worst ratio "
        f"to the plain version's fp64 error at N 1, 68, 127 over {ENCODE_F64_SEEDS} seeds "
        f"{f64['fp64_ratio_worst_small_n']:.4f}; the parent's kernel {enc32.get('parent_ms')} "
        f"ms (old, new, new, old: {enc32.get('parent_alternation_ms')})")

    # kernel 4: the row top-k alone, on the plain fp32 encode's activations
    sparse = tk.topk_sparsify(acts_ref, k)
    sync(torch, device)
    sparse_ref = tk.topk_threshold_mask_plain(acts_ref, k)
    err4 = float((sparse - sparse_ref).abs().max())
    log(f"topk_sparsify: max_abs_err {err4:.3e}, supports equal "
        f"{bool(torch.equal(sparse > 0, sparse_ref > 0))} (tolerance {TOPK_TOL})")
    check(err4 <= TOPK_TOL and torch.equal(sparse, sparse_ref),
          "top-k kernel equals the plain version")

    def library_topk():
        t = torch.topk(acts_ref, k, dim=-1).values[:, -1:]
        return torch.where(acts_ref >= t, acts_ref, 0.0)

    # a compare-and-count over the rows for each radix pass
    ops4 = 2.0 * len(tk.RADIX_PASSES) * n * m
    bytes4 = f32 * 2 * n * m
    bound4, by4 = bound(bytes4, ops4, PEAK_FP32_FLOPS)
    topk = {
        "name": "topk_sparsify", "route": "cuda",
        "source": "sls_tpu_torch/kernels/csrc/sae_encode_topk.cu",
        "replaces": "sls_tpu/kernels/sae_kernels.py:232",
        "max_abs_err": err4, "tolerance": TOPK_TOL,
        "plain_ms": timed(torch, lambda: tk.topk_threshold_mask_plain(acts_ref, k),
                          device, max(iters // 4, 1)),
        "library_ms": timed(torch, library_topk, device, iters),
        "bound_ms": bound4, "bound_by": by4, "ops": ops4, "bytes": bytes4,
    }
    old4 = parent_wrapper(parent, "sae_kernels", "topk_sparsify")
    time_row(torch, topk, lambda: tk.topk_sparsify(acts_ref, k),
             old4 and (lambda: old4(acts_ref, k)), device, iters)
    log(f"topk_sparsify: {topk['ms']:.4f} ms, library {topk['library_ms']:.4f} ms, bound "
        f"{bound4:.4f} ms ({by4}); the parent's kernel {topk.get('parent_ms')} ms (old, new, "
        f"new, old: {topk.get('parent_alternation_ms')})")

    # kernel 5: the vote merge of the plain fp32 encode's activations
    acts3 = acts_ref.reshape(batch, frames, m)
    voted = tk.window_vote_fused(acts3, k, WINDOW)
    sync(torch, device)
    voted_ref = tk.window_vote_fused_plain(acts3, k, WINDOW)
    kept, kept_ref = voted > 0, voted_ref > 0
    both = kept & kept_ref
    flips = int((kept ^ kept_ref).sum())
    err5 = float((voted[both] - voted_ref[both]).abs().max())
    # every entry's bits, the zeros of unkept entries included
    bits5 = bool(torch.equal(voted.view(torch.int32), voted_ref.view(torch.int32)))
    log(f"window_vote: max_abs_err {err5:.3e} on the common support; {flips} support "
        f"flips of {int(kept_ref.sum())} kept entries; bit-equal {bits5} (tolerance "
        f"{VOTE_TOL}, no flips)")
    check(flips == 0 and err5 <= VOTE_TOL and bits5, "vote kernel equals the plain version")
    stride, n_windows, n_chunks = tk._window_geometry(frames, WINDOW)
    # chunk sums, window sums, the select's two digit passes and its
    # compare over the window and frame rows, and the votes
    ops5 = batch * m * (n_chunks * stride + n_windows + 2.0 * 3 * (n_windows + frames) + frames)
    bytes5 = f32 * 2 * n * m
    bound5, by5 = bound(bytes5, ops5, PEAK_FP32_FLOPS)
    # the kernel's persistent grid: one block an SM
    vote_blocks = (torch.cuda.get_device_properties(device).multi_processor_count
                   if device.type == "cuda" else tk.VOTE_BLOCKS)
    vote = {
        "name": "window_vote_fused", "route": "cuda",
        "source": "sls_tpu_torch/kernels/csrc/window_vote.cu",
        "replaces": "sls_tpu/kernels/sae_kernels.py:330",
        "max_abs_err": err5, "tolerance": VOTE_TOL, "support_flips": flips,
        "plain_ms": timed(torch, lambda: tk.window_vote_fused_plain(acts3, k, WINDOW),
                          device, max(iters // 4, 1)),
        "library_ms": None,  # no one PyTorch call computes this function
        "bound_ms": bound5, "bound_by": by5, "ops": ops5, "bytes": bytes5,
    }
    old5 = parent_wrapper(parent, "sae_kernels", "window_vote_fused")
    time_row(torch, vote, lambda: tk.window_vote_fused(acts3, k, WINDOW),
             old5 and (lambda: old5(acts3, k, WINDOW)), device, iters)
    # computed from the work split, not measured: logged only
    moved5 = vote_bytes_moved(tk, batch, frames, m, vote_blocks)
    log(f"window_vote: {vote['ms']:.4f} ms, bound {bound5:.4f} ms ({by5}); the design moves "
        f"{moved5 / 1e6:.1f} MB (halo chunks included) against the bound's "
        f"{bytes5 / 1e6:.1f}; the parent's kernel {vote.get('parent_ms')} ms (old, new, new, "
        f"old: {vote.get('parent_alternation_ms')})")
    vote["streamed_form"] = phase_vote_streamed(torch, tk, acts3, k, old5, device, iters)
    rows = [enc, enc32, topk, vote, dec]
    for row in rows:
        row["kernel_ms"] = row["ms"]
    return rows


def bf16_ulps_exceeded(torch, out, ref) -> int:
    """Elements of ``out`` further than one bf16 ulp of ``ref`` from it."""
    _, exp = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return int(((out.float() - ref.float()).abs() > ulp).sum())


def phase_attention(torch, ta, device, long_shape, short_shape, iters):
    """Kernels 6, 7, 9 and 10 (one CUDA source behind four wrappers, in
    the form its Tkv picks) against their plain versions at the main
    paths' shapes, bf16, and the long form also against its CPU-side
    emulation (``attention_online_emulated``, run here on the card): row 6 at
    the long-T bucket [B, T, C] (also at T / 2 and at Tq = T / 4 against
    Tkv = T); row 7 in one process (a group of one: k and v given whole)
    on a rank's q strip at every shape phase 10 gives it (a strip of four
    at T and T / 2 on the sp4 mesh, a strip of two at T on dp2 x sp2),
    and the strips of each mesh against row 6's output on the same
    inputs; rows 9 and 10 at the short-T flagship [B, T, H, Dh]."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(1)

    def inputs(*shapes):
        return [(torch.randn(s, device=device, generator=g) * 0.5).to(bf16) for s in shapes]

    def sdpa(q, k, v, heads):
        """One library call of the same function (a yardstick only)."""
        def view(x):
            return x.reshape(x.shape[0], x.shape[1], heads, -1).transpose(1, 2)
        return F.scaled_dot_product_attention(view(q), view(k), view(v), scale=1.0)

    def measure(name, wrapper, plain, args, heads, replaces):
        out = wrapper(*args)
        sync(torch, device)
        ref = plain(*args)
        err = float((out.float() - ref.float()).abs().max())
        tol = ATTN_REL_TOL * float(ref.float().abs().max())
        ulps = bf16_ulps_exceeded(torch, out, ref)
        check(err <= tol, f"{name} agrees with its plain version")
        q, k = args[0], args[1]
        b, tq = q.shape[0], q.shape[1]
        tkv, c = k.shape[1], k.shape[-1] * (k.shape[-2] if k.dim() == 4 else 1)
        flat = [x.reshape(x.shape[0], x.shape[1], -1) for x in args[:3]]
        form = ta.attention_form(tkv)
        emu = {}
        if form == "long":
            emulated = ta.attention_online_emulated(*flat, heads).reshape(out.shape)
            emu = {"emulation_max_abs_err": float((out.float() - emulated.float()).abs().max()),
                   "elements_beyond_one_bf16_ulp_vs_emulation":
                       bf16_ulps_exceeded(torch, out, emulated)}
            check(emu["emulation_max_abs_err"] <= tol, f"{name} agrees with its emulation")
            del emulated
        ops = 4.0 * b * tq * tkv * c  # q k^T and p v, 2 ops a multiply-add
        bytes_ = 2.0 * (2 * b * tq * c + 2 * b * tkv * c)  # q, k, v read, o written
        bound_ms, by = bound(bytes_, ops, PEAK_BF16_FLOPS)
        exps = float(b * heads * tq * tkv)  # one exponential a score
        row = {
            "name": name, "route": "cuda", "source": "sls_tpu_torch/kernels/csrc/attention.cu",
            "replaces": replaces, "form": form, "max_abs_err": err, "tolerance": tol,
            "elements_beyond_one_bf16_ulp": ulps, "elements": out.numel(), **emu,
            "shape": {"B": b, "Tq": tq, "Tkv": tkv, "C": c, "heads": heads},
            "ms": timed(torch, lambda: wrapper(*args), device, iters),
            "plain_ms": timed(torch, lambda: plain(*args), device, max(iters // 4, 1)),
            "library_ms": timed(torch, lambda: sdpa(*flat, heads), device, iters),
            "device_ms": graph_timed(torch, lambda: wrapper(*args), device, iters),
            "library_device_ms": graph_timed(torch, lambda: sdpa(*flat, heads), device, iters),
            "bound_ms": bound_ms, "bound_by": by, "ops": ops, "bytes": bytes_,
            "exponentials": exps, "exp_floor_ms": exps / PEAK_EXP * 1e3,
        }
        log(f"{name} {row['shape']} ({form} form): max_abs_err {err:.3e} (tolerance {tol:.3e}), "
            f"{ulps} of {out.numel()} elements beyond one bf16 ulp; {json.dumps(emu)}; "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} "
            f"ms; from a CUDA graph {row['device_ms']} ms, SDPA {row['library_device_ms']} ms; "
            f"bound {bound_ms:.4f} ms ({by}), exponentials floor {row['exp_floor_ms']:.4f} ms")
        return row

    b, t, c, h = long_shape
    long_rows = [measure("flash_attention_long",
                         lambda q, k, v: ta.flash_attention_long(q, k, v, h, block_q=128),
                         lambda q, k, v: ta.flash_attention_long_plain(q, k, v, h),
                         inputs(*[(b, tq, c)] + [(b, tkv, c)] * 2), h,
                         "sls_tpu/kernels/flash_attention.py:52")
                 for tq, tkv in ((t, t), (t // 2, t // 2), (t // 4, t))]
    case_keys = ("shape", "form", "max_abs_err", "tolerance", "elements_beyond_one_bf16_ulp",
                 "emulation_max_abs_err", "elements_beyond_one_bf16_ulp_vs_emulation", "ms",
                 "plain_ms", "library_ms", "device_ms", "library_device_ms", "bound_ms",
                 "bound_by", "exp_floor_ms")
    row6 = dict(long_rows[0], cases=[{key: r[key] for key in case_keys if key in r}
                                     for r in long_rows])

    sp_rows = [measure("sp_flash_attention_long",
                       lambda q, k, v: ta.sp_flash_attention_long(q, k, v, h),
                       lambda q, k, v: ta.sp_flash_attention_long_plain(q, k, v, h),
                       inputs(*[(b, tkv // n_seq, c)] + [(b, tkv, c)] * 2), h,
                       "sls_tpu/kernels/flash_attention.py:123")
               # sp4 scores clips at both long buckets, dp2 x sp2 the two-row
               # clip at T (one row a data coordinate)
               for tkv, n_seq in ((t, SP_MESHES[0][0]), (t // 2, SP_MESHES[0][0]),
                                  (t, SP_MESHES[1][0]))]
    row7 = dict(sp_rows[0], cases=[{key: r[key] for key in case_keys if key in r}
                                   for r in sp_rows])
    # rows are independent and the K/V tile order does not depend on Tq,
    # so a rank's strip should be bit-equal to its rows of the full output
    q, k, v = inputs((b, t, c), (b, t, c), (b, t, c))
    whole = ta.flash_attention_long(q, k, v, h)
    row7["strips_vs_whole_max_abs"], row7["strips_bit_equal"] = 0.0, True
    for n_seq, _ in SP_MESHES:
        strips = torch.cat([ta.sp_flash_attention_long(piece.contiguous(), k, v, h)
                            for piece in q.chunk(n_seq, dim=1)], dim=1)
        diff = float((strips.float() - whole.float()).abs().max())
        equal = bool(torch.equal(strips, whole))
        log(f"sp_flash_attention_long: {n_seq} strips of T {t} against flash_attention_long on "
            f"the same inputs: max_abs {diff:.3e}, bit-equal {equal}")
        check(diff <= row7["tolerance"], f"{n_seq} strips agree with the whole-sequence kernel")
        row7["strips_vs_whole_max_abs"] = max(row7["strips_vs_whole_max_abs"], diff)
        row7["strips_bit_equal"] = row7["strips_bit_equal"] and equal

    b, t, h, dh = short_shape
    args = inputs(*[(b, t, h, dh)] * 3)
    row9 = measure("fused_attention", ta.fused_attention, ta.fused_attention_plain, args, h,
                   "sls_tpu/kernels/attention.py:117")
    flat = [x.reshape(b, t, h * dh) for x in args]
    row10 = measure("fused_attention_heads",
                    lambda q, k, v: ta.fused_attention_heads(q, k, v, h),
                    lambda q, k, v: ta.fused_attention_heads_plain(q, k, v, h), flat, h,
                    "sls_tpu/kernels/attention.py:56")
    rows = [row6, row7, row9, row10]
    for row in rows:
        row["kernel_ms"] = row["ms"]
    return rows


def ln0_pass(torch, tf, h0, args, kw):
    """Kernel 8's LN0 + GELU0 launch alone (its first of seven) on ``h0``
    at its strides, as the wrapper makes it, for timing."""
    import ctypes

    from sls_tpu_torch.kernels import build

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = build.load("frontend_tail").frontend_ln0_launch
    fn.argtypes, fn.restype = [P, P, I, I, I, L, L, L, P, P, F, I, I, P], ctypes.c_int
    b, n0, c = h0.shape
    pitch = tf.level_pitches(n0, kw["specs"])[0]
    out = torch.empty(b, pitch, c, device=h0.device, dtype=h0.dtype)
    scale, shift = (t.float().contiguous() for t in args[2:])
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: build.check(fn(h0.data_ptr(), out.data_ptr(), b, n0, pitch, *h0.stride(),
                                  scale.data_ptr(), shift.data_ptr(), 1e-5,
                                  int(kw["approx_gelu"]), 1, stream), "frontend_ln0")


def phase_frontend(torch, tf, xlsr, enc_cfg, wavs, device, iters, parent=None):
    """Kernel 8 against its plain version on the main path's input: conv
    0's output of a batch of audio, the [B, N0, C] view over its
    channels-first storage, through a front-end with seeded random
    weights, biases and norm affines.  Also times the unfused route from
    the same conv-0 output (cuDNN convs with their fp32 LN / GELU
    passes), which this kernel replaces on the fused_frontend path."""
    fe = xlsr.ConvFeatureExtractor(enc_cfg, device)
    g = torch.Generator(device=device).manual_seed(2)
    with torch.no_grad():
        xlsr.init_weights_(fe, g)
        for conv in fe.conv:
            if conv.bias is not None:
                conv.bias.normal_(0.0, 0.1, generator=g)
        for norm in fe.norm:
            norm.weight.normal_(1.0, 0.1, generator=g)
            norm.bias.normal_(0.0, 0.1, generator=g)
    args, kw = fe.tail_fused_args()
    few = 3  # utterances the fp64-sum envelope is measured on
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).to(device)
        h0 = fe.level0(wav)  # as the encoder's forward makes it
        out = tf.frontend_tail_fused(h0, *args, **kw)
        sync(torch, device)
        ref = tf.frontend_tail_fused_plain(h0, *args, **kw)
        ref64 = tf.frontend_tail_fused_plain(h0[:few], *args, **kw, sum_dtype=torch.float64)
        out, ref, ref64 = out.float(), ref.float(), ref64.float()
        err = float((out - ref).abs().max())
        tol = FRONTEND_REL_TOL * float(ref.abs().max())
        rel, envelope = rel_l2(out[:few], ref[:few]), rel_l2(ref64, ref[:few])
        ulps = bf16_ulps_exceeded(torch, out, ref)
        check(err <= tol, "frontend_tail_fused agrees with its plain version (max)")
        check(rel <= FRONTEND_ENVELOPE * envelope,
              "frontend_tail_fused lies within the fp64-sum envelope of its plain version")
        b, n0, c = h0.shape
        lengths = tf.tail_lengths(n0, kw["specs"])
        ops = sum(2.0 * b * n_out * k * c * c for n_out, (k, _) in zip(lengths[1:], kw["specs"]))
        weights = sum(w.numel() for w in args[0])
        params = sum(t.numel() for t in args[1:])
        bytes_ = (h0.numel() + weights + out.numel()) * h0.element_size() + 4.0 * params
        bound_ms, by = bound(bytes_, ops, PEAK_BF16_FLOPS)
        row = {
            "name": "frontend_tail_fused", "route": "cuda",
            "source": "sls_tpu_torch/kernels/csrc/frontend_tail.cu",
            "replaces": "sls_tpu/kernels/frontend.py:184",
            "max_abs_err": err, "tolerance": tol, "elements_beyond_one_bf16_ulp": ulps,
            "elements": out.numel(), "rel_l2_vs_plain": rel, "envelope_rel_l2": envelope,
            "shape": {"h0": list(h0.shape), "h0_strides": list(h0.stride()),
                      "out": list(out.shape), "specs": kw["specs"]},
            "plain_ms": timed(torch, lambda: tf.frontend_tail_fused_plain(h0, *args, **kw),
                              device, max(iters // 4, 1)),
            "library_ms": None,  # no one PyTorch call computes this function
            "unfused_route_ms": timed(torch, lambda: fe.tail(h0), device, iters),
            "bound_ms": bound_ms, "bound_by": by, "ops": ops, "bytes": bytes_,
        }
        old = parent_wrapper(parent, "frontend", "frontend_tail_fused")
        time_row(torch, row, lambda: tf.frontend_tail_fused(h0, *args, **kw),
                 old and (lambda: old(h0, *args, **kw)), device, iters)
        if device.type == "cuda":
            # its LN0 pass on the path's h0, and on a channels-first copy
            # (frames unit-stride), which takes the other LN0 kernel
            other = h0.transpose(1, 2).contiguous().transpose(1, 2)
            row["ln0_ms"] = timed(torch, ln0_pass(torch, tf, h0, args, kw), device, iters)
            row["ln0_channels_first_ms"] = timed(torch, ln0_pass(torch, tf, other, args, kw),
                                                 device, iters)
            del other
    row["kernel_ms"] = row["ms"]
    log(f"frontend_tail_fused {row['shape']}: max_abs_err {err:.3e} (tolerance {tol:.3e}), "
        f"{ulps} of {out.numel()} elements beyond one bf16 ulp; relative L2 {rel:.3e} against "
        f"an fp64-sum envelope of {envelope:.3e} (x{FRONTEND_ENVELOPE}); {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, unfused route {row['unfused_route_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({by}); its LN0 pass {row.get('ln0_ms')} ms (channels-first "
        f"h0: {row.get('ln0_channels_first_ms')} ms); the parent's "
        f"kernel {row.get('parent_ms')} ms (old, new, new, old: "
        f"{row.get('parent_alternation_ms')})")
    return row


def device_time_by_kernel(fn, reps: int = 3, top: int = 15) -> dict:
    """Run ``fn`` once to warm up, then ``reps`` times under torch.profiler
    on the current CUDA device.  Returns the wall and device ms per call,
    the device's busy share of the window's wall time (kernel durations
    added up: on one stream they do not overlap; a collective's kernel on
    its own stream, which also counts the time it waits for the other
    ranks, can push the share past 1), ``by_name_ms`` per call for every
    kernel name, and the ``top`` names.  Raises when the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total_us = sum(by_name.values())
    if total_us <= 0:
        raise RuntimeError("the profiler saw no device time")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "steps": reps,
        "wall_ms_per_step": wall_us / reps / 1e3,
        "device_ms_per_step": total_us / reps / 1e3,
        "device_busy_share": total_us / wall_us,
        "kernel_names": len(by_name),
        "by_name_ms": {name: us / reps / 1e3 for name, us in ranked},
        "top": [{"kernel": name[:100], "ms_per_step": us / reps / 1e3, "share": us / total_us}
                for name, us in ranked[:top]],
    }


def profile_step(step, batch_wire, reps: int = 3) -> dict:
    """Device time of ``reps`` eval steps by kernel name (torch.profiler's
    device-side events), the hand-written kernels' part of it, and the
    device's busy share of the window's wall time."""
    prof = device_time_by_kernel(lambda: step(batch_wire), reps)
    by_name = prof.pop("by_name_ms")
    prof["own_kernels_ms_per_step"] = {
        name: sum(ms for key, ms in by_name.items() if name in key) for name in OWN_KERNELS}
    return prof


# Phase 10's measurements, run inside every rank as jobs of
# ``parallel/workers.py::sp_score_rank`` (the spawned ranks import this
# file for them): ``fn(job, model, mesh, device) -> dict``.


def sp_time_job(job, model, mesh, device) -> dict:
    """``forward_ms`` of one sequence-parallel ``score`` of ``job["wav"]``,
    ``enqueue_ms`` the host takes to enqueue one (no wait for the device),
    ``gather_ms`` of one all-gather of a layer's stacked keys and values
    (what the path does), ``gather_split_ms`` of the same bytes as two
    gathers, and ``peak_gib`` of device memory over the forwards."""
    import torch
    from sls_tpu_torch.parallel.distributed import all_gather_cat
    from sls_tpu_torch.parallel.sequence import sp_scoring_fn

    wav = torch.from_numpy(np.asarray(job["wav"], np.float32)).to(device)
    fwd = sp_scoring_fn(model, mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res = {"forward_ms": timed(torch, lambda: fwd(wav), device, int(job["iters"]))}
    t0 = time.perf_counter()
    fwd(wav)
    res["enqueue_ms"] = (time.perf_counter() - t0) * 1e3
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    shard = model.encoder.shard_for(wav, mesh)
    kv = torch.zeros(2, wav.shape[0] // shard.n_data, shard.chunk, model.config.encoder.embed_dim,
                     dtype=model.config.encoder.dtype, device=device)
    gathers = 4 * int(job["iters"])
    res["gather_ms"] = timed(torch, lambda: all_gather_cat(kv, shard.seq_group, dim=2), device,
                             gathers)
    res["gather_split_ms"] = timed(
        torch, lambda: [all_gather_cat(x, shard.seq_group, dim=1) for x in kv.unbind(0)],
        device, gathers)
    res["gather_shape"] = list(kv.shape)
    return res


def sp_profile_job(job, model, mesh, device) -> dict:
    """This rank's device time of one sequence-parallel ``score`` by
    kernel: the top names, and the sums over the collectives' kernels and
    the attention kernel."""
    import torch
    from sls_tpu_torch.parallel.sequence import sp_scoring_fn

    wav = torch.from_numpy(np.asarray(job["wav"], np.float32)).to(device)
    fwd = sp_scoring_fn(model, mesh)
    prof = device_time_by_kernel(lambda: fwd(wav), int(job["iters"]), top=12)
    by_name = prof.pop("by_name_ms")
    for label, parts in (("collectives_ms_per_step", ("nccl", "gloo")),
                         ("attention_kernel_ms_per_step", ATTN_KERNEL_NAMES)):
        prof[label] = sum(ms for name, ms in by_name.items()
                          if any(part in name.lower() for part in parts))
    return {"profile": prof}


@contextmanager
def deterministic_algorithms(torch):
    """torch's deterministic algorithms, cuDNN's included, inside the
    block: cuDNN's convolution backward otherwise picks algorithms that
    sum in another order from run to run.  An op with no deterministic
    form warns (collected, and returned in the yielded list) rather than
    stops.  ``CUBLAS_WORKSPACE_CONFIG`` is what torch's check asks for;
    GEMMs on one stream repeat bit for bit anyway."""
    import os
    import warnings

    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    nondeterministic: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield nondeterministic
        nondeterministic += sorted({str(w.message)[:200] for w in caught
                                    if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[2:]
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


@contextmanager
def plain_sae_kernels(tk, names=("sae_encode_topk_fused", "sae_decode_fused"), versions=None):
    """SAE kernel wrappers (by default the flagship's, rows 1 and 2)
    swapped for their plain versions, or for ``versions`` (name ->
    function), so that the autograd Functions run that forward (this
    script only; the package never swaps); put back after."""
    plain = versions or {name: getattr(tk, name + "_plain") for name in names}
    saved = {name: getattr(tk, name) for name in plain}
    try:
        for name, fn in plain.items():
            setattr(tk, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(tk, name, fn)


def train_batch(torch, wavs, batch: int, seed: int, device):
    """One training batch on the device, as a loader with a copy stream
    leaves it: the int16 wire of the first ``batch`` utterances (tiled),
    seeded labels, every row valid."""
    from sls_tpu_torch.data.pipeline import to_wire

    rows = np.resize(wavs, (batch, wavs.shape[1])).astype(np.float32)
    labels = np.random.default_rng(seed).integers(0, 2, batch)
    return (torch.from_numpy(to_wire(rows, "int16")).to(device),
            torch.from_numpy(labels).to(device), torch.ones(batch, device=device))


def grads_of(torch, model, tcfg, batch_, seed: int, device):
    """(loss, codes, {name: gradient}) of one training forward and backward
    of ``model`` on ``batch_`` with call 0's dropout masks of ``seed``;
    no update."""
    from sls_tpu_torch.train.steps import dequantize_wire, dropout_generator, train_loss

    model.zero_grad(set_to_none=True)
    wav, labels, valid = batch_
    loss, _, out = train_loss(model, tcfg, dequantize_wire(wav), labels, valid,
                              dropout_generator(seed, 0, device))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out["codes"].detach(), grads


def time_train_steps(torch, step, state, batch_, seed, device, n_steps):
    """utts/s of ``n_steps`` train steps on the host clock, ending in a
    synchronize, and the host's ms to enqueue one more (no wait)."""
    sync(torch, device)
    t0 = time.perf_counter()
    losses = [step(state, *batch_, seed)[1]["loss"] for _ in range(n_steps)]
    sync(torch, device)
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(state, *batch_, seed)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    sync(torch, device)
    return {"utts_per_s": n_steps * batch_[0].shape[0] / seconds,
            "ms_per_step": seconds * 1e3 / n_steps, "enqueue_ms": enqueue_ms,
            "losses": [float(x) for x in losses]}


# kernel-name fragments of the train step's device time by category
# (first match wins): the convs' cuDNN kernels, the GEMMs, the port's own
TRAIN_CATEGORIES = (("conv_cudnn", ("cudnn", "dgrad", "wgrad", "fprop", "conv")),
                    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
                    ("own_kernels", OWN_KERNELS))


def profile_train_step(torch, tk, model, einsum_pos_conv, state, step, batch_, tcfg, seed,
                       frames, device) -> dict:
    """The train step's device time by kernel and by category (one step a
    rep, updating ``state``), and, timed alone with CUDA events at the
    step's shapes: the SAE backward's four fp32 GEMMs (rows 1 and 2) and
    their share of the step, the optimizer's update, and the positional
    conv's forward and backward on its cuDNN route (as it runs, and with
    cuDNN's autotuner on) and on its per-tap einsum route
    (``einsum_pos_conv``, the same weights)."""
    from sls_tpu_torch.train.steps import make_optimizer

    prof = device_time_by_kernel(lambda: step(state, *batch_, seed), reps=3)
    by_name = prof.pop("by_name_ms")
    cats = {label: 0.0 for label, _ in TRAIN_CATEGORIES}
    cats["other"] = 0.0
    for name, ms in by_name.items():
        label = next((label for label, parts in TRAIN_CATEGORIES
                      if any(part in name for part in parts)), "other")
        cats[label] += ms
    prof["by_category_ms_per_step"] = cats
    prof["own_kernels_ms_per_step"] = {
        name: sum(ms for key, ms in by_name.items() if name in key) for name in OWN_KERNELS}

    sae = model.sae
    n = batch_[0].shape[0] * frames
    feats = torch.randn(n, sae.W_enc.shape[0], device=device)
    codes = tk.sae_encode_topk_fused(feats, sae.W_enc, sae.b_enc, sae.b_dec, sae.config.k)
    g_codes, g_recon = torch.randn_like(codes), torch.randn_like(feats)
    prof["sae_backward_gemms_ms"] = timed(
        torch, lambda: (tk.encode_backward(feats, sae.W_enc, sae.b_dec, codes, g_codes),
                        tk.decode_backward(codes, sae.W_dec, g_recon)), device, 10)
    prof["sae_backward_gemms_share"] = prof["sae_backward_gemms_ms"] / prof["device_ms_per_step"]
    del feats, codes, g_codes, g_recon

    zeros = [torch.zeros_like(p) for p in state.params]
    adam, keep = make_optimizer(tcfg.lr, tcfg.weight_decay), torch.zeros((), dtype=torch.bool,
                                                                          device=device)

    def update():  # the guard holds: the same work, no change
        for p, z in zip(state.params, zeros):
            p.grad = z
        adam.apply(state, keep)

    prof["optimizer_update_ms"] = timed(torch, update, device, 5)
    del zeros

    pos = model.encoder.pos_conv
    x = torch.randn(batch_[0].shape[0], frames, pos.config.embed_dim, dtype=pos.config.dtype,
                    device=device, requires_grad=True)
    g = torch.randn_like(x)

    def fwd_bwd(conv):
        return lambda: torch.autograd.backward(conv(x), g)

    routes = {"cudnn": timed(torch, fwd_bwd(pos), device, 5)}
    torch.backends.cudnn.benchmark = True
    try:
        routes["cudnn_autotuned"] = timed(torch, fwd_bwd(pos), device, 5)
    finally:
        torch.backends.cudnn.benchmark = False
    routes["einsum"] = timed(torch, fwd_bwd(einsum_pos_conv), device, 5)
    model.zero_grad(set_to_none=True)
    prof["pos_conv_fwd_bwd_ms"] = routes
    return prof


def max_rel(a, b) -> float:
    """max|a - b| over max|b|, in fp64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max())


def phase_rawboost(torch, rb, rcfg, x, device, iters) -> dict:
    """Phase 14 (a): every algorithm on the batch ``x`` (finite, same
    shape, ms by CUDA events), ISD's modified share, SSI's SNR, and the
    deterministic parts on the device against fp64 on the CPU."""
    out = {"ms_per_batch": {}}
    for algo in range(1, 9):
        cfg = dataclasses.replace(rcfg, algo=algo)

        def run(cfg=cfg, algo=algo):
            return rb.rawboost_batch(torch.Generator(device=device).manual_seed(algo), x, cfg,
                                     device=device)

        y = run()
        check(y.shape == x.shape and bool(torch.isfinite(y).all()),
              f"RawBoost algorithm {algo}: finite, of the input's shape")
        out["ms_per_batch"][algo] = timed(torch, run, device, iters)
        if algo == 2:
            share = float((y != x).float().mean(-1).max())
            out["isd_max_modified_share"] = share
            check(share <= rcfg.P / 100.0, f"ISD modifies at most {rcfg.P} % of a row's samples")
        if algo == 3:
            snr = 20 * torch.log10(x.norm(dim=-1) / (y - x).norm(dim=-1))
            out["ssi_snr_db"] = [float(snr.min()), float(snr.max())]
            check(bool(((snr >= rcfg.SNRmin - RAWBOOST_SNR_TOL)
                         & (snr <= rcfg.SNRmax + RAWBOOST_SNR_TOL)).all()),
                  f"SSI's SNR lies in [{rcfg.SNRmin}, {rcfg.SNRmax}] dB")
    max_taps, max_total = rb._filter_sizes(rcfg)
    gen = torch.Generator(device=device).manual_seed(5)
    draw = rb.draw_notch(gen, (x.shape[0],), rcfg)
    b, length = rb.notch_coeffs(draw, rcfg, 16000.0, max_taps, max_total)
    b64, length64 = rb.notch_coeffs(draw.to("cpu", torch.float64), rcfg, 16000.0, max_taps,
                                    max_total)
    taps = torch.randn(x.shape[0], max_total, generator=gen, device=device)
    det = {"cascade": max_rel(b, b64),
           "filter_fir": max_rel(rb.filter_fir(x, b, length),
                                 rb.filter_fir(x.cpu().double(), b64, length64)),
           "freqz_peak": max_rel(rb._freqz_peak(taps), rb._freqz_peak(taps.cpu().double()))}
    out["deterministic_vs_fp64"] = det
    check(torch.equal(length.cpu(), length64), "the cascade lengths agree")
    check(all(v <= RAWBOOST_DET_TOL for v in det.values()),
          f"RawBoost's deterministic parts on the device are within {RAWBOOST_DET_TOL} of fp64")
    return out


def trainer_bits_equal(torch, a, b) -> bool:
    """Every parameter and both moments of two Trainers, bit for bit."""
    def bits(t):
        return t.detach().contiguous().view(torch.int32)

    theirs = dict(b.model.named_parameters())
    return (all(torch.equal(bits(p), bits(theirs[n])) for n, p in a.model.named_parameters())
            and torch.equal(bits(a.state.exp_avg), bits(b.state.exp_avg))
            and torch.equal(bits(a.state.exp_avg_sq), bits(b.state.exp_avg_sq)))


def trainer_diff(torch, a, b) -> float:
    """max |difference| over every parameter and moment of two Trainers."""
    theirs = dict(b.model.named_parameters())
    diffs = [float((p.detach() - theirs[n].detach()).abs().max())
             for n, p in a.model.named_parameters()]
    diffs += [float((a.state.exp_avg - b.state.exp_avg).abs().max()),
              float((a.state.exp_avg_sq - b.state.exp_avg_sq).abs().max())]
    return max(diffs)


def csv_rows(run_dir: Path) -> list:
    with open(run_dir / "training_log.csv") as f:
        return list(csv.DictReader(f))


def row_diff(a: dict, b: dict) -> float:
    """max |difference| over two CSV rows' numeric fields but the wall time."""
    return max(abs(float(a[k]) - float(b[k])) for k in a if k not in ("epoch", "epoch_seconds"))


def epoch_with_sync_count(torch, trainer, loader, epoch):
    """(seconds on the host clock, the syncs the epoch loop asked for
    outside its bounding waits, those waits' own, each as the file:line
    chain of its call) of ``trainer.train_epoch``.  Two counters: torch's
    sync debug mode, which warns at each synchronising call the host
    makes through torch's own checks (a blocking copy, ``.item()``, a
    stream or device synchronize), and a wrapper of
    ``torch.cuda.Event.synchronize``, which that mode does not see.  Both
    are off inside ``_finish_epoch``, the epoch's one fetch, so what
    they count is the loop's; an event wait under ``loop.py``'s
    ``_wait`` is a bounding wait (the host waits for the step eight
    behind, and for nothing newer)."""
    import traceback
    import warnings

    finish = trainer._finish_epoch
    event_sync = torch.cuda.Event.synchronize
    counting = [True]

    def quiet_finish(*a, **kw):
        torch.cuda.set_sync_debug_mode(0)
        counting[0] = False
        return finish(*a, **kw)

    loop_syncs, waits = [], []

    def record():
        stack = [f for f in traceback.extract_stack()[:-2]
                 if not f.filename.endswith("warnings.py")]
        chain = [f"{Path(f.filename).name}:{f.lineno}:{f.name}" for f in stack[-6:]]
        in_wait = any(f.name == "_wait" and f.filename.endswith("loop.py") for f in stack)
        (waits if in_wait else loop_syncs).append(" < ".join(reversed(chain)))

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            record()  # not e.g. set_sync_debug_mode's own note that it is experimental

    def counted_event_sync(event):
        if counting[0]:
            record()
        return event_sync(event)

    trainer._finish_epoch = quiet_finish
    torch.cuda.Event.synchronize = counted_event_sync
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            trainer.train_epoch(loader, epoch)
            seconds = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.Event.synchronize = event_sync
        del trainer._finish_epoch
    return seconds, loop_syncs, waits


def synthetic_wavs(n: int, cut: int, seed: int) -> np.ndarray:
    """Noise with a per-utterance tone, so utterances differ."""
    rng = np.random.default_rng(seed)
    t = np.arange(cut, dtype=np.float32) / 16000.0
    f = rng.uniform(100.0, 4000.0, size=(n, 1)).astype(np.float32)
    wav = 0.1 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal((n, cut))
    return wav.astype(np.float32)


# Phase 15, offline evaluation from files on disk
OFFLINE_EPOCH = 7       # the reference checkpoint's epoch: a resume starts at 8
OFFLINE_SIZES = {"cuda": (170, 20, 20), "cpu": (12, 6, 5)}  # FLAC files, WAVs, timed batches
POS_CONV_REL_L2 = 1e-6  # the pos-conv through weight norm and back (fp32 rounding of the fold)
POS_CONV_KEY = "encoder.pos_conv.conv.weight"
OFFLINE_FREE = 3        # the disk must hold three times the weight files' bytes


def flac_bytes(channels, rate: int) -> bytes:
    """A FLAC stream of int16 ``channels`` (16-bit, verbatim subframes, one
    frame a 4096-sample block): the byte-aligned subset of the format,
    written with numpy.  CRCs are zero; the decoder does not check them."""
    n, n_ch, block = len(channels[0]), len(channels), 4096
    head = bytearray(b"fLaC")
    head += bytes([0x80, 0, 0, 34])  # STREAMINFO, the last metadata block
    head += block.to_bytes(2, "big") * 2 + bytes(6)
    packed = (rate << 44) | ((n_ch - 1) << 41) | (15 << 36) | n  # rate, channels, bps-1, total
    head += packed.to_bytes(8, "big") + bytes(16)  # and an md5 of zeros
    sr_code = {16000: 5, 44100: 9, 48000: 10}.get(rate, 0)  # 0: the rate from STREAMINFO
    parts = [bytes(head)]
    for idx, start in enumerate(range(0, n, block)):
        bs = min(block, n - start)
        hdr = bytearray([0xFF, 0xF8, (7 << 4) | sr_code, ((n_ch - 1) << 4) | (4 << 1)])
        if idx < 0x80:  # the frame number, UTF-8 coded
            hdr.append(idx)
        elif idx < 0x800:
            hdr += bytes([0xC0 | (idx >> 6), 0x80 | (idx & 0x3F)])
        else:
            hdr += bytes([0xE0 | (idx >> 12), 0x80 | ((idx >> 6) & 0x3F), 0x80 | (idx & 0x3F)])
        hdr += (bs - 1).to_bytes(2, "big") + b"\x00"  # block size - 1, CRC-8
        parts.append(bytes(hdr))
        for ch in channels:
            parts.append(b"\x02")  # verbatim subframe, no wasted bits
            parts.append(np.asarray(ch[start:start + bs], ">i2").tobytes())
        parts.append(b"\x00\x00")  # CRC-16
    return b"".join(parts)


def write_wav16(path: Path, samples: np.ndarray, rate: int = 16000) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.asarray(samples, "<i2").tobytes())


_HF_CONV = {"0.weight": "conv.weight", "0.bias": "conv.bias",
            "2.1.weight": "layer_norm.weight", "2.1.bias": "layer_norm.bias",
            "2.weight": "layer_norm.weight", "2.bias": "layer_norm.bias"}


def hf_encoder_state(fairseq: dict) -> dict:
    """The HuggingFace ``Wav2Vec2Model`` naming (``wav2vec2.`` prefixed) of
    a fairseq encoder state dict."""
    out = {}
    for k, v in fairseq.items():
        if k.startswith("feature_extractor.conv_layers."):
            i, tail = k[len("feature_extractor.conv_layers."):].split(".", 1)
            k = f"feature_extractor.conv_layers.{i}.{_HF_CONV[tail]}"
        elif k.startswith("layer_norm."):
            k = "feature_projection." + k
        elif k.startswith("post_extract_proj."):
            k = k.replace("post_extract_proj.", "feature_projection.projection.")
        elif k.startswith("encoder.pos_conv.0."):
            k = k.replace("encoder.pos_conv.0.", "encoder.pos_conv_embed.conv.")
        elif k.startswith("encoder.layers."):
            k = (k.replace(".self_attn_layer_norm.", ".layer_norm.")
                 .replace(".self_attn.", ".attention.")
                 .replace(".fc1.", ".feed_forward.intermediate_dense.")
                 .replace(".fc2.", ".feed_forward.output_dense."))
        out["wav2vec2." + k] = v
    return out


def fairseq_checkpoint(enc_state: dict) -> dict:
    """A dict shaped like a real fairseq wav2vec2 save: the encoder under
    ``model`` and an ``argparse.Namespace`` payload, which
    ``torch.load(weights_only=True)`` refuses."""
    args = argparse.Namespace(arch="wav2vec2", extractor_mode="layer_norm",
                              encoder_layers=24, encoder_embed_dim=1024, fp16=False)
    return {"args": args, "cfg": {"model": vars(args), "task": {"_name": "audio_pretraining"}},
            "model": enc_state, "optimizer_history": [{"num_updates": 0}],
            "extra_state": {}, "last_optimizer_state": {}}


def bits_equal(torch, got: dict, want: dict, skip=()) -> list:
    """The keys of ``want`` whose tensors differ from ``got``'s in any bit
    (a missing or extra key counts too), ``skip`` left out."""
    bad = sorted(set(got) ^ set(want))
    for k, v in want.items():
        if k in got and k not in skip:
            a, b = got[k].detach().cpu(), v.detach().cpu()
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                bad.append(k)
    return bad


def phase_offline(torch, device, exp, model, batch: int, seed: int, counts, zero_counts,
                  want_only, eval_utts_per_s) -> dict:
    """Phase 15: offline evaluation from files on disk at the flagship's
    width, on its weights (module docstring).  Returns the ``offline``
    figures of the run line."""
    from sls_tpu_torch.ckpt.checkpoint import save_checkpoint, to_host
    from sls_tpu_torch.config import config_to_json
    from sls_tpu_torch.convert import (
        detector_state_from_reference,
        detector_state_to_reference,
        load_pretrained_encoder,
    )
    from sls_tpu_torch.data.pipeline import ArrayLoader, BatchLoader, DatasetIndex
    from sls_tpu_torch.data.protocols import parse_eval_list
    from sls_tpu_torch.metrics.eer import compute_eer
    from sls_tpu_torch.scores.evaluate import score_2021_df, score_2021_la, score_in_the_wild
    from sls_tpu_torch.scores.standalone import score_2019_protocol, score_2021_metadata
    from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.scorer import build_scorer
    from sls_tpu_torch.train.loop import Trainer, produce_scores

    on_card = device.type == "cuda"
    cfg, cut = exp.model, exp.train.cut_length
    n_flac, n_wild, n_timed = OFFLINE_SIZES[device.type]
    res = {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_offline_"))
    try:
        src = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        weight_bytes = sum(v.numel() * v.element_size() for v in src.values())
        free = shutil.disk_usage(work).free
        res["disk"] = {"dir": str(work), "free_gb": free / 1e9,
                       "weights_gb": weight_bytes / 1e9}
        check(free >= OFFLINE_FREE * weight_bytes,
              f"{work} must hold {OFFLINE_FREE * weight_bytes / 1e9:.1f} GB of weight files "
              f"and has {free / 1e9:.1f} GB free: point TMPDIR at a larger disk")

        # (a) weights out in the reference's namings and back
        ref = detector_state_to_reference(src, cfg)
        enc_fs = {k[len("ssl_model.model."):]: v for k, v in ref.items()
                  if k.startswith("ssl_model.model.")}
        files = {"epoch_7.pth": {"model": {"module." + k: v for k, v in ref.items()},
                                 "epoch": OFFLINE_EPOCH},
                 "xlsr_fairseq.pt": fairseq_checkpoint(enc_fs),
                 "xlsr_hf.pt": hf_encoder_state(enc_fs)}
        weights = {}
        for name, obj in files.items():
            t0 = time.perf_counter()
            torch.save(obj, work / name)
            weights[name] = {"gb": (work / name).stat().st_size / 1e9,
                             "save_s": time.perf_counter() - t0}
        del files, ref, enc_fs
        enc_src = {k[len("encoder."):]: v for k, v in src.items() if k.startswith("encoder.")}
        t0 = time.perf_counter()
        W = detector_state_from_reference(
            torch.load(work / "epoch_7.pth", map_location="cpu", weights_only=True)["model"], cfg)
        weights["epoch_7.pth"]["load_s"] = time.perf_counter() - t0
        loaded = {"epoch_7.pth": (W, src)}
        for name in ("xlsr_fairseq.pt", "xlsr_hf.pt"):
            t0 = time.perf_counter()
            enc = load_pretrained_encoder(work / name, cfg.encoder)
            weights[name]["load_s"] = time.perf_counter() - t0
            loaded[name] = (enc, enc_src)
        for name, (got, want) in loaded.items():
            key = POS_CONV_KEY if name == "epoch_7.pth" else POS_CONV_KEY[len("encoder."):]
            bad = bits_equal(torch, got, want, skip=(key,))
            weights[name]["pos_conv_rel_l2"] = rel_l2(got[key], want[key])
            weights[name]["tensors_not_bit_equal"] = bad
            check(not bad, f"{name}: every tensor but the pos-conv reloads bit for bit ({bad[:4]})")
            check(weights[name]["pos_conv_rel_l2"] <= POS_CONV_REL_L2,
                  f"{name}: the pos-conv reloads within {POS_CONV_REL_L2} (relative L2)")
        del loaded
        res["weights"] = weights
        log(f"phase 15 (a) weights written and read back: {json.dumps(weights)}")

        # (b) a fresh Trainer with other weights resumes from the .pth: W
        r_exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, seed=seed + 15, batch_size=batch))
        trainer = Trainer(r_exp, work / "resumed", tensorboard=False, device=device)
        trainer.init_state()
        check(bool(bits_equal(torch, trainer.model.state_dict(), W)),
              "the fresh Trainer starts from other weights")
        t0 = time.perf_counter()
        check(trainer.resume(work / "epoch_7.pth") and trainer.start_epoch == OFFLINE_EPOCH + 1,
              f"the Trainer resumes from epoch_7.pth at epoch {OFFLINE_EPOCH + 1}")
        res["resume_s"] = time.perf_counter() - t0
        check(not bits_equal(torch, trainer.model.state_dict(), W),
              "the resumed Trainer holds the reloaded weights W bit for bit")
        log(f"phase 15 (b) Trainer.resume(epoch_7.pth) in {res['resume_s']:.2f} s: start "
            f"epoch {trainer.start_epoch}, weights bit-equal to W")
        step = trainer.eval_step

        # (c) the files: FLAC under the 2021 DF layout, WAVs under In-the-Wild's
        rng = np.random.default_rng(seed + 16)
        db = work / "db"
        flac_dir = db / "ASVspoof2021_DF_eval" / "flac"
        wild_dir = db / "release_in_the_wild"
        flac_dir.mkdir(parents=True)
        wild_dir.mkdir(parents=True)
        ids = [f"DF_E_{i:07d}" for i in range(n_flac)]
        labels = rng.permutation(np.arange(n_flac) % 2)
        special = {0: "rate_8k", 1: "rate_44k", 2: "truncated", 3: "stereo"}
        for i, u in enumerate(ids):
            rate = {0: 8000, 1: 44100}.get(i, 16000)
            n = int(rng.uniform(0.5, 10.0) * rate)
            t = np.arange(n) / rate
            x = 0.1 * rng.standard_normal(n) + labels[i] * 0.3 * np.sin(
                2 * np.pi * rng.uniform(100, 3000) * t)
            ch = [np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)]
            if i == 3:
                ch.append(np.round(np.clip(0.1 * rng.standard_normal(n), -1, 1) * 32767
                                   ).astype(np.int16))
            blob = flac_bytes(ch, rate)
            (flac_dir / f"{u}.flac").write_bytes(blob[:20] if i == 2 else blob)
        exact = [i for i in range(n_flac) if i not in (0, 1, 3)]  # 16 kHz mono 16-bit
        (work / "ASVspoof2021.DF.cm.eval.trl.txt").write_text("".join(u + "\n" for u in ids))
        (work / "ASVspoof2019.LA.cm.eval.trl.txt").write_text("".join(
            f"LA_{i % 67:04d} {u} - {'-' if lab else f'A{7 + i % 13:02d}'} "
            f"{'bonafide' if lab else 'spoof'}\n" for i, (u, lab) in enumerate(zip(ids, labels))))
        wild_ids = [f"{i}.wav" for i in range(n_wild)]
        wild_labels = rng.permutation(np.arange(n_wild) % 2)
        for i, w in enumerate(wild_ids):
            n = int(rng.uniform(0.5, 10.0) * 16000)
            write_wav16(wild_dir / w, np.round(np.clip(0.1 * rng.standard_normal(n), -1, 1)
                                               * 32767).astype(np.int16))
        (work / "in_the_wild.eval.txt").write_text("".join(w + "\n" for w in wild_ids))
        audio_mb = sum(p.stat().st_size for p in db.rglob("*") if p.is_file()) / 1e6
        log(f"phase 15 (c) {n_flac} FLAC files ({special}, 0.5-10 s) and {n_wild} WAVs, "
            f"{audio_mb:.1f} MB, under {db}")
        res["files"] = {"flac": n_flac, "wav": n_wild, "mb": audio_mb, "special": special}

        # (d) offline scoring: eval list -> DatasetIndex -> BatchLoader -> produce_scores
        listed = parse_eval_list(work / "ASVspoof2021.DF.cm.eval.trl.txt")
        index = DatasetIndex.for_eval(listed, db / "ASVspoof2021_DF_eval")
        loader = BatchLoader(index, batch, cut=cut, wire_dtype="int16")
        n_batches = loader.num_batches()
        step(np.zeros((batch, cut), np.int16))  # one-time setup outside the counted run
        sync(torch, device)
        zero_counts()
        t0 = time.perf_counter()
        written = trainer.produce_scores(loader, work / "scores_DF.txt")
        files_s = time.perf_counter() - t0
        launches = counts()
        if on_card:
            want_only("offline produce_scores from files", launches,
                      {"sae_encode_topk_fused": n_batches, "sae_decode_fused": n_batches})
        got_ids, got = read_score_file(work / "scores_DF.txt")
        check(written == n_flac and got_ids == ids, "one score line per file, in list order")
        check(bool(np.all(np.isfinite(got))), "every score is finite")

        def decoded(ldr):
            return np.concatenate([b.wav[b.valid] for b in ldr.epoch(0)])

        def scores_of(arrays, names, out):
            produce_scores(step, ArrayLoader(arrays, None, utt_ids=list(names),
                                             batch_size=batch), out)
            return read_score_file(out)

        rows_i16 = decoded(loader)
        ids_m, mem = scores_of(rows_i16, ids, work / "scores_mem.txt")
        check(ids_m == ids and np.array_equal(got, mem),
              "file-backed scores equal the eval step's over the same decoded arrays, bit for bit")
        check(not rows_i16[2].any(), "the truncated file decodes to a zero row")
        zero = float(log_probs_to_scores(step(np.zeros((batch, cut), np.int16))["log_probs"])[0])
        d_zero = abs(float(got[2]) - zero)
        check(d_zero <= SCORES_TOL, "the truncated file scores as a zero waveform")
        loader32 = BatchLoader(index, batch, cut=cut, wire_dtype="float32")
        produce_scores(step, loader32, work / "scores_f32.txt")
        _, got32 = read_score_file(work / "scores_f32.txt")
        check(np.array_equal(got32[exact], got[exact]),
              "the float32 wire scores the 16 kHz mono 16-bit files as the int16 wire does, "
              "bit for bit")
        off_rows = {special[i]: float(abs(got32[i] - got[i])) for i in (0, 1, 3)}
        missing = DatasetIndex.for_eval(listed + ["DF_E_missing"], db / "ASVspoof2021_DF_eval")
        try:
            produce_scores(step, BatchLoader(missing, batch, cut=cut, wire_dtype="int16"),
                           work / "scores_missing.txt")
            raised = None
        except FileNotFoundError as e:
            raised = str(e)
        check(raised is not None, "a list naming a missing file raises FileNotFoundError")
        wild_index = DatasetIndex.for_in_the_wild(
            parse_eval_list(work / "in_the_wild.eval.txt"), wild_dir)
        wild_loader = BatchLoader(wild_index, batch, cut=cut, wire_dtype="int16")
        produce_scores(step, wild_loader, work / "scores_wild.txt")
        wild_got_ids, wild_got = read_score_file(work / "scores_wild.txt")
        _, wild_mem = scores_of(decoded(wild_loader), wild_ids, work / "scores_wild_mem.txt")
        check(wild_got_ids == wild_ids and np.array_equal(wild_got, wild_mem),
              "In-the-Wild WAV scores equal the eval step's over the same decoded arrays")
        res["scoring"] = {"batches": n_batches, "seconds": files_s, "launches": launches,
                          "truncated_vs_zero_abs": d_zero, "float32_vs_int16_abs": off_rows,
                          "missing_file_error": raised}
        log(f"phase 15 (d) {json.dumps(res['scoring'])}")

        # (e) serving the same files from a port run directory
        serve_dir = work / "serve"
        save_checkpoint(serve_dir / "last.ckpt", {"model": to_host(trainer.model.state_dict())},
                        epoch=OFFLINE_EPOCH, config_json=config_to_json(r_exp))
        _, score_fn, cut_s = build_scorer(serve_dir, wire_dtype="int16", batch_size=batch,
                                          device=device)
        check(cut_s == cut, "the run directory's config gives the cut length")
        with BatchingEngine(score_fn, batch, cut=cut, wire_dtype="int16",
                            max_wait_ms=2000) as engine:
            futures = [engine.submit(row.astype(np.float32) / 32768.0) for row in rows_i16]
            served = np.array([f.result(timeout=300) for f in futures])
            stats = engine.stats().to_dict()
        check(np.array_equal(served, got),
              "build_scorer(run_dir) through BatchingEngine serves the offline scores bit for bit")
        res["serving"] = {"batches": stats["batches"], "requests": stats["requests"]}
        log(f"phase 15 (e) served {stats['requests']} files in {stats['batches']} batches from "
            f"{serve_dir}: equal to the offline score file bit for bit")

        # (f) the official scorers over organiser key files
        keys = work / "keys"
        for sub in ("LA/ASV/ASVTorch_Kaldi", "LA/CM", "CM"):
            (keys / sub).mkdir(parents=True)
        kinds = np.array(["target", "nontarget", "spoof"])[np.arange(300) % 3]
        asv = rng.normal(np.select([kinds == "target", kinds == "nontarget"], [2.0, -2.0], 0.5))
        (keys / "LA/ASV/trial_metadata.txt").write_text("".join(
            f"LA_{i % 67:04d} LA_E_A{i:07d} - - - {k} - eval\n" for i, k in enumerate(kinds)))
        (keys / "LA/ASV/ASVTorch_Kaldi/score.txt").write_text("".join(
            f"LA_{i % 67:04d} LA_E_A{i:07d} {float(s)!r}\n" for i, s in enumerate(asv)))
        cm = "".join(f"LA_{i % 67:04d} {u} - - - {'bonafide' if lab else 'spoof'} - eval\n"
                     for i, (u, lab) in enumerate(zip(ids, labels)))
        (keys / "LA/CM/trial_metadata.txt").write_text(cm)
        (keys / "CM/trial_metadata.txt").write_text(cm)
        (keys / "in_the_wild_key.txt").write_text("".join(
            f"speaker {w} - - - {'bona-fide' if lab else 'spoof'}\n"
            for w, lab in zip(wild_ids, wild_labels)))
        la = score_2021_la(str(work / "scores_DF.txt"), str(keys))
        df = score_2021_df(str(work / "scores_DF.txt"), str(keys))
        wild = score_in_the_wild(str(work / "scores_wild.txt"), str(keys / "in_the_wild_key.txt"))
        p19 = score_2019_protocol(str(work / "scores_DF.txt"),
                                  str(work / "ASVspoof2019.LA.cm.eval.trl.txt"))
        meta = score_2021_metadata(str(work / "scores_DF.txt"), str(keys / "LA/CM/trial_metadata.txt"))
        eer_mem = compute_eer(mem[labels == 1], mem[labels == 0])[0]
        eer_wild = compute_eer(wild_mem[wild_labels == 1], wild_mem[wild_labels == 0])[0]
        official = {"la_eer": la.eer, "la_min_tdcf": la.min_tdcf,
                    "la_inverted_is_better": la.inverted_is_better, "df_eer": df.eer,
                    "wild_eer": wild.eer, "p2019_eer": p19["eer"],
                    "p2019_eer_interp": p19["eer_interp"], "metadata_eer": meta["eer"],
                    "metadata_min_dcf": meta["min_dcf"], "eer_in_memory": eer_mem,
                    "wild_eer_in_memory": eer_wild}
        log(f"phase 15 (f) official scoring (random weights: chance-level EERs expected): "
            f"{json.dumps(official)}")
        check(la.eer == df.eer == p19["eer"] == meta["eer"] == eer_mem,
              "every scorer's EER equals compute_eer on the in-memory scores")
        check(wild.eer == eer_wild, "the In-the-Wild EER equals compute_eer on its scores")
        check(math.isfinite(la.min_tdcf), "min t-DCF is finite")
        res["official"] = official

        # (g) speed: produce_scores from files, and decoding alone
        reps = [ids[i % n_flac] for i in range(n_timed * batch)]
        timed_index = DatasetIndex.for_eval(reps, db / "ASVspoof2021_DF_eval")
        timed_loader = BatchLoader(timed_index, batch, cut=cut, wire_dtype="int16")
        for _ in timed_loader.epoch(0):  # every file read once: the page cache holds them
            pass
        spans = []

        def timed_step(wav):
            if not on_card:
                return step(wav)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(wav)
            end.record()
            spans.append((start, end))
            return out

        sync(torch, device)
        t0 = time.perf_counter()
        produce_scores(timed_step, timed_loader, work / "scores_timed.txt")
        sync(torch, device)
        wall = time.perf_counter() - t0
        busy = (sum(a.elapsed_time(b) for a, b in spans) / 1e3 / wall) if on_card else None
        t0 = time.perf_counter()
        for _ in timed_loader.epoch(0):
            pass
        decode_s = time.perf_counter() - t0
        producers, threads = timed_loader.producers_and_decode_threads()
        speed = {"utts": len(reps), "batches": n_timed, "page_cached": True,
                 "produce_scores_utts_per_s": len(reps) / wall,
                 "decode_only_utts_per_s": len(reps) / decode_s,
                 "eval_step_in_memory_utts_per_s": eval_utts_per_s,
                 "device_busy_share": busy, "cpu_count": os.cpu_count(),
                 "producers": producers, "decode_threads_per_producer": threads}
        log(f"phase 15 (g) {json.dumps(speed)}")
        res["speed"] = speed
        del trainer, W
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return res


# Phases 16-17, the SLS family and the CPC variant at full width
SLS_TRAINER_SIZES = {"cuda": (14, 28, 14), "cpu": (4, 8, 4)}  # batch, train, val utterances
SLS_STATS_REL = 1e-6  # the running statistics against 0.9 old + 0.1 batch (fp32, one rounding)
SLS_ZERO_FIELDS = ("train_cls_loss", "train_sae_loss", "train_cpc_loss", "val_sae_loss")
SLS_PTH_STEP_EPOCH = 3  # the upstream .pth's epoch: a resume from it starts at 4
# one batch fitted: at FIT_LR Adam's sign-sized first steps move fc1's
# 22,847 inputs together, and the loss overshot at the sixth step (1.94
# down to 0.29, then 9.60, on the H100), so the SLS fit takes a tenth
SLS_FIT_LR = FIT_LR / 10
# Phase 17 holds the CPC step through rows 3 and 2 to their plain versions
# in TRAIN_ENVELOPE's form.  Both rows are fp32-accurate, and their plain
# versions are the fp32 SAE route itself (the same fp32 matmuls), so the
# envelope is the rounding one level up: the plain step against the same
# step with the SAE's forward in fp64.
CPC_STEPS = (1, 2, 4)
# ... with a floor.  On the H100 three bias gradients, each a sum over
# every row of a cotangent (the last two attention output projections'
# and the classifier's first layer's), lay 3.7e-5 (relative L2) from the
# plain step's, 14x an envelope of 2.6e-6, while the loss and the CPC
# loss were bit-equal, the window supports equal, and the other 435
# gradients inside the envelope.  A gradient within this relative L2 of
# the plain step's passes too (the bound of tests/test_torch_cpc.py's
# card test); PERF.md section 7 keeps the three open.
CPC_GRAD_FLOOR = 1e-3


def sls_fp32_head(torch, head, x):
    """The SLS head's classification of fc1's input ``x`` with fc1 in fp32
    (the rest of the head is fp32 already)."""
    import torch.nn.functional as F

    h = F.selu(F.linear(x.float(), head.fc1.weight, head.fc1.bias))
    return torch.log_softmax(F.selu(head.fc3(h)), dim=-1)


def sls_reference_bf16_head(torch, head, x):
    """The reference's bf16 fc1 (flax ``Dense(dtype=bf16)``): x @ W
    rounded to bf16, then the bias added in bf16; the rest as the head."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    h = (x.to(bf16) @ head.fc1.weight.to(bf16).t()) + head.fc1.bias.to(bf16)
    h = F.selu(h.float())
    return torch.log_softmax(F.selu(head.fc3(h)), dim=-1)


def phase_sls(torch, device, enc_cfg, cut: int, batch: int, wire, wavs, seed: int, counts,
              zero_counts, want_only, flagship_eval_utts_per_s, train_batches) -> dict:
    """Phase 16: the SLS family at full width (module docstring).  Returns
    the ``sls`` figures of the run line."""
    from sls_tpu_torch import config as C
    from sls_tpu_torch.convert import (
        sls_detector_state_from_reference,
        sls_detector_state_to_reference,
    )
    from sls_tpu_torch.data.audio import pad_or_tile
    from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
    from sls_tpu_torch.models.sls import (
        SLSDetector,
        SLSTrainer,
        create_sls_train_state,
        layer_gate_profile,
        make_sls_eval_step,
        make_sls_train_step,
    )
    from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.scorer import build_scorer
    from sls_tpu_torch.train.loop import produce_scores
    from sls_tpu_torch.train.steps import dequantize_wire, dropout_generator

    on_card = device.type == "cuda"
    cfg = C.ModelConfig(encoder=enc_cfg, use_sae=False)
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(cut_length=cut))
    model = SLSDetector(cfg, device=device, cut_length=cut,
                        generator=torch.Generator(device=device).manual_seed(seed + 16))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res = {"fc1_inputs": model.sls_head.fc1.weight.shape[1]}

    def restore():
        model.load_state_dict(init, strict=True)

    # (a) the eval step at the serving batch: no kernel, throughput, envelope
    step = make_sls_eval_step(model, device=device)
    step(wire[:batch])
    sync(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        written = produce_scores(step, ArrayLoader(wire, None, batch_size=batch),
                                 Path(tmp) / "scores.txt")
        launches = counts()
        ids, scores = read_score_file(Path(tmp) / "scores.txt")
    res["launches"] = launches
    check(written == len(wire) and len(ids) == len(wire), "one SLS score line per utterance")
    check(bool(np.all(np.isfinite(scores)) and np.all((scores >= 0) & (scores <= 1))),
          "every SLS score is finite and in [0, 1]")
    check(all(c == 0 for c in launches.values()),
          f"the SLS eval path launches no hand-written kernel: {launches}")
    reps = 10 if on_card else 1
    batch_wire = wire[:batch]
    step(batch_wire)
    sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(reps):
        step(batch_wire)
    sync(torch, device)
    res["eval_utts_per_s"] = reps * batch / (time.perf_counter() - t0)
    res["flagship_eval_utts_per_s"] = flagship_eval_utts_per_s
    if on_card:
        res["eval_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with torch.inference_mode():
        w = dequantize_wire(torch.from_numpy(batch_wire).to(device))
        _, hiddens = model.encoder(w, return_hidden_states=True)
        x, _ = model.sls_head.pooled(hiddens)
        port = model.sls_head.classify(x)
        truth = sls_fp32_head(torch, model.sls_head, x)
        ref = sls_reference_bf16_head(torch, model.sls_head, x)
        eval_lp = step(batch_wire)["log_probs"]
        # for the record: fc1 as cuBLAS's bf16 linear, with its reduced-
        # precision split-K reduction allowed (PyTorch's default) and not
        cublas = {}
        flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        for allowed in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allowed
            h = torch.nn.functional.selu(model.sls_head.fc1(x).float())
            lp = torch.log_softmax(torch.nn.functional.selu(model.sls_head.fc3(h)), dim=-1)
            cublas[f"reduced_precision_{allowed}"] = rel_l2(lp, truth)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    env = {"port_vs_fp32": rel_l2(port, truth), "reference_bf16_vs_fp32": rel_l2(ref, truth),
           "port_vs_reference_bf16": rel_l2(port, ref),
           "cublas_bf16_linear_vs_fp32": cublas,
           "eval_step_vs_pieces_max_abs": float((eval_lp - port).abs().max())}
    res["head_envelope"] = env
    log(f"phase 16 (a) SLS eval step at batch {batch}: {res['eval_utts_per_s']:.1f} utts/s "
        f"(flagship {flagship_eval_utts_per_s:.1f}); launches {launches}; bf16 head against "
        f"the fp32 head on the same hidden states (relative L2 of log-probs): {json.dumps(env)}")
    check(env["eval_step_vs_pieces_max_abs"] == 0.0, "the eval step is the head's pieces")
    check(env["port_vs_fp32"] <= ROUTE_ENVELOPE[0] * env["reference_bf16_vs_fp32"]
          and env["port_vs_reference_bf16"] <= ROUTE_ENVELOPE[1] * env["reference_bf16_vs_fp32"],
          "the bf16 head lies within ROUTE_ENVELOPE of the reference's bf16 rounding")
    del hiddens, x

    # (b) the train step at TrainConfig's batch and the serving batch
    train = {}
    bn = model.sls_head.first_bn
    for b_ in train_batches:
        restore()
        batch_ = train_batch(torch, wavs, b_, seed + 7, device)
        state = create_sls_train_state(model, exp)
        t_step = make_sls_train_step(model, exp, device=device)
        for _ in range(TRAIN_WARMUP):
            t_step(state, *batch_, seed)
        if on_card:
            resident = torch.cuda.memory_allocated()  # this and the flagship's weights, moments
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        r = time_train_steps(torch, t_step, state, batch_, seed, device,
                             TRAIN_TIMED if on_card else 1)
        n_steps = len(r["losses"]) + 1
        check(all(c == 0 for c in counts().values()), "the SLS train step launches no kernel")
        check(all(math.isfinite(v) for v in r["losses"]), "every SLS train loss is finite")
        check(int(state.step) == TRAIN_WARMUP + n_steps, "every SLS train step committed")
        if on_card:
            r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            r["resident_gib"] = resident / 2**30
        train[f"batch_{b_}"] = r
        log(f"phase 16 (b) SLS train step, batch {b_}: {json.dumps(r)}")
        if b_ == train_batches[0]:
            first = (batch_, state, t_step)
        else:
            del state, t_step
    batch_, state, t_step = first
    # the running statistics move once per committed step: 0.9 old + 0.1
    # the batch's (the same batch, at the weights the step starts from, by
    # a forward with autograd on as the step's: under no_grad some kernels
    # differ, and the statistics by ~2e-4; computed twice, for the
    # forward's own run-to-run difference)
    moves = []
    for _ in range(2):
        stats = []
        for _ in range(2):
            with torch.enable_grad():
                stats.append(model(dequantize_wire(batch_[0]), train=True, generator=(
                    dropout_generator(seed, state.calls, device)))["bn_stats"])
        old = (bn.running_mean.clone(), bn.running_var.clone())
        _, m_ = t_step(state, *batch_, seed)
        check(bool(m_["finite"]), "the step committed")
        for i, (name, new) in enumerate((("mean", bn.running_mean), ("var", bn.running_var))):
            once = 0.9 * old[i] + 0.1 * stats[0][i]
            moves.append({"stat": name, "old": float(old[i]), "new": float(new),
                          "once": float(once), "twice": float(0.9 * once + 0.1 * stats[0][i]),
                          "noise": float(0.1 * (stats[0][i] - stats[1][i]).abs())})
    train["running_stats"] = moves
    log(f"phase 16 (b) running statistics over two committed steps: {json.dumps(moves)}")
    check(all(abs(m["new"] - m["once"]) <= max(SLS_STATS_REL * abs(m["once"]), 4 * m["noise"])
              and abs(m["new"] - m["once"]) < abs(m["new"] - m["old"]) / 10
              and abs(m["new"] - m["once"]) < abs(m["new"] - m["twice"]) / 10 for m in moves),
          "the running statistics move once a committed step (0.9 old + 0.1 batch)")
    # a batch with a NaN sample leaves everything as it was
    wav_nan = dequantize_wire(batch_[0]).clone()
    wav_nan[1, 1000] = float("nan")
    before = ({k: v.detach().clone() for k, v in model.state_dict().items()},
              state.exp_avg.clone(), state.exp_avg_sq.clone(), state.step.clone())
    _, m_ = t_step(state, wav_nan, *batch_[1:], seed)
    same = (not bits_equal(torch, model.state_dict(), before[0])
            and torch.equal(state.exp_avg.view(torch.int32), before[1].view(torch.int32))
            and torch.equal(state.exp_avg_sq.view(torch.int32), before[2].view(torch.int32))
            and torch.equal(state.step, before[3]))
    train["nan_guard"] = {"finite": bool(m_["finite"]), "state_bit_equal": same}
    check(not bool(m_["finite"]) and same,
          "a NaN batch leaves parameters, moments, step and running statistics bit-equal")
    del before, wav_nan, state, t_step, first
    # one batch fitted at a larger learning rate: the loss falls
    restore()
    fit_exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, lr=SLS_FIT_LR))
    f_state = create_sls_train_state(model, fit_exp)
    f_step = make_sls_train_step(model, fit_exp, device=device)
    fit = [float(f_step(f_state, *batch_, seed)[1]["loss"]) for _ in range(FIT_STEPS)]
    train["fit"] = {"lr": SLS_FIT_LR, "losses": fit}
    log(f"phase 16 (b) NaN guard {json.dumps(train['nan_guard'])}; one batch fitted at lr "
        f"{SLS_FIT_LR}: {fit}")
    check(all(math.isfinite(v) for v in fit) and fit[-1] < fit[0], "the fitted SLS loss falls")
    del f_state, f_step
    res["train"] = train
    restore()

    # (c)-(f): SLSTrainer, an upstream .pth, serving, the gate profile
    t_batch, n_train, n_val = SLS_TRAINER_SIZES[device.type]
    t_exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, batch_size=t_batch))

    def utterances(n, s):
        labels = np.random.default_rng(s).permutation(np.arange(n) % 2)
        return to_wire(synthetic_wavs(n, cut, s), "int16"), labels

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_sls_"))
    try:
        ckpt_bytes = 4 * (sum(t.numel() for t in model.state_dict().values())
                          + 2 * sum(p.numel() for p in model.parameters()))
        free = shutil.disk_usage(work).free
        check(free >= CKPT_FILES_FREE * ckpt_bytes,
              f"{work} must hold {CKPT_FILES_FREE * ckpt_bytes / 1e9:.1f} GB and has "
              f"{free / 1e9:.1f} GB free: point TMPDIR at a larger disk")
        a = SLSTrainer(t_exp, work / "a", tensorboard=False, device=device)
        a.model.load_state_dict(model.state_dict(), strict=True)
        a.init_state()
        zero_counts()
        t0 = time.perf_counter()
        a.fit(ArrayLoader(*utterances(n_train, seed + 161), batch_size=t_batch, shuffle=True,
                          seed=seed),
              ArrayLoader(*utterances(n_val, seed + 162), batch_size=t_batch), num_epochs=1)
        fit_s = time.perf_counter() - t0
        check(all(c == 0 for c in counts().values()), "SLSTrainer.fit launches no kernel")
        rows = csv_rows(work / "a")
        check(len(rows) == 1 and rows[0]["epoch"] == "0", "one SLS CSV row for epoch 0")
        check(all(math.isfinite(float(rows[0][k])) for k in ("train_loss", "val_loss",
                                                            "train_eer", "val_eer")),
              "the SLS epoch's figures are finite")
        check(all(float(rows[0][k]) == 0.0 for k in SLS_ZERO_FIELDS),
              "the SLS row's cls / sae / cpc fields are 0, as the reference's trainer writes")
        check(a.ckpt.last_path.exists() and a.ckpt.best_path.exists(),
              "the SLS epoch wrote last.ckpt and best.ckpt")
        b = SLSTrainer(dataclasses.replace(t_exp, train=dataclasses.replace(
            t_exp.train, seed=seed + 163)), work / "b", tensorboard=False, device=device)
        b.init_state()
        check(bool(bits_equal(torch, b.model.state_dict(), a.model.state_dict())),
              "trainer B starts from other weights")
        t0 = time.perf_counter()
        check(b.resume(a.ckpt.last_path) and b.start_epoch == 1, "B resumes at epoch 1")
        resume_s = time.perf_counter() - t0
        bad = bits_equal(torch, b.model.state_dict(), a.model.state_dict())
        check(not bad and trainer_bits_equal(torch, a, b) and int(b.state.step) == int(
            a.state.step) and b.state.calls == a.state.calls,
              f"B has A's every tensor, running statistics included, bit for bit ({bad[:4]})")
        res["trainer"] = {"row": rows[0], "fit_s": fit_s, "save": dict(a.ckpt.last_save),
                          "resume_s": resume_s,
                          "running_var": float(a.model.sls_head.first_bn.running_var)}
        log(f"phase 16 (c) SLSTrainer, one epoch of {n_train} utterances ({n_val} to "
            f"validate), resumed bit for bit: {json.dumps(res['trainer'])}")

        # (d) an upstream-named .pth, written and read back, then resumed from
        src = {k: v.detach().to("cpu", copy=True) for k, v in a.model.state_dict().items()}
        ref = sls_detector_state_to_reference(src, cfg, num_batches_tracked=int(a.state.step))
        pth = work / f"sls_epoch_{SLS_PTH_STEP_EPOCH}.pth"
        t0 = time.perf_counter()
        torch.save({"module." + k: v for k, v in ref.items()}, pth)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = torch.load(pth, map_location="cpu", weights_only=True)
        W = sls_detector_state_from_reference(raw, cfg)
        load_s = time.perf_counter() - t0
        bad = bits_equal(torch, W, src, skip=(POS_CONV_KEY,))
        pos = rel_l2(W[POS_CONV_KEY], src[POS_CONV_KEY])
        check(int(raw["module.first_bn.num_batches_tracked"]) == int(a.state.step),
              "the .pth holds first_bn.num_batches_tracked")
        check(not bad and pos <= POS_CONV_REL_L2,
              f"the upstream .pth reads back bit for bit, the pos-conv within "
              f"{POS_CONV_REL_L2} ({bad[:4]}, {pos:.2e})")
        check(b.resume(str(pth)) and b.start_epoch == SLS_PTH_STEP_EPOCH + 1,
              "SLSTrainer.resume takes the upstream .pth")
        check(not bits_equal(torch, b.model.state_dict(), W),
              "the resumed trainer holds the .pth's weights")
        res["pth"] = {"gb": pth.stat().st_size / 1e9, "save_s": save_s, "load_s": load_s,
                      "pos_conv_rel_l2": pos}
        log(f"phase 16 (d) upstream .pth: {json.dumps(res['pth'])}")
        del raw, W, ref, src, b

        # (e) build_scorer over A's run directory, through the engine
        _, score_fn, _ = build_scorer(work / "a", wire_dtype="int16", batch_size=batch,
                                      device=device)
        clips = [wavs[i % len(wavs)] for i in range(batch)]
        rows_ = to_wire(np.stack([pad_or_tile(c, cut) for c in clips]), "int16")
        want = log_probs_to_scores(make_sls_eval_step(a.model, device=device)(rows_)["log_probs"])
        with BatchingEngine(score_fn, batch, cut=cut, wire_dtype="int16",
                            max_wait_ms=500) as engine:
            got = np.array([f.result(timeout=120) for f in [engine.submit(c) for c in clips]])
            stats = engine.stats().to_dict()
        check(stats["batches"] == 1 and np.array_equal(got, want),
              "build_scorer over the SLS run directory serves the eval step's scores bit for bit")
        res["served"] = {"requests": stats["requests"], "batches": stats["batches"],
                         "max_abs": float(np.abs(got - want).max())}

        # (f) the layer gates
        prof = layer_gate_profile(a.model, batch_wire, return_gates=True)
        gates = prof.pop("gates")
        check(gates.shape == (enc_cfg.encoder_layers, batch)
              and bool(np.all((gates > 0) & (gates < 1))),
              f"{enc_cfg.encoder_layers} gates a row, each in (0, 1)")
        res["gates"] = prof
        log(f"phase 16 (e) served {json.dumps(res['served'])}; (f) layer gates "
            f"{json.dumps(prof)}")
        del a, score_fn
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del model, init
    if on_card:
        torch.cuda.empty_cache()
    return res


def phase_cpc(torch, tk, device, flagship, sae_cfg, batch_, wire, batch: int, seed: int,
              counts, zero_counts, want_only, window_overlap_utts_per_s) -> dict:
    """Phase 17: the CPC variant at full width on the flagship's weights
    (module docstring).  Returns the ``cpc`` figures of the run line."""
    from sls_tpu_torch import config as C
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.train.steps import (
        create_train_state,
        dequantize_wire,
        dropout_generator,
        make_eval_step,
        make_train_step,
        train_loss,
    )

    on_card = device.type == "cuda"
    cfg = dataclasses.replace(
        flagship.config, use_cpc=True, cpc=C.CPCConfig(prediction_steps=CPC_STEPS),
        sae=dataclasses.replace(sae_cfg, variant="window_hard", window_size=WINDOW))
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(cut_length=batch_[0].shape[1],
                                                            cpc_weight=0.5))
    model = Detector(cfg, device=device,
                     generator=torch.Generator(device=device).manual_seed(seed + 17))
    missing, unexpected = model.load_state_dict(flagship.state_dict(), strict=False)
    check(not unexpected and missing and all(k.startswith("cpc.") for k in missing),
          "the CPC detector holds the flagship's weights and a seeded CPC head")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res = {}

    # (a), (b) the train step, its launches and throughput
    state = create_train_state(model, exp)
    step = make_train_step(model, exp, device=device)
    _, m_ = step(state, *batch_, seed)
    res["first_cpc_loss"] = float(m_["cpc_loss"])
    check(math.isfinite(res["first_cpc_loss"]) and res["first_cpc_loss"] > 0,
          "the CPC loss is live")
    zero_counts()
    r = time_train_steps(torch, step, state, batch_, seed, device, WINDOW_TRAIN_STEPS)
    launches = counts()
    n_steps = len(r["losses"]) + 1
    if on_card:
        want_only("CPC train step", launches,
                  {"sae_encode_fused": n_steps, "sae_decode_fused": n_steps})
    check(all(math.isfinite(v) for v in r["losses"]), "every CPC train loss is finite")
    r["launches_per_step"] = {n: c / n_steps for n, c in launches.items() if c}
    r["window_overlap_utts_per_s"] = window_overlap_utts_per_s
    res["train"], res["launches"] = r, launches
    log(f"phase 17 (a, b) CPC train step, batch {batch_[0].shape[0]}: {json.dumps(r)}")
    del state, step

    # (c) one step's loss, CPC loss and gradients: kernels, plain, SAE in fp64
    model.load_state_dict(init, strict=True)

    def grads():
        model.zero_grad(set_to_none=True)
        wav, labels, valid = batch_
        loss, _, out = train_loss(model, exp.train, dequantize_wire(wav), labels, valid,
                                  dropout_generator(seed, 0, device))
        loss.backward()
        g = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), float(out["cpc_loss"].detach()), out["codes"].detach(), g

    def encode_f64(x, w_enc, b_enc, b_dec):
        return torch.relu((x.double() - b_dec.double()) @ w_enc.double()
                          + b_enc.double()).float()

    def decode_f64(codes, w_dec, b_dec):
        return (codes.double() @ w_dec.double() + b_dec.double()).float()

    rows3_2 = ("sae_encode_fused", "sae_decode_fused")
    loss_k, cpc_k, codes_k, g_k = grads()
    with plain_sae_kernels(tk, rows3_2):
        zero_counts()
        loss_p, cpc_p, codes_p, g_p = grads()
        _, _, _, g_p2 = grads()
        check(all(c == 0 for c in counts().values()), "the plain CPC step launches no kernel")
    with plain_sae_kernels(tk, versions={"sae_encode_fused": encode_f64,
                                         "sae_decode_fused": decode_f64}):
        loss_t, cpc_t, _, g_t = grads()

    def over(err, envelope):
        return err / envelope if envelope else (0.0 if err == 0 else math.inf)

    # the envelope: the plain step's distance from the fp64-SAE step, or
    # the plain step's own run-to-run difference (cuDNN's backward sums in
    # no fixed order), whichever is larger, as phase 12 (g) allows
    errs = {}  # (rel L2 from the fp64-SAE step, from the plain step, the envelope)
    for n in g_p:
        e = max(rel_l2(g_p[n], g_t[n]), rel_l2(g_p2[n], g_p[n]))
        errs[n] = (rel_l2(g_k[n], g_t[n]), rel_l2(g_k[n], g_p[n]), e)
    within = {n: v[0] <= TRAIN_ENVELOPE[0] * v[2] and v[1] <= TRAIN_ENVELOPE[1] * v[2]
              for n, v in errs.items()}
    floored = [n for n, v in errs.items() if not within[n]
               and v[0] <= max(TRAIN_ENVELOPE[0] * v[2], CPC_GRAD_FLOOR)
               and v[1] <= max(TRAIN_ENVELOPE[1] * v[2], CPC_GRAD_FLOOR)]
    worst_t = max(errs, key=lambda n: over(errs[n][0], errs[n][2]))
    worst_p = max(errs, key=lambda n: errs[n][1])
    with torch.inference_mode():  # the pre-activations on either side of the ReLU
        feats = model.encoder(dequantize_wire(batch_[0])).float()
        feats = feats.reshape(-1, cfg.sae.activation_dim)
        sae = model.sae
        flips = int(((tk.sae_encode_fused(feats, sae.W_enc, sae.b_enc, sae.b_dec) > 0)
                     != (tk.sae_encode_fused_plain(feats, sae.W_enc, sae.b_enc, sae.b_dec) > 0)
                     ).sum())
    kp = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_sae_fp64": loss_t,
          "cpc_loss_kernels": cpc_k, "cpc_loss_plain": cpc_p, "cpc_loss_sae_fp64": cpc_t,
          "frames_support_differ": int(((codes_k > 0) != (codes_p > 0)).any(-1).sum()),
          "relu_mask_flips_eval_features": flips, "tensors": len(errs),
          "within_envelope": sum(within.values()), "held_by_floor": floored,
          "worst_vs_fp64_over_envelope": [worst_t, over(errs[worst_t][0], errs[worst_t][2]),
                                          *errs[worst_t]],
          "worst_vs_plain_rel_l2": [worst_p, *errs[worst_p]],
          "median_envelope_rel_l2": float(np.median([v[2] for v in errs.values()]))}
    res["kernels_vs_plain"] = kp
    log(f"phase 17 (c) CPC step, kernels against plain versions: {json.dumps(kp)}")
    del g_k, g_p, g_p2, g_t, feats
    check(abs(loss_k - loss_p) <= E2E_TOL and abs(cpc_k - cpc_p) <= E2E_TOL,
          "the CPC step's loss and CPC loss through the kernels agree with the plain versions'")
    check(all(within[n] or n in floored for n in errs),
          "every gradient of the CPC step through the kernels lies within the envelope "
          "(or CPC_GRAD_FLOOR of the plain step's)")

    # (d) the eval path: both kernels once a batch, no CPC
    calls = []
    hook = model.cpc.register_forward_hook(lambda *a: calls.append(1))
    try:
        ev = make_eval_step(model, device=device)
        ev(wire[:batch])
        zero_counts()
        n_eval = 2
        outs = [ev(wire[i * batch:(i + 1) * batch]) for i in range(n_eval)]
        ev_launches = counts()
    finally:
        hook.remove()
    if on_card:
        want_only("CPC eval step", ev_launches,
                  {"sae_encode_fused": n_eval, "sae_decode_fused": n_eval})
    check(not calls and all(bool(torch.isfinite(o["log_probs"]).all()) for o in outs),
          "the CPC eval step never runs the CPC head")
    res["eval"] = {"launches": ev_launches, "batches": n_eval}
    log(f"phase 17 (d) CPC eval path, {n_eval} batches of {batch}: launches {ev_launches}")
    del model, init
    if on_card:
        torch.cuda.empty_cache()
    return res


# Phase 18, the entry points at full width
CLI_SIZES = {"cuda": (216, 42, 14), "cpu": (12, 12, 4)}  # DF files, 2019 train, dev
CLI_LONG_SECONDS = (3, 12, 40)  # In-the-Wild clips: buckets T 256, 1280 and 2560
CLI_TRAIN_BATCH = {"cuda": 14, "cpu": 4}  # TrainConfig.batch_size; the rehearsal profiles 3 steps
CLI_PROFILE_STEPS = 2
CLI_FREE = 16                   # the disk must hold 16 times the weights' fp32 bytes
# each server's load at 1 and at 36 clients (5 s a load keeps the script,
# phase 19 included, under half its time limit)
LOAD_SECONDS = 5.0
LOAD_CLIENTS = (1, 36)
EXPORT_TOL = 1e-3               # cli/export.py --verify's limit: the exported program
SERVER_START_S = 600.0          # a server that prints no address within this fails


# (g) the analysis path: cli.report at its defaults (16 samples, batch 8),
# then cli.analyze attribution --ablation and gates at the CLI's
ANALYSIS_REPORT = (16, 8)       # --num_samples, --batch_size of cli.report
ANALYSIS_CLI = (100, 16)        # cli.analyze's defaults
ANALYSIS_GATES = (16, 8)        # gates: one encoder forward over these rows
ANALYSIS_UTTS = 4               # encode_sae against forward, and the attribution's envelope
ANALYSIS_FIGURES = {"temporal": ["temporal_stability.png"],
                    "attribution": ["decision_relevance.png"],
                    "importance": ["feature_statistics.png"], "probe": ["acoustic_probe.png"],
                    "failure": ["boundary_discontinuity_analysis.png",
                                "transient_vs_persistent.png"]}


# the CLI's progress lines: the run directory (after start-up), the
# resumed epoch (after the model's build and the weights' load), the
# score file (after scoring)
CLI_MARKS = (("run_dir", "run dir:"), ("resumed", "resumed at epoch"), ("wrote", "wrote "))


class StampedLines(io.TextIOBase):
    """stdout while it is entered, each line kept with the time it was
    written (and passed on to the real stdout)."""

    def __init__(self):
        self.lines, self._buf = [], ""

    def write(self, text):
        self._out.write(text)
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def flush(self):
        self._out.flush()

    def __enter__(self):
        self._out = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out

    def marks(self, t0: float) -> dict:
        """Seconds from ``t0`` to each of ``CLI_MARKS``' lines."""
        return {key: t - t0 for key, pattern in CLI_MARKS
                for t, line in self.lines if line.startswith(pattern)}


def cli_rank(argv):
    """One rank of the ``--seq_parallel`` job phase 18 starts with
    ``parallel/launch.py``: ``cli.main`` inside an N-rank job (it takes
    the job's ranks), with this rank's kernel launches."""
    from sls_tpu_torch.cli import main as cli_main
    from sls_tpu_torch.parallel import workers

    before = workers.launch_counts()
    rc = cli_main.main(argv)
    return {"rc": rc, "launches": {n: c - before[n] for n, c in workers.launch_counts().items()}}


def _http(url, data=None, headers=None, timeout=300):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class ServerProcess:
    """``python -m sls_tpu_torch.cli.serve ARGS --port 0`` as a child
    process; ``url`` once it prints its address.  ``stop`` ends it."""

    def __init__(self, args, root: Path):
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "sls_tpu_torch.cli.serve", *args, "--port", "0"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.url = None
        deadline = time.monotonic() + SERVER_START_S
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            m = re.search(r"on (http://127\.0\.0\.1:\d+)", line)
            if m:
                self.url = m.group(1)
                break
            if time.monotonic() > deadline:
                break
        self.start_s = time.perf_counter() - self.t0
        if self.url is None:
            self.stop()
            raise RuntimeError("check failed: the server came up: " + " | ".join(self.lines[-20:]))
        # keep reading its output, so that the pipe never fills
        self._reader = threading.Thread(target=lambda: [self.lines.append(x.rstrip())
                                                        for x in self.proc.stdout], daemon=True)
        self._reader.start()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)


def load_test(url: str, body: bytes, clients: int, seconds: float) -> dict:
    """``clients`` threads posting ``body`` to /score back to back for
    ``seconds``: requests/s and the client-side latency percentiles."""
    lat, errors = [], []
    lock = threading.Lock()
    stop_at = time.perf_counter() + seconds

    def client():
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            status, _ = _http(url + "/score", body, {"Content-Type": "application/octet-stream"})
            with lock:
                (lat if status == 200 else errors).append((time.perf_counter() - t0) * 1e3)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    ms = np.asarray(lat)
    return {"clients": clients, "seconds": wall, "requests": len(lat), "errors": len(errors),
            "requests_per_s": len(lat) / wall, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def phase_cli(torch, device, model, exp, batch: int, seed: int, counts, zero_counts,
              want_only, offline_utts_per_s, engine_utts_per_s) -> dict:
    """Phase 18: the port's entry points at the flagship's width on its
    weights (module docstring).  Returns the ``cli`` figures of the run
    line, with each sub-phase's launches under ``launches``."""
    import dataclasses as dc

    from sls_tpu_torch import config as C
    from sls_tpu_torch.ckpt.checkpoint import save_checkpoint, to_host
    from sls_tpu_torch.cli import export as cli_export
    from sls_tpu_torch.cli import main as cli_main
    from sls_tpu_torch.cli import monitor as cli_monitor
    from sls_tpu_torch.cli import profile_diff as cli_profile_diff
    from sls_tpu_torch.data.audio import load_audio
    from sls_tpu_torch.data.pipeline import BatchLoader, DatasetIndex, to_wire
    from sls_tpu_torch.data.protocols import parse_eval_list
    from sls_tpu_torch.evaluation import overlap as ev
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.parallel.launch import launch
    from sls_tpu_torch.scores.writer import read_score_file
    from sls_tpu_torch.serve.export import load_exported
    from sls_tpu_torch.serve.scorer import load_serving_model
    from sls_tpu_torch.train import profiling
    from sls_tpu_torch.train.loop import Trainer, produce_scores
    from sls_tpu_torch.train.steps import make_eval_step

    on_card = device.type == "cuda"
    root = Path(__file__).resolve().parent
    n_df, n_train, n_dev = CLI_SIZES[device.type]
    train_batch = CLI_TRAIN_BATCH[device.type]
    res, launches = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    env_before = os.environ.get("SLS_TPU_PLATFORM")
    if not on_card:
        os.environ["SLS_TPU_PLATFORM"] = "cpu"  # the CLIs' own switch, for them and their children
    servers = []
    try:
        db, proto, models = work / "db", work / "protocols", work / "models"
        proto.mkdir(parents=True)
        base = ["--database_path", str(db), "--protocols_path", str(proto),
                "--model_dir", str(models)] + ([] if on_card else [
                    "--tiny", "--sae_dict_size", str(exp.model.sae.dict_size),
                    "--sae_k", str(exp.model.sae.k)])
        eval_args = base + ["--is_eval", "--pallas_sae", "--wire_int16",
                            "--batch_size", str(batch)]
        cfg18 = cli_main.config_from_args(cli_main.build_parser().parse_args(eval_args))
        cut = cfg18.train.cut_length
        if on_card:
            check(cfg18.model == exp.model, "the CLI's flagship config is phase 3's")
            weights = {k: v.detach() for k, v in model.state_dict().items()}
        else:  # --tiny: the CLI's own tiny config, seeded weights
            weights = Detector(cfg18.model, device=device, generator=torch.Generator(
                device=device).manual_seed(seed + 18)).state_dict()
        weight_bytes = sum(v.numel() * 4 for v in weights.values())
        free = shutil.disk_usage(work).free
        res["disk"] = {"dir": str(work), "free_gb": free / 1e9, "weights_gb": weight_bytes / 1e9}
        check(free >= CLI_FREE * weight_bytes,
              f"{work} must hold {CLI_FREE * weight_bytes / 1e9:.1f} GB of checkpoints and "
              f"programs and has {free / 1e9:.1f} GB free: point TMPDIR at a larger disk")

        # the flagship as a port run directory: a Trainer's whole state
        t0 = time.perf_counter()
        trainer = Trainer(cfg18, work / "flagship_run", tensorboard=False, device=device)
        trainer.model.load_state_dict(weights, strict=True)
        trainer.init_state()
        ckpt = work / "flagship_run" / "last.ckpt"
        save_checkpoint(ckpt, to_host(trainer._state_tree()), epoch=0,
                        config_json=C.config_to_json(cfg18))
        del trainer
        # the fused-attention + fused-front-end and the window-overlap runs: weights only
        cut_routes = cut if on_card else 4005  # the tiny fused front-end's gate
        routes_exp = dc.replace(cfg18, model=dc.replace(cfg18.model, encoder=dc.replace(
            cfg18.model.encoder, fused_attention=True, fused_frontend=True)),
            train=dc.replace(cfg18.train, cut_length=cut_routes))
        window_exp = dc.replace(cfg18, model=dc.replace(cfg18.model, sae=dc.replace(
            cfg18.model.sae, variant="window_overlap", window_size=WINDOW)))
        host_weights = to_host(weights)
        for name, e in (("routes_run", routes_exp), ("window_run", window_exp)):
            save_checkpoint(work / name / "last.ckpt", {"model": host_weights}, epoch=0,
                            config_json=C.config_to_json(e))
        del host_weights
        res["run_dirs_s"] = time.perf_counter() - t0

        # the 2021 DF layout (FLAC, phase 15's writer), the 2019 LA train and
        # dev layouts, and In-the-Wild clips of 3, 12 and 40 s (WAV)
        rng = np.random.default_rng(seed + 18)

        def flac_set(split: str, ids, labels, lo: float, hi: float):
            d = db / split / "flac"
            d.mkdir(parents=True)
            for u, lab in zip(ids, labels):
                n = int(rng.uniform(lo, hi) * 16000)
                t = np.arange(n) / 16000
                x = 0.1 * rng.standard_normal(n) + lab * 0.3 * np.sin(
                    2 * np.pi * rng.uniform(100, 3000) * t)
                (d / f"{u}.flac").write_bytes(flac_bytes(
                    [np.round(np.clip(x, -1, 1) * 32767).astype(np.int16)], 16000))

        df_ids = [f"DF_E_{i:07d}" for i in range(n_df)]
        flac_set("ASVspoof2021_DF_eval", df_ids, rng.integers(0, 2, n_df), 0.5, 10.0)
        (proto / "ASVspoof2021.DF.cm.eval.trl.txt").write_text("".join(u + "\n" for u in df_ids))
        for split, n, prefix, protocol in (
                ("ASVspoof2019_LA_train", n_train, "T", "ASVspoof2019.LA.cm.train.trn.txt"),
                ("ASVspoof2019_LA_dev", n_dev, "D", "ASVspoof2019.LA.cm.dev.trl.txt")):
            ids = [f"LA_{prefix}_{i:07d}" for i in range(n)]
            labels = np.arange(n) % 2
            flac_set(split, ids, labels, 1.0, 4.0)
            (proto / protocol).write_text("".join(
                f"LA_{i % 20:04d} {u} - {'-' if lab else 'A01'} "
                f"{'bonafide' if lab else 'spoof'}\n" for i, (u, lab) in enumerate(zip(ids, labels))))
        buckets = ev.length_buckets(cfg18.model.encoder)
        if on_card:
            long_lengths = [16000 * s for s in CLI_LONG_SECONDS]
        else:  # the same bucket pattern at the tiny size
            long_lengths = [buckets[256] - 100, buckets[1280] - 100, buckets[2560] - 100]
        wild = db / "release_in_the_wild"
        wild.mkdir(parents=True)
        wild_ids = [f"{i}.wav" for i in range(len(long_lengths))]
        for w, n in zip(wild_ids, long_lengths):
            write_wav16(wild / w, np.round(np.clip(synthetic_wavs(1, n, seed + n)[0], -1, 1)
                                           * 32767).astype(np.int16))
        (proto / "in_the_wild.eval.txt").write_text("".join(w + "\n" for w in wild_ids))
        log(f"phase 18: {n_df} DF FLAC files, {n_train} + {n_dev} 2019 LA train / dev, "
            f"In-the-Wild clips of {[n / 16000 for n in long_lengths]} s, run directories "
            f"in {res['run_dirs_s']:.1f} s under {work}")

        # the reference: produce_scores over the same files, as phase 15 scores them
        index = DatasetIndex.for_eval(parse_eval_list(proto / "ASVspoof2021.DF.cm.eval.trl.txt"),
                                      db / "ASVspoof2021_DF_eval")
        ref_model = model if on_card else Detector(cfg18.model, device=device)
        if not on_card:
            ref_model.load_state_dict(weights, strict=True)
        ref_step = make_eval_step(ref_model, device=device)
        produce_scores(ref_step, BatchLoader(index, batch, cut=cut, wire_dtype="int16"),
                       work / "ref_DF.txt")
        ref_ids, ref_scores = read_score_file(work / "ref_DF.txt")
        n_batches = -(-n_df // batch)

        # (a) cli.main --is_eval in this process
        out_a = work / "scores_a.txt"
        argv_a = eval_args + ["--track", "DF", "--model_path", str(ckpt),
                              "--eval_output", str(out_a)]
        sync(torch, device)
        zero_counts()
        t0 = time.perf_counter()
        with StampedLines() as lines_a:
            check(cli_main.main(argv_a) == 0, "cli.main --is_eval exits 0")
        a_s = time.perf_counter() - t0
        marks_a = lines_a.marks(t0)
        launches["cli_eval"] = counts()
        if on_card:
            want_only("cli.main --is_eval", launches["cli_eval"],
                      {"sae_encode_topk_fused": n_batches, "sae_decode_fused": n_batches})
        ids_a, scores_a = read_score_file(out_a)
        check(ids_a == ref_ids == df_ids, "one score line a file, in list order")
        check(np.array_equal(scores_a, ref_scores),
              "cli.main's score file equals produce_scores over the same files, bit for bit")
        res["eval_in_process"] = {
            "seconds": a_s, "files": n_df, "batches": n_batches, "marks_s": marks_a,
            "scoring_utts_per_s": n_df / (marks_a["wrote"] - marks_a["resumed"]),
            "launches": launches["cli_eval"]}
        log(f"phase 18 (a) cli.main --is_eval --track DF: {n_df} files in {a_s:.2f} s "
            f"(its lines at {json.dumps(marks_a)} s), launches {launches['cli_eval']}; "
            f"bit-equal to produce_scores")

        # (b) python -m sls_tpu_torch.cli.main, as a user runs it
        out_b = work / "scores_b.txt"
        argv_b = eval_args + ["--track", "DF", "--model_path", str(ckpt),
                              "--eval_output", str(out_b)]
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "sls_tpu_torch.cli.main", *argv_b],
                                cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        marks, lines = {}, []
        for line in proc.stdout:
            lines.append(line.rstrip())
            for key, pattern in CLI_MARKS:
                if line.startswith(pattern):
                    marks[key] = time.perf_counter() - t0
        rc = proc.wait(timeout=600)
        b_s = time.perf_counter() - t0
        check(rc == 0, f"python -m sls_tpu_torch.cli.main exits 0: {lines[-10:]}")
        check(set(marks) == {"run_dir", "resumed", "wrote"}, f"the CLI's progress lines: {lines}")
        ids_b, scores_b = read_score_file(out_b)
        check(ids_b == ids_a and np.array_equal(scores_b, scores_a),
              "the subprocess's score file equals the in-process one")
        res["eval_subprocess"] = {
            "wall_s": b_s, "startup_s": marks["run_dir"],
            "model_and_weight_load_s": marks["resumed"] - marks["run_dir"],
            "build_s": "in scoring: phase 1 built the libraries in the checkout, and the "
                       "child loads them at its first launch",
            "scoring_s": marks["wrote"] - marks["resumed"],
            "scoring_note": "a fresh CUDA process: its first batch pays the process's "
                            "one-time costs (context, library handles, lazy kernel loads)",
            "exit_s": b_s - marks["wrote"],
            "scoring_utts_per_s": n_df / (marks["wrote"] - marks["resumed"]),
            "phase_15_produce_scores_utts_per_s": offline_utts_per_s}
        log(f"phase 18 (b) python -m sls_tpu_torch.cli.main: {json.dumps(res['eval_subprocess'])}")

        # (c) long clips: --full_utterance, --unwindowed, and --seq_parallel on ranks
        wild_args = eval_args + ["--track", "In-the-Wild", "--model_path", str(ckpt)]
        wavs_wild = [load_audio(wild / w) for w in wild_ids]
        long_res = {}
        for label, extra in (("full_utterance", ["--full_utterance"]),
                             ("unwindowed", ["--full_utterance", "--unwindowed"])):
            out = work / f"wild_{label}.txt"
            sync(torch, device)
            zero_counts()
            t0 = time.perf_counter()
            check(cli_main.main(wild_args + extra + ["--eval_output", str(out)]) == 0,
                  f"cli.main --{label} exits 0")
            got_ids, got = read_score_file(out)
            launches[f"cli_{label}"] = counts()
            long_res[label] = {"seconds": time.perf_counter() - t0,
                               "scores": dict(zip(got_ids, got.tolist())),
                               "launches": launches[f"cli_{label}"]}
            check(got_ids == wild_ids and bool(np.all(np.isfinite(got))),
                  f"--{label}: a finite score a clip, in list order")
        n_windows = sum(len(ev.extract_windows(w, cut)) for w in wavs_wild)
        t_buckets = [ev.unwindowed_batch(w, buckets)[1] for w in wavs_wild]
        flash = sum(cfg18.model.encoder.encoder_layers for t in t_buckets
                    if t >= cfg18.model.encoder.flash_long_t)
        if on_card:
            check(t_buckets == [256, 1280, 2560], f"the clips' buckets {t_buckets}")
            want_only("cli.main --full_utterance", launches["cli_full_utterance"],
                      {"sae_encode_topk_fused": -(-n_windows // batch)})
            want_only("cli.main --full_utterance --unwindowed", launches["cli_unwindowed"],
                      {"sae_encode_topk_fused": len(wild_ids), "flash_attention_long": flash})
        # the CLI's windowed scores against score_full_utterance, clip by clip
        full = [ev.score_full_utterance(ref_model, w, window=cut, batch_size=batch,
                                        device=device)["score"] for w in wavs_wild]
        d_full = max(abs(long_res["full_utterance"]["scores"][u] - s)
                     for u, s in zip(wild_ids, full))
        check(d_full <= SERVE_TOL, "--full_utterance equals score_full_utterance clip by clip")
        long_res["full_utterance"]["vs_score_full_utterance_max_abs"] = d_full
        if on_card:
            torch.cuda.empty_cache()
        sp_argv = wild_args + ["--full_utterance", "--unwindowed", "--seq_parallel",
                               str(SP_RANKS), "--eval_output", str(work / "wild_sp.txt")]
        t0 = time.perf_counter()
        ranks = launch(cli_rank, SP_RANKS, (sp_argv,), device_type=device.type,
                       timeout_s=RANKS_TIMEOUT_S)
        sp_s = time.perf_counter() - t0
        sp_ids, sp_scores = read_score_file(work / "wild_sp.txt")
        unw = long_res["unwindowed"]["scores"]
        d_sp = max(abs(s - unw[u]) for u, s in zip(sp_ids, sp_scores))
        check(all(r["rc"] == 0 for r in ranks), "every rank's cli.main exits 0")
        check(sp_ids == wild_ids, "the primary wrote a score a clip")
        check(d_sp <= ROUTE_TOL, "--seq_parallel scores agree with --unwindowed's")
        if on_card:
            for r, rank in enumerate(ranks):
                want_only(f"--seq_parallel rank {r}", rank["launches"],
                          {"sp_flash_attention_long": flash})
        launches["cli_seq_parallel"] = ranks[0]["launches"]
        long_res["seq_parallel"] = {"ranks": SP_RANKS, "seconds": sp_s,
                                    "vs_unwindowed_max_abs": d_sp,
                                    "launches_by_rank": [r["launches"] for r in ranks]}
        long_res["buckets"] = t_buckets
        res["long_clips"] = long_res
        log(f"phase 18 (c) long clips: {json.dumps(long_res)}")

        # (d) training through the CLI, with a profile
        train_models = work / "train_models"
        train_argv = base + ["--model_dir", str(train_models), "--quick_test",
                             "--batch_size", str(train_batch),
                             "--pallas_sae", "--profile_steps", str(CLI_PROFILE_STEPS),
                             "--num_epochs", "1"]
        if on_card:
            torch.cuda.empty_cache()
        zero_counts()
        t0 = time.perf_counter()
        check(cli_main.main(train_argv) == 0, "cli.main trains and exits 0")
        train_s = time.perf_counter() - t0
        launches["cli_train"] = counts()
        tag = cli_main.config_from_args(cli_main.build_parser().parse_args(train_argv)).model_tag()
        run_dir = train_models / tag
        steps = min(5, -(-n_train // train_batch))
        vals = min(5, -(-n_dev // train_batch))
        if on_card:
            want_only("cli.main training", launches["cli_train"],
                      {"sae_encode_topk_fused": steps + vals, "sae_decode_fused": steps + vals})
        check(run_dir.is_dir() and sorted(p.name for p in train_models.iterdir()) == [tag],
              f"the run directory is <model_dir>/{tag}")
        rows = cli_monitor.read_log(run_dir)
        check(len(rows) == 1 and (run_dir / "last.ckpt").exists(),
              "one CSV row and last.ckpt")
        trace_dir = run_dir / "profile"
        hist = profiling.op_histogram(trace_dir, lane_filter="kernel" if on_card else "cpu_op",
                                      group=False)
        sae_names = ({"row 1": "encode_bf16_wgmma_kernel", "row 2": "decode_stream_kernel"}
                     if on_card else {"row 1": "sls_tpu_torch::sae_encode_topk",
                                      "row 2": "sls_tpu_torch::sae_decode"})
        found = {row: sorted(n for n in hist if name in n) for row, name in sae_names.items()}
        check(all(found.values()), f"the profile names both SAE kernels: {found}")
        with contextlib.redirect_stdout(io.StringIO()) as diff_out:
            rc_diff = cli_profile_diff.main([str(trace_dir), str(trace_dir), "--json"]
                                            + ([] if on_card else ["--lane", "cpu_op"]))
            rc_top = cli_profile_diff.main([str(trace_dir), "--top", "8"]
                                           + ([] if on_card else ["--lane", "cpu_op"]))
            rc_mon = cli_monitor.main(["--run_dir", str(run_dir)])
        check(rc_diff == rc_top == rc_mon == 0, "profile_diff and monitor exit 0")
        top = sorted(hist.items(), key=lambda kv: -kv[1]["ms"])[:8]
        res["train"] = {"seconds": train_s, "run_dir": tag, "csv_row": rows[0],
                        "steps": steps, "validation_batches": vals,
                        "launches": launches["cli_train"],
                        "profile_sae_kernels": {row: {n: hist[n] for n in names}
                                                for row, names in found.items()},
                        "profile_top_ms": {n[:80]: v["ms"] for n, v in top},
                        "monitor_and_profile_diff_output_lines": len(
                            diff_out.getvalue().splitlines())}
        log(f"phase 18 (d) cli.main training: {json.dumps(res['train'])}")
        shutil.rmtree(run_dir, ignore_errors=True)

        # (e) export: cli.export --verify, then the graphs and the reloaded programs
        if on_card:
            torch.cuda.empty_cache()
        export_res = {}
        wire_batch = to_wire(synthetic_wavs(batch, cut, seed + 19), "int16")
        for name, run, extra, want_ops, per_call in (
                ("flagship", work / "flagship_run", [], ["sae_decode", "sae_encode_topk"],
                 {"sae_encode_topk_fused": 1, "sae_decode_fused": 1}),
                ("routes", work / "routes_run", [], ["frontend_tail", "fused_attention",
                                                     "sae_decode", "sae_encode_topk"],
                 {"sae_encode_topk_fused": 1, "sae_decode_fused": 1, "frontend_tail_fused": 1,
                  "fused_attention": cfg18.model.encoder.encoder_layers}),
                ("window_overlap", work / "window_run", [],
                 ["sae_decode", "sae_encode", "window_vote"],
                 {"sae_encode_fused": 1, "window_vote_fused": 1, "sae_decode_fused": 1})):
            art = work / f"art_{name}"
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = cli_export.main([str(run), "--out", str(art), "--batch", str(batch),
                                      "--wire", "int16", "--verify", *extra])
            export_s = time.perf_counter() - t0
            verify = json.loads(out.getvalue().strip().splitlines()[-1])
            check(rc == 0, f"cli.export --verify exits 0 for {name}: {out.getvalue()[-500:]}")
            manifest, fwd = load_exported(art)
            check(manifest["ops"] == [f"sls_tpu_torch::{o}" for o in want_ops],
                  f"{name}: the exported graph holds {want_ops}, has {manifest['ops']}")
            _, live = load_serving_model(run, device=device)
            w_cut = wire_batch if manifest["cut"] == cut else to_wire(
                synthetic_wavs(batch, manifest["cut"], seed + 19), "int16")
            fwd(w_cut)  # one-time setup outside the counted call
            sync(torch, device)
            zero_counts()
            got = fwd(w_cut)
            sync(torch, device)
            call_launches = counts()
            want = live(w_cut)
            diff = float((got.double() - want.double()).abs().max())
            check(diff <= EXPORT_TOL, f"{name}: the reloaded program within {EXPORT_TOL} of "
                                      f"the live scorer ({diff:.3e})")
            if on_card:
                want_only(f"{name}: one call of the exported program", call_launches, per_call)
            launches[f"cli_export_{name}"] = call_launches
            reps = 10 if on_card else 1
            ms_exported = timed(torch, lambda: fwd(w_cut), device, reps)
            ms_live = timed(torch, lambda: live(w_cut), device, reps)
            enqueue = {}
            for key, fn in (("exported_enqueue_ms", fwd), ("live_enqueue_ms", live)):
                sync(torch, device)  # the host's time to queue one call, the device idle
                t_q = time.perf_counter()
                fn(w_cut)
                enqueue[key] = (time.perf_counter() - t_q) * 1e3
                sync(torch, device)
            export_res[name] = {
                "export_and_verify_s": export_s, "verify_max_abs_diff": verify[
                    "verify_max_abs_diff"], "program_gb": (art / "forward.pt2").stat().st_size / 1e9,
                "ops": manifest["ops"], "bit_equal_to_live": diff == 0.0, "max_abs_diff": diff,
                "launches_per_call": call_launches, "exported_ms": ms_exported,
                "live_ms": ms_live, "exported_over_live": ms_exported / ms_live, **enqueue}
            log(f"phase 18 (e) export {name}: {json.dumps(export_res[name])}")
            del fwd, live
            if on_card:
                torch.cuda.empty_cache()
        res["export"] = export_res

        # (f) HTTP: cli.serve over the run directory and over the flagship's artifact
        http_res = {}
        sample = [i for i in range(n_df)][:6]
        decoded = {i: load_audio(index.paths[i]) for i in sample}
        for label, serve_args in (
                ("run_dir", ["--run_dir", str(work / "flagship_run"), "--batch", str(batch),
                             "--wire", "int16"]),
                ("from_export", ["--from_export", str(work / "art_flagship")])):
            srv = ServerProcess(serve_args, root)
            servers.append(srv)
            url = srv.url
            h = {"startup_s": srv.start_s}
            check(_http(url + "/healthz") == (200, {"ok": True}), f"{label}: /healthz")
            got = []
            for i in sample:
                status, out = _http(url + "/score", to_wire(decoded[i], "int16").astype(
                    "<i2").tobytes(), {"Content-Type": "application/octet-stream",
                                       "X-Sample-Rate": "16000"})
                check(status == 200, f"{label}: /score answers")
                got.append(out["score"])
            d_score = float(np.abs(np.asarray(got) - ref_scores[sample]).max())
            status, out = _http(url + "/score_batch", json.dumps(
                {"wavs": [decoded[i].tolist() for i in sample[:3]],
                 "sample_rate": 16000}).encode(), {"Content-Type": "application/json"})
            check(status == 200, f"{label}: /score_batch answers")
            d_batch = float(np.abs(np.asarray(out["scores"]) - ref_scores[sample[:3]]).max())
            long_wav = wavs_wild[-1]
            status, out = _http(url + "/score_long", to_wire(long_wav, "int16").astype(
                "<i2").tobytes(), {"Content-Type": "application/octet-stream",
                                   "X-Aggregate": "mean"})
            check(status == 200 and out["n_windows"] == len(ev.extract_windows(long_wav, cut)),
                  f"{label}: /score_long answers with every window")
            d_long = abs(out["score"] - full[-1])
            status, stats = _http(url + "/stats")
            check(status == 200 and stats["requests"] >= len(sample) + 3, f"{label}: /stats")
            h.update(score_vs_file_max_abs=d_score, score_batch_vs_file_max_abs=d_batch,
                     score_long_vs_score_full_utterance_abs=d_long)
            check(max(d_score, d_batch, d_long) <= SERVE_TOL,
                  f"{label}: every endpoint's score equals the offline one")
            body = to_wire(synthetic_wavs(1, cut, seed + 20)[0], "int16").astype("<i2").tobytes()
            for clients in LOAD_CLIENTS:
                h[f"load_{clients}"] = load_test(url, body, clients,
                                                 LOAD_SECONDS if on_card else 1.0)
            status, h["stats_after"] = _http(url + "/stats")
            srv.stop()
            h["engine_utts_per_s_phase_3"] = engine_utts_per_s
            http_res[label] = h
            log(f"phase 18 (f) cli.serve {label}: {json.dumps(h)}")
        res["http"] = http_res

        # (g) the analysis path: cli.report, cli.analyze attribution and gates
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["analysis"] = phase_analysis(torch, device, ref_model, cfg18, work, seed, counts,
                                         zero_counts, want_only, launches)
        res["analysis"]["seconds"] = time.perf_counter() - t0
        log(f"phase 18 (g) in {res['analysis']['seconds']:.1f} s")

        # (h) the training runners and the parity tools
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res["run_tools"] = phase_run_tools(
            torch, device, weights, cfg18, work, base, batch, out_a, n_batches, seed, counts,
            zero_counts, want_only, launches)
        res["run_tools"]["seconds"] = time.perf_counter() - t0
        log(f"phase 18 (h) in {res['run_tools']['seconds']:.1f} s")
    finally:
        for srv in servers:
            srv.stop()
        if env_before is None:
            os.environ.pop("SLS_TPU_PLATFORM", None)
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = launches
    return res


PARITY_TOL = 1e-3  # encoder.parity's default: max|Δ| < 1e-3 * max(mean|ref|, 1)
SWEEP_POINTS = 7  # cli.sweep's reference preset


def phase_run_tools(torch, device, weights, cfg18, work: Path, base, batch: int, scores_a: Path,
                    n_batches: int, seed: int, counts, zero_counts, want_only, launches) -> dict:
    """Phase 18 (h): ``cli.parity_kit`` on the flagship's weights as a
    reference-named ``.pth`` over (a)'s DF files, held to (a)'s score
    file and failing against a shifted one; ``encoder.parity`` on its
    encoder as a fairseq file; ``cli.autotrain`` driving one ``cli.main``
    training subprocess at the tiny width to its target epoch; and
    ``cli.sweep --dry_run`` over the reference preset."""
    from sls_tpu_torch import config as C
    from sls_tpu_torch.cli import autotrain, parity_kit, sweep
    from sls_tpu_torch.cli import main as cli_main
    from sls_tpu_torch.convert import detector_state_to_reference
    from sls_tpu_torch.encoder import parity
    from sls_tpu_torch.scores.writer import read_score_file

    on_card = device.type == "cuda"
    root = Path(__file__).resolve().parent
    res = {}
    db, proto = work / "db", work / "protocols"

    # the flagship as the reference's training run saves it
    t0 = time.perf_counter()
    ref_state = detector_state_to_reference({k: v.detach().cpu() for k, v in weights.items()},
                                            cfg18.model)
    # the pos-conv as its plain weight, which the converters take beside
    # weight norm's pair (whose fold rounds it): (a)'s weights bit for bit
    pos = "ssl_model.model.encoder.pos_conv.0."
    del ref_state[pos + "weight_g"], ref_state[pos + "weight_v"]
    ref_state[pos + "weight"] = weights["encoder.pos_conv.conv.weight"].detach().cpu()
    pth = work / "best_checkpoint_eer.pth"
    torch.save({"model": {f"module.{k}": v for k, v in ref_state.items()}, "epoch": 0,
                "args": {"use_window_topk": False, "sae_window_size": WINDOW}}, pth)
    res["pth_gb"] = pth.stat().st_size / 1e9
    res["pth_write_s"] = time.perf_counter() - t0
    enc_pt = work / "xlsr_fairseq.pt"
    torch.save({"model": {k[len("ssl_model.model."):]: v for k, v in ref_state.items()
                          if k.startswith("ssl_model.model.")}}, enc_pt)
    del ref_state

    # cli.parity_kit over the DF eval list, then against (a)'s file and a shifted one
    kit = ["--cp_path", str(pth), "--eval_list", str(proto / "ASVspoof2021.DF.cm.eval.trl.txt"),
           "--database_path", str(db / "ASVspoof2021_DF_eval"), "--batch_size", str(batch),
           "--cut_length", str(cfg18.train.cut_length)]
    if not on_card:  # the tiny weights do not fit the XLS-R topology inference reads
        cfg_json = work / "cfg18.json"
        cfg_json.write_text(C.config_to_json(cfg18))
        kit += ["--config_json", str(cfg_json)]
    out_h = work / "scores_kit.txt"
    sync(torch, device)
    zero_counts()
    t0 = time.perf_counter()
    with StampedLines() as lines:
        rc = parity_kit.main(kit + ["--out", str(out_h), "--ref_scores", str(scores_a)])
    kit_s = time.perf_counter() - t0
    launches["cli_parity_kit"] = counts()
    text = "\n".join(line for _, line in lines.lines)
    report = json.loads(text[text.index("{"):])
    ids_h, got = read_score_file(out_h)
    ids_a, want = read_score_file(scores_a)
    res["parity_kit"] = {"seconds": kit_s, "rc": rc, "report": report,
                         "bit_equal_to_cli_main": bool(ids_h == ids_a
                                                       and np.array_equal(got, want)),
                         "inferred": next((line for _, line in lines.lines
                                           if line.startswith("inferred:")), None),
                         "launches": launches["cli_parity_kit"]}
    check(rc == 0 and report["n_compared"] == len(ids_a) and report["max_abs_diff"] <= SERVE_TOL,
          f"cli.parity_kit scores every file as cli.main does on the same weights: {report}")
    if on_card:
        want_only("cli.parity_kit", launches["cli_parity_kit"],
                  {"sae_encode_topk_fused": n_batches, "sae_decode_fused": n_batches})
    shifted = work / "scores_shifted.txt"
    shifted.write_text("".join(f"{u} {s_ + 1e-2}\n" for u, s_ in zip(ids_a, want)))
    with contextlib.redirect_stdout(io.StringIO()):
        rc_bad = parity_kit.main(kit + ["--out", str(work / "scores_kit2.txt"),
                                        "--ref_scores", str(shifted)])
    res["parity_kit"]["rc_against_shifted"] = rc_bad
    check(rc_bad == 1, "cli.parity_kit exits 1 against a file shifted by 1e-2")
    log(f"phase 18 (h) cli.parity_kit: {json.dumps(res['parity_kit'])}")

    # encoder.parity on the same encoder, in fp32
    t0 = time.perf_counter()
    with StampedLines() as lines:
        ok = parity.run_parity(str(enc_pt), "fairseq", None, PARITY_TOL,
                               cfg=None if on_card else cfg18.model.encoder, device=device)
    said = [line for _, line in lines.lines]
    res["encoder_parity"] = {"seconds": time.perf_counter() - t0, "lines": said[:3] + said[-1:]}
    log(f"phase 18 (h) encoder.parity: {json.dumps(res['encoder_parity'])}")
    check(ok and said[-1] == "PARITY OK", f"encoder.parity says PARITY OK: {said}")

    # cli.autotrain: one real cli.main training subprocess at the tiny width
    train_models = work / "autotrain_models"
    tiny = ["--database_path", str(db), "--protocols_path", str(proto), "--model_dir",
            str(train_models), "--tiny", "--quick_test", "--num_epochs", "1", "--batch_size",
            "4", "--sae_dict_size", "256", "--sae_k", "32", "--algo", "0"]
    run_dir = train_models / cli_main.config_from_args(
        cli_main.build_parser().parse_args(tiny)).model_tag()
    env_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join([str(root), *filter(None, [env_path])])
    try:
        t0 = time.perf_counter()
        with StampedLines() as lines:
            rc = autotrain.main(["--target_epoch", "0", "--run_dir", str(run_dir),
                                 "--restart_delay", "0", "--", *tiny])
        auto_s = time.perf_counter() - t0
    finally:
        if env_path is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = env_path
    attempts = [line for _, line in lines.lines if line.startswith("[autotrain] attempt")]
    res["autotrain"] = {"seconds": auto_s, "rc": rc, "attempts": len(attempts),
                        "last_epoch": autotrain.last_epoch(str(run_dir)),
                        "run_dir": run_dir.name}
    log(f"phase 18 (h) cli.autotrain: {json.dumps(res['autotrain'])}")
    check(rc == 0 and len(attempts) == 1 and res["autotrain"]["last_epoch"] == 0
          and (run_dir / "last.ckpt").exists(),
          "cli.autotrain trains to its target epoch in one cli.main subprocess")

    # cli.sweep --dry_run over the reference preset
    sweep_dir = work / "sweep"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = sweep.main(["--preset", "reference", "--dry_run", "--model_dir", str(sweep_dir),
                         "--", *base[:4], "--num_epochs", "40"])
    summary = json.loads((sweep_dir / "sweep_summary.json").read_text())
    cmds = [p_["cmd"] for p_ in summary["points"].values()]
    res["sweep_dry_run"] = {"rc": rc, "n_points": summary["n_points"],
                            "lines": len(out.getvalue().splitlines()),
                            "run_dirs": sorted(Path(p_["run_dir"]).name
                                               for p_ in summary["points"].values())}
    log(f"phase 18 (h) cli.sweep --dry_run: {json.dumps(res['sweep_dry_run'])}")
    check(rc == 1 and summary["n_points"] == SWEEP_POINTS == len(cmds) and summary["n_done"] == 0
          and all(c[1:3] == ["-m", "sls_tpu_torch.cli.autotrain"] for c in cmds),
          "cli.sweep --dry_run lists the preset's seven autotrain commands")
    return res


def collect_batches(num_samples: int, batch: int) -> int:
    """Batches ``cli.analyze``'s ``_collect_codes`` runs on its synthetic
    loader (max(num_samples, 2 * batch) rows) before it has num_samples."""
    return -(-min(num_samples, max(num_samples, 2 * batch)) // batch)


def phase_analysis(torch, device, model, cfg18, work: Path, seed: int, counts, zero_counts,
                   want_only, launches: dict) -> dict:
    """Phase 18 (g): the analysis path on the run directories phase 18
    wrote (module docstring).  Adds its launches to ``launches``."""
    import importlib.util

    from sls_tpu_torch import config as C
    from sls_tpu_torch.analysis.attribution import gradient_attribution
    from sls_tpu_torch.ckpt.checkpoint import save_checkpoint, to_host
    from sls_tpu_torch.cli import analyze as cli_analyze
    from sls_tpu_torch.cli import report as cli_report
    from sls_tpu_torch.kernels import sae_kernels as tk
    from sls_tpu_torch.models.sls import SLSDetector
    from sls_tpu_torch.sae.sparsify import topk_per_row

    on_card = device.type == "cuda"
    figures = importlib.util.find_spec("matplotlib") is not None
    log("phase 18 (g): matplotlib " + ("imports: --figures runs and every figure is checked"
                                       if figures else "is not installed: no --figures"))
    res = {"matplotlib": figures}

    # the report over the flagship's run, with the window-overlap run to
    # compare; each section's launches counted around its command
    n_report, b_report = ANALYSIS_REPORT
    per_section, loads = {}, []
    commands, load = dict(cli_analyze.COMMANDS), cli_analyze.load_experiment

    def counted(name, fn):
        def run(*args, **kwargs):
            sync(torch, device)
            before = counts()
            try:
                return fn(*args, **kwargs)
            finally:
                sync(torch, device)
                per_section[name] = {k: v - before[k] for k, v in counts().items()}
        return run

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        sync(torch, device)
        loads.append(time.perf_counter() - t0)
        return out

    out_root = work / "deliverables"
    argv = ["--run_dir", str(work / "flagship_run"), "--compare_run_dir",
            str(work / "window_run"), "--synthetic", "--out", str(out_root),
            "--num_samples", str(n_report), "--batch_size", str(b_report)]
    cli_analyze.COMMANDS.update({n: counted(n, f) for n, f in commands.items()})
    cli_analyze.load_experiment = timed_load
    try:
        sync(torch, device)
        zero_counts()
        t0 = time.perf_counter()
        rc = cli_report.main(argv)
        report_s = time.perf_counter() - t0
        launches["cli_report"] = counts()
    finally:
        cli_analyze.COMMANDS.update(commands)
        cli_analyze.load_experiment = load
    analysis = work / "flagship_run" / "analysis"
    sections = [s for s, _ in cli_report.SECTIONS] + ["compare"]
    check(rc == 0, "cli.report exits 0: every section succeeded")
    check(all((analysis / f"{s.replace('-', '_')}.json").exists() for s in sections),
          "cli.report wrote every section's JSON")
    (dest,) = out_root.glob("results_*")
    check((dest / "RESEARCH_SUMMARY.md").exists() and (dest / "EXECUTIVE_SUMMARY.txt").exists(),
          "the deliverable holds its summaries")
    pngs = sorted(p.name for p in (analysis / "figures").glob("*.png"))
    want_pngs = sorted(f for names in ANALYSIS_FIGURES.values() for f in names) if figures else []
    check(pngs == want_pngs, f"the report's figures {pngs}, want {want_pngs}")
    n = collect_batches(n_report, b_report)
    encode_only = {"sae_encode_topk_fused": n}
    want = {s: encode_only for s in sections}
    want["inspect"] = {"sae_encode_topk_fused": 1, "sae_decode_fused": 1}
    want["overlap"] = {"sae_encode_topk_fused": n, "sae_decode_fused": n}
    want["compare"] = {"sae_encode_topk_fused": n, "sae_encode_fused": n, "window_vote_fused": n}
    if on_card:
        for s in sections:
            want_only(f"cli.report section {s}", per_section[s], want[s])
        total = {k: sum(w.get(k, 0) for w in want.values()) for k in counts()}
        want_only("cli.report", launches["cli_report"], total)
    timings = json.loads((analysis / "timings.json").read_text())
    res["report"] = {"seconds": report_s, "model_load_s": loads, "section_s": timings,
                     "samples": n_report, "batch": b_report, "figures": pngs,
                     "launches_by_section": per_section, "launches": launches["cli_report"]}
    log(f"phase 18 (g) cli.report: {json.dumps(res['report'])}")

    # cli.analyze attribution --ablation at the CLI's defaults, through main
    n_cli, b_cli = ANALYSIS_CLI
    out = work / "attribution.json"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_analyze.main(["attribution", "--run_dir", str(work / "flagship_run"),
                               "--synthetic", "--ablation", "--output", str(out)])
    sync(torch, device)
    attr_s = time.perf_counter() - t0
    launches["cli_analyze_attribution"] = counts()
    attr = json.loads(out.read_text())
    check(rc == 0 and attr["num_samples"] == n_cli and len(attr["ablation"]["features"]) == 20,
          "cli.analyze attribution --ablation exits 0 with 20 ablated features")
    check(all(np.isfinite(attr["ablation"]["mean_prob_drop"])), "finite ablation drops")
    if on_card:
        want_only("cli.analyze attribution", launches["cli_analyze_attribution"],
                  {"sae_encode_topk_fused": collect_batches(n_cli, b_cli)})
    res["attribution_cli"] = {
        "seconds": attr_s, "samples": n_cli, "batch": b_cli,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "ablation_chunk_gb": 20 * n_cli * cfg18.model.encoder.num_frames(cfg18.train.cut_length)
        * cfg18.model.sae.dict_size * 4 / 1e9,
        "launches": launches["cli_analyze_attribution"]}
    log(f"phase 18 (g) cli.analyze attribution --ablation: {json.dumps(res['attribution_cli'])}")

    # gates over a full-width SLS run directory: its weights alone
    sls_exp = C.ExperimentConfig(model=C.ModelConfig(encoder=cfg18.model.encoder, use_sae=False),
                                 train=cfg18.train)
    sls = SLSDetector(sls_exp.model, device=device, cut_length=cfg18.train.cut_length,
                      generator=torch.Generator(device=device).manual_seed(seed + 181))
    save_checkpoint(work / "sls_run" / "last.ckpt", {"model": to_host(sls.state_dict())},
                    epoch=0, config_json=C.config_to_json(sls_exp))
    n_layers = sls_exp.model.encoder.encoder_layers
    del sls
    n_gates, b_gates = ANALYSIS_GATES
    out = work / "gates.json"
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_analyze.main(["gates", "--run_dir", str(work / "sls_run"), "--synthetic",
                               "--num_samples", str(n_gates), "--batch_size", str(b_gates),
                               "--output", str(out)]
                              + (["--figures", str(work / "gates_figures")] if figures else []))
    sync(torch, device)
    gates_s = time.perf_counter() - t0
    launches["cli_analyze_gates"] = counts()
    gates = json.loads(out.read_text())
    mean = np.asarray(gates["mean_gate_per_layer"])
    check(rc == 0 and mean.shape == (n_layers,) and bool(np.all((mean > 0) & (mean < 1))),
          f"cli.analyze gates exits 0 with {n_layers} gates in (0, 1)")
    check((work / "gates_figures" / "layer_gates.png").exists() == figures,
          "gates draws layer_gates.png where matplotlib is installed")
    if on_card:
        want_only("cli.analyze gates", launches["cli_analyze_gates"], {})
    res["gates_cli"] = {"seconds": gates_s, "samples": n_gates,
                        "most_sensitive_layers": gates["most_sensitive_layers"],
                        "launches": launches["cli_analyze_gates"]}
    log(f"phase 18 (g) cli.analyze gates: {json.dumps(res['gates_cli'])}")

    # encode_sae's codes are the forward's, bit for bit; the gradient
    # attribution on the kernel's codes within ROUTE_ENVELOPE's form of
    # the plain version's (the envelope: the plain route against the SAE
    # encode in fp32, on the same encoder features)
    wav = torch.from_numpy(synthetic_wavs(ANALYSIS_UTTS, cfg18.train.cut_length,
                                          seed + 182)).to(device)
    with torch.inference_mode():
        enc = model.encode_sae(wav)
        full = model(wav)
        with plain_sae_kernels(tk):
            codes_plain = model.encode_sae(wav)["codes"]
        sae = model.sae
        acts32 = torch.relu((enc["features"] - sae.b_dec) @ sae.W_enc + sae.b_enc)
        codes32 = topk_per_row(acts32, cfg18.model.sae.k)
    check(torch.equal(enc["codes"], full["codes"]) and torch.equal(enc["features"],
                                                                     full["features"]),
          "encode_sae's codes and features equal the forward's, bit for bit")
    g_kernel, g_plain, g32 = (torch.from_numpy(gradient_attribution(model, c)).double()
                              for c in (enc["codes"], codes_plain, codes32))
    env = {"kernel_vs_fp32": rel_l2(g_kernel, g32), "plain_vs_fp32": rel_l2(g_plain, g32),
           "kernel_vs_plain": rel_l2(g_kernel, g_plain),
           "rows_support_differs": int(((enc["codes"] > 0) != (codes_plain > 0)).any(-1).sum())}
    check(env["kernel_vs_fp32"] <= ROUTE_ENVELOPE[0] * env["plain_vs_fp32"]
          and env["kernel_vs_plain"] <= ROUTE_ENVELOPE[1] * env["plain_vs_fp32"],
          f"the attribution on the kernel's codes lies within ROUTE_ENVELOPE: {env}")
    res["encode_sae_bit_equal_forward"] = True
    res["attribution_envelope"] = env
    log(f"phase 18 (g) encode_sae against forward: bit-equal; attribution {json.dumps(env)}")
    return res


# Phase 19: training across ranks and serving over several devices.  Two
# ranks share the one card over gloo (choose_backend's rule for ranks that
# share a card; NCCL, a card a rank, cannot run on a one-card machine).
# The ranks step their halves of a global batch; the one-process step on
# the whole batch is the reference, held in TRAIN_ENVELOPE's form as
# phase 12 (c) holds routes (the CPC step with phase 17's envelope and
# CPC_GRAD_FLOOR).  A rank's encoder runs its convs and bf16 GEMMs on half
# the rows, which the libraries may compute with other algorithms, and
# the tensor-parallel FFN rounds its sums in another order; either
# difference is the encoder's own bf16 rounding, so each tensor's envelope
# is the larger of the route's (phase 12's, 17's) and the encoder's: the
# one-process step's gradient with the encoder in bf16 against in fp32.
# The losses and the SLS batch statistics are held alike: within 2x the
# one-process step's own bf16-against-fp32-encoder difference (or
# E2E_TOL, whichever is larger).  Dropout is off where steps are
# compared: each rank draws its own masks.
PAR_RANKS = 2
PAR_BATCH = {"cuda": 14, "cpu": 2}  # rows a rank: (a); (b) and (c) take half
PAR_TRAINER = {"cuda": (14, 28, 28), "cpu": (2, 4, 4)}  # batch a rank, train, val rows
PAR_SERVE_BATCHES = 5  # (f): timed batches
# (g) the sequence-parallel flagship step, dp1 x sp2: the two ranks cut
# each clip's 201 frames 101 / 100 and step the same 14 rows with the
# encoder's dropout on (the masks the one-process step draws for them,
# the head's at its default 0.3); its reference is the one-process step
# on the same rows and route (the plain SAE and front end, which
# sp_model_config sets), held as (e) holds TP: each gradient within 2x
# the encoder's own bf16 rounding of that step (the same step with the
# encoder in fp32), the loss within E2E_TOL or 2x that rounding's
SP_TRAIN = (1, 2)           # (n_data, n_seq)
SP_TRAIN_DROPOUT = 0.1      # the encoder's dropout, attention and activation dropout


def flat_to_named(torch, flat, model) -> dict:
    """A flat buffer in ``named_parameters`` order -> {name: tensor}."""
    out, start = {}, 0
    for n, p_ in model.named_parameters():
        out[n] = torch.from_numpy(np.array(flat[start:start + p_.numel()])).view(p_.shape)
        start += p_.numel()
    return out


def envelope_check(got: dict, near: dict, far, envelope: dict, floor: float = 0.0):
    """TRAIN_ENVELOPE's form: per tensor, ``got`` within 2x ``envelope`` of
    ``near`` (the step it stands in for) and within 1.5x of ``far`` (the
    more exact route; None when there is none), or within ``floor`` of
    each; returns (every tensor holds, the worst ratios, the tensors held
    by the floor)."""
    ratios, floored, ok = {}, [], True
    for n, e in envelope.items():
        d_near = rel_l2(got[n], near[n])
        d_far = 0.0 if far is None else rel_l2(got[n], far[n])
        r = (d_near / e if e else (0.0 if d_near == 0 else math.inf),
             d_far / e if e else (0.0 if d_far == 0 else math.inf))
        ratios[n] = r
        if r[0] <= TRAIN_ENVELOPE[1] and r[1] <= TRAIN_ENVELOPE[0]:
            continue
        if d_near <= max(TRAIN_ENVELOPE[1] * e, floor) and d_far <= max(TRAIN_ENVELOPE[0] * e,
                                                                         floor):
            floored.append(n)
            continue
        ok = False
    worst = max(ratios, key=lambda n: max(ratios[n]))
    return ok, {"worst": [worst, *ratios[worst], envelope[worst]],
                "median_envelope_rel_l2": float(np.median(list(envelope.values())))}, floored


def within_loss_envelope(got: float, want: float, envelope: float) -> bool:
    """A DP / TP step's loss against the one-process step's (above)."""
    return abs(got - want) <= max(E2E_TOL, TRAIN_ENVELOPE[1] * envelope)


def phase_parallel(torch, tk, device, model, exp, wavs, batch: int, seed: int, counts,
                   zero_counts, want_only, score_utts_per_s):
    """Phase 19 (module docstring): (a)-(e) on two ranks spawned once, (f)
    in this process.  Returns (the run line's ``parallel`` figures, the
    kernels' launches by path)."""
    from sls_tpu_torch import config as C
    from sls_tpu_torch.data.pipeline import to_wire
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.models.sls import SLSDetector
    from sls_tpu_torch.parallel import distributed as dist
    from sls_tpu_torch.parallel import workers
    from sls_tpu_torch.parallel.launch import launch
    from sls_tpu_torch.parallel.sequence import sp_model_config
    from sls_tpu_torch.scores.writer import log_probs_to_scores
    from sls_tpu_torch.serve.scorer import build_scorer_from_params
    from sls_tpu_torch.train.loss import weighted_nll
    from sls_tpu_torch.train.steps import dequantize_wire, dropout_generator

    on_card = device.type == "cuda"
    b = PAR_BATCH[device.type]
    cut = wavs.shape[1]
    backend = dist.choose_backend(device.type, PAR_RANKS)
    res = {"backend": backend, "ranks": PAR_RANKS,
           "ranks_share_a_card": bool(on_card and backend == "gloo")}
    launches_by_path = {}
    cfg = dataclasses.replace(model.config, classifier_dropout=0.0)
    tcfg = exp.train
    dp_exp = C.ExperimentConfig(model=cfg, train=tcfg)

    def global_rows(rows, seed_):
        w = np.resize(wavs, (rows, cut)).astype(np.float32)
        return (to_wire(w, "int16"), np.random.default_rng(seed_).integers(0, 2, rows),
                np.ones(rows, np.float32))

    def on_dev(gb):
        return tuple(torch.from_numpy(np.asarray(x)).to(device) for x in gb)

    def sharing(cfg_):
        m = Detector(cfg_, device="meta")
        m.load_state_dict(model.state_dict(), strict=True, assign=True)
        return m

    def host(g):
        return {n: t.detach().cpu() for n, t in g.items()}

    def encode_f64(x, w_enc, b_enc, b_dec):
        return torch.relu((x.double() - b_dec.double()) @ w_enc.double()
                          + b_enc.double()).float()

    def decode_f64(codes, w_dec, b_dec):
        return (codes.double() @ w_dec.double() + b_dec.double()).float()

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    try:
        # -- the jobs' inputs (host arrays, configs) --------------------------------
        ga, ge = global_rows(PAR_RANKS * b, seed + 19), global_rows(b, seed + 20)
        gb_b, gb_c = global_rows(b, seed + 21), global_rows(b, seed + 22)
        fp32_enc = dataclasses.replace(cfg.encoder, dtype=torch.float32, approx_gelu=True)
        plain_sae = dataclasses.replace(cfg.sae, use_pallas=False)
        cpc_cfg = dataclasses.replace(
            cfg, use_cpc=True, cpc=C.CPCConfig(prediction_steps=CPC_STEPS),
            sae=dataclasses.replace(cfg.sae, variant="window_hard", window_size=WINDOW))
        cpc_exp = C.ExperimentConfig(model=cpc_cfg, train=dataclasses.replace(
            tcfg, cpc_weight=0.5))
        sls_exp = C.ExperimentConfig(model=C.ModelConfig(encoder=cfg.encoder, use_sae=False),
                                     train=tcfg)
        bt, n_train, n_val = PAR_TRAINER[device.type]
        d_exp = C.ExperimentConfig(model=model.config, train=dataclasses.replace(
            tcfg, batch_size=bt))
        d_train = (to_wire(synthetic_wavs(n_train, cut, seed + 23), "int16"),
                   np.random.default_rng(seed + 23).permutation(np.arange(n_train) % 2))
        d_val = (to_wire(synthetic_wavs(n_val, cut, seed + 24), "int16"),
                 np.random.default_rng(seed + 24).permutation(np.arange(n_val) % 2))
        tp_exp = C.ExperimentConfig(model=cfg, train=dataclasses.replace(
            tcfg, model_parallel=PAR_RANKS))
        # (g): the flagship with dropout on; the ranks apply sp_model_config
        sp_cfg = dataclasses.replace(model.config, encoder=dataclasses.replace(
            model.config.encoder, dropout=SP_TRAIN_DROPOUT,
            attention_dropout=SP_TRAIN_DROPOUT, activation_dropout=SP_TRAIN_DROPOUT))
        sp_exp = C.ExperimentConfig(model=sp_cfg, train=tcfg)
        sp_one = dataclasses.replace(sp_model_config(sp_cfg), encoder=dataclasses.replace(
            sp_model_config(sp_cfg).encoder, seq_axis=None))
        gg = global_rows(b, seed + 25)
        common = dict(device_type=device.type, return_weights=False, return_grads=False)
        go, abort = work / "go", work / "abort"
        jobs = [
            # the ranks start (spawn, imports, process group) while this
            # process computes the references, then wait for its word
            ("wait_for_path_rank", (str(go), str(abort), RANKS_TIMEOUT_S), {}),
            ("train_steps_rank", (dp_exp, "detector", {"seed": seed}, [ga, ga, ga]),
             dict(common, nan_step=1, grad_path=str(work / "grad_a.npy"), time_allreduce=True)),
            ("train_steps_rank", (cpc_exp, "detector", {"path": str(work / "cpc.pt")}, [gb_b]),
             dict(common, grad_path=str(work / "grad_b.npy"))),
            ("train_steps_rank", (sls_exp, "sls", {"seed": seed + 16}, [gb_c]), dict(common)),
            ("trainer_rank", (d_exp, "detector", str(work / "trainer"), d_train, d_val, bt, 1),
             dict(device_type=device.type)),
            ("train_steps_rank", (tp_exp, "detector", {"seed": seed}, [ge]),
             dict(common, grad_path=str(work / "grad_e.npy"))),
            ("train_steps_rank", (sp_exp, "detector", {"seed": seed}, [gg]),
             dict(common, sp=SP_TRAIN, grad_path=str(work / "grad_g.npy"),
                  time_allreduce=True)),
        ]
        box = {}

        def run_ranks():
            try:
                box["ranks"] = launch(workers.jobs_rank, PAR_RANKS, (jobs,),
                                      device_type=device.type, timeout_s=RANKS_TIMEOUT_S)
            except BaseException as exc:  # raised again in the phase's thread
                box["error"] = exc

        wall0 = time.time()
        ranks_thread = threading.Thread(target=run_ranks, daemon=True)
        ranks_thread.start()
        try:
            # -- references in this process, then the card is the ranks' ---------
            t_ref = time.perf_counter()
            ref = {}
            # (a) the kernel route, and (e) the plain route tensor parallelism takes
            for key, gb, route in (("a", ga, cfg), ("e", ge, dataclasses.replace(
                    cfg, sae=plain_sae))):
                m_ = sharing(route)
                loss_r, _, g_r = grads_of(torch, m_, tcfg, on_dev(gb), seed, device)
                g_r = host(g_r)
                loss_f, _, g_f = grads_of(torch, sharing(dataclasses.replace(
                    route, encoder=fp32_enc)), tcfg, on_dev(gb), seed, device)
                g_f = host(g_f)
                with plain_sae_kernels(tk):
                    _, _, g_p = grads_of(torch, sharing(cfg), tcfg, on_dev(gb), seed, device)
                g_p, g_t = host(g_p), g_r  # (e)'s route is the plain SAE route itself
                if route is cfg:
                    _, _, g_t = grads_of(torch, sharing(dataclasses.replace(
                        cfg, sae=plain_sae)), tcfg, on_dev(gb), seed, device)
                    g_t = host(g_t)
                # phase 12 (c)'s SAE envelope, and the encoder's rounding
                env = {n: max(rel_l2(g_p[n], g_t[n]), rel_l2(g_r[n], g_f[n])) for n in g_r}
                del g_p
                ref[key] = {"loss": loss_r, "g": g_r, "g_t": g_t,
                            "loss_env": abs(loss_r - loss_f), "env": env}
                del m_, g_f
                if on_card:
                    torch.cuda.empty_cache()

            # (b) the CPC detector: the flagship's weights, a seeded CPC head
            cpc_m = Detector(cpc_cfg, device=device,
                             generator=torch.Generator(device=device).manual_seed(seed + 17))
            cpc_m.load_state_dict(model.state_dict(), strict=False)
            torch.save(cpc_m.state_dict(), work / "cpc.pt")
            loss_bk, _, g_bk = grads_of(torch, cpc_m, cpc_exp.train, on_dev(gb_b), seed, device)
            rows3_2 = ("sae_encode_fused", "sae_decode_fused")
            with plain_sae_kernels(tk, rows3_2):
                _, _, g_bp = grads_of(torch, cpc_m, cpc_exp.train, on_dev(gb_b), seed, device)
            with plain_sae_kernels(tk, versions={"sae_encode_fused": encode_f64,
                                                 "sae_decode_fused": decode_f64}):
                _, _, g_bt = grads_of(torch, cpc_m, cpc_exp.train, on_dev(gb_b), seed, device)
            cpc_f = Detector(dataclasses.replace(cpc_cfg, encoder=fp32_enc), device="meta")
            cpc_f.load_state_dict(cpc_m.state_dict(), strict=True, assign=True)
            loss_bf, _, g_bf = grads_of(torch, cpc_f, cpc_exp.train, on_dev(gb_b), seed, device)
            g_bk, g_bp, g_bt, g_bf = (host(g) for g in (g_bk, g_bp, g_bt, g_bf))
            # phase 17's envelope (its run-to-run term lies far inside the encoder's)
            ref["b"] = {"loss": loss_bk, "g": g_bk, "g_t": g_bt,
                        "loss_env": abs(loss_bk - loss_bf),
                        "env": {n: max(rel_l2(g_bp[n], g_bt[n]), rel_l2(g_bk[n], g_bf[n]))
                                for n in g_bp}}
            del cpc_m, cpc_f, g_bp, g_bf

            # (c) the SLS detector, seeded as phase 16 draws it
            sls_m = SLSDetector(sls_exp.model, device=device, cut_length=cut,
                                generator=torch.Generator(device=device).manual_seed(seed + 16))
            sls_f = SLSDetector(dataclasses.replace(sls_exp.model, encoder=fp32_enc),
                                device="meta", cut_length=cut)
            sls_f.load_state_dict(sls_m.state_dict(), strict=True, assign=True)
            sls_one = {}
            with torch.no_grad():
                w_, y_, v_ = on_dev(gb_c)
                for key, m_ in (("bf16", sls_m), ("fp32_encoder", sls_f)):
                    out = m_(dequantize_wire(w_), train=True,
                             generator=dropout_generator(0, 0, device))
                    sls_one[key] = [float(weighted_nll(out["log_probs"], y_, tcfg.loss_weights,
                                                       v_)),
                                    *(float(t) for t in out["bn_stats"])]
                old_stats = [float(sls_m.sls_head.first_bn.running_mean),
                             float(sls_m.sls_head.first_bn.running_var)]
            del sls_m, sls_f, out

            # (g) the one-process step on the same rows and route, call 0's
            # masks of base seed 0 (the ranks' first step), and with the
            # encoder in fp32 for the envelope
            m_ = sharing(sp_one)
            loss_g, _, g_g = grads_of(torch, m_, tcfg, on_dev(gg), 0, device)
            g_g = host(g_g)
            loss_gf, _, g_gf = grads_of(torch, sharing(dataclasses.replace(
                sp_one, encoder=dataclasses.replace(sp_one.encoder, dtype=torch.float32,
                                                    approx_gelu=True))),
                tcfg, on_dev(gg), 0, device)
            g_gf = host(g_gf)
            ref["g"] = {"loss": loss_g, "g": g_g, "loss_env": abs(loss_g - loss_gf),
                        "env": {n: rel_l2(g_g[n], g_gf[n]) for n in g_g}}
            del m_, g_gf
            if on_card:
                torch.cuda.empty_cache()
            res["references_s"] = time.perf_counter() - t_ref

            # (d) room for the Trainer's checkpoints
            ckpt_bytes = 4 * (sum(t.numel() for t in model.state_dict().values())
                              + 2 * sum(p.numel() for p in model.parameters()))
            free = shutil.disk_usage(work).free
            check(free >= CKPT_FILES_FREE * ckpt_bytes,
                  f"{work} must hold {CKPT_FILES_FREE} checkpoints of ~{ckpt_bytes / 1e9:.2f} "
                  f"GB and has {free / 1e9:.1f} GB free: point TMPDIR at a larger disk")
            if on_card:
                torch.cuda.empty_cache()
        except BaseException:
            abort.touch()
            ranks_thread.join()
            raise

        # -- the two ranks: (a)-(e) in order -------------------------------------
        log(f"phase 19: {PAR_RANKS} ranks over {backend}"
            + (f", sharing {torch.cuda.device_count()} card(s)" if on_card else "")
            + f": (a) DP flagship step {b} + {b} rows, (b) DP CPC {b // 2} + {b // 2}, (c) DP "
            f"SLS {b // 2} + {b // 2}, (d) Trainer {n_train} / {n_val} utterances at {bt} a "
            f"rank, (e) TP step model_parallel {PAR_RANKS} on {b} rows, (g) dp{SP_TRAIN[0]} x "
            f"sp{SP_TRAIN[1]} step on {b} rows, dropout {SP_TRAIN_DROPOUT}; references in "
            f"{res['references_s']:.1f} s")
        t0 = time.perf_counter()
        go.touch()
        ranks_thread.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        res["ranks_s"] = time.perf_counter() - t0  # from the word to go
        waited, a, bb, c, d, e, g = ([r[i] for r in ranks] for i in range(7))
        res["job_s_by_rank"] = {k: [r["job_s"] for r in job] for k, job in
                                zip(("a", "b", "c", "d", "e", "g"), (a, bb, c, d, e, g))}
        # the ranks' start-up (spawn, imports, process group), under the
        # references, and their wind-down after the last job
        res["ranks_start_s"] = [r["job_wall"][0] - wall0 for r in waited]
        res["ranks_end_s"] = [time.time() - r["job_wall"][1] for r in g]
        log(f"phase 19: the ranks started in {max(res['ranks_start_s']):.1f} s under the "
            f"references, then ran for {res['ranks_s']:.1f} s (wind-down "
            f"{min(res['ranks_end_s']):.1f} s), jobs (s a rank): "
            f"{json.dumps(res['job_s_by_rank'])}")

        # (a) DP flagship step
        g_a = flat_to_named(torch, np.load(work / "grad_a.npy", mmap_mode="r"), model)
        ok, worst, floored = envelope_check(g_a, ref["a"]["g"], ref["a"]["g_t"],
                                            ref["a"]["env"])
        ra = {"loss": a[0]["steps"][0]["terms"][0], "loss_one_process": ref["a"]["loss"],
              "loss_envelope": ref["a"]["loss_env"],
              "step_ms_by_rank": [[s_["ms"] for s_ in r["steps"]] for r in a],
              "allreduce_ms": [r.get("allreduce_ms") for r in a],
              "peak_gib_by_rank": [r["peak_bytes"] / 2**30 for r in a],
              "grad_vs_one_process": worst, "launches_by_rank": [r["launches"] for r in a],
              "nan_step_bits_kept": [r["steps"][1]["bits_kept"] for r in a]}
        res["a_dp_flagship"] = ra
        log(f"phase 19 (a) DP flagship step: {json.dumps(ra)}")
        check(within_loss_envelope(ra["loss"], ra["loss_one_process"], ref["a"]["loss_env"]),
              "the DP step's loss agrees with the one-process step on the whole batch")
        check(ok, "every gradient of the DP step is within TRAIN_ENVELOPE of the one-process "
                  "step's")
        check(all(r["steps"][i]["terms"] == a[0]["steps"][i]["terms"] for r in a
                  for i in (0, 2)), "both ranks report the same global loss terms")
        check(a[0]["steps"][0]["grad_sums"] == a[1]["steps"][0]["grad_sums"],
              "both ranks hold the same summed gradient")
        check(all(r["steps"][0]["finite"] and not r["steps"][1]["finite"]
                  and r["steps"][2]["finite"] for r in a),
              "the NaN in rank 1's rows rejects that step on both ranks, and only that one")
        check(all(r["steps"][1]["bits_kept"] for r in a),
              "the rejected step leaves both ranks' state bit for bit as it was")
        check(a[0]["checksum"] == a[1]["checksum"] and a[0]["step"] == a[1]["step"] == 2,
              "after the steps both ranks hold the same weights and moments")
        if on_card:
            for r in a:
                want_only("DP flagship step, one rank", r["launches"],
                          {"sae_encode_topk_fused": 3, "sae_decode_fused": 3})
        launches_by_path["dp_train_flagship"] = {
            n: sum(r["launches"][n] for r in a) for n in KERNELS}

        # (b) DP CPC step
        g_b = flat_to_named(torch, np.load(work / "grad_b.npy", mmap_mode="r"),
                            Detector(cpc_cfg, device="meta"))
        ok, worst, floored = envelope_check(g_b, ref["b"]["g"], ref["b"]["g_t"],
                                            ref["b"]["env"], floor=CPC_GRAD_FLOOR)
        rb_ = {"loss": bb[0]["steps"][0]["terms"][0], "loss_one_process": ref["b"]["loss"],
               "loss_envelope": ref["b"]["loss_env"],
               "cpc_loss": bb[0]["steps"][0]["terms"][3], "grad_vs_one_process": worst,
               "held_by_floor": floored, "step_ms_by_rank": [r["steps"][0]["ms"] for r in bb],
               "launches_by_rank": [r["launches"] for r in bb]}
        res["b_dp_cpc"] = rb_
        log(f"phase 19 (b) DP CPC step: {json.dumps(rb_)}")
        check(within_loss_envelope(rb_["loss"], rb_["loss_one_process"], ref["b"]["loss_env"])
              and rb_["cpc_loss"] > 0,
              "the DP CPC step's loss agrees with the one-process step's; its CPC loss is live")
        check(ok, "every gradient of the DP CPC step is within phase 17's envelope of the "
                  "one-process step's (CPC_GRAD_FLOOR included)")
        check(bb[0]["checksum"] == bb[1]["checksum"], "the DP CPC ranks hold the same weights")
        if on_card:
            for r in bb:
                want_only("DP CPC step, one rank", r["launches"],
                          {"sae_encode_fused": 1, "sae_decode_fused": 1})
        launches_by_path["dp_train_cpc"] = {
            n: sum(r["launches"][n] for r in bb) for n in KERNELS}

        # (c) DP SLS step: [loss, batch mean, batch variance] against the
        # one-process forward on the whole batch, in the encoder's envelope
        stats = [[float(r["buffers"][f"sls_head.first_bn.running_{k}"][0]) for k in
                  ("mean", "var")] for r in c]
        dp = [c[0]["steps"][0]["terms"][0], *c[0]["steps"][0]["bn_stats"]]
        one, one_f = sls_one["bf16"], sls_one["fp32_encoder"]
        want_stats = [0.9 * old_stats[0] + 0.1 * dp[1], 0.9 * old_stats[1] + 0.1 * dp[2]]
        rc = {"loss_mean_var": dp, "one_process": one, "one_process_fp32_encoder": one_f,
              "running_stats_by_rank": stats, "want_0.9_old_0.1_batch": want_stats,
              "step_ms_by_rank": [r["steps"][0]["ms"] for r in c]}
        res["c_dp_sls"] = rc
        log(f"phase 19 (c) DP SLS step: {json.dumps(rc)}")
        check(all(within_loss_envelope(dp[i], one[i], abs(one[i] - one_f[i])) for i in range(3)),
              "the DP SLS step's loss and batch statistics agree with the one-process forward "
              "on the whole batch")
        check(stats[0] == stats[1] and c[0]["checksum"] == c[1]["checksum"]
              and c[0]["steps"][0]["bn_stats"] == c[1]["steps"][0]["bn_stats"],
              "both SLS ranks hold the same batch and running statistics and weights")
        # a mean's fp32 rounding is relative to the elements' RMS, not to itself
        scale = [0.1 * math.sqrt(dp[2] + dp[1] ** 2), want_stats[1]]
        check(all(abs(g_ - w_) <= SLS_STATS_REL * s_ for g_, w_, s_ in zip(
            stats[0], want_stats, scale)),
              "the running statistics are 0.9 old + 0.1 the global batch's")
        check(all(n == 0 for r in c for n in r["launches"].values()),
                  "the SLS step launches no hand-written kernel")

        # (d) Trainer across the ranks
        run = work / "trainer"
        rows = csv_rows(run)
        rd = {"fit_s_by_rank": [r["fit_s"] for r in d], "epoch": d[0]["metrics"],
              "csv_rows": len(rows), "files": sorted(p_.name for p_ in run.iterdir()),
              "launches_by_rank": [r["launches"] for r in d]}
        res["d_trainer"] = rd
        log(f"phase 19 (d) Trainer across the ranks: {json.dumps(rd)}")
        check(d[0]["metrics"] == d[1]["metrics"], "both ranks report the same epoch figures")
        check(d[0]["checksum"] == d[1]["checksum"], "both Trainer ranks hold the same weights")
        check(len(rows) == 1 and rd["files"] == ["best.ckpt", "last.ckpt", "training_log.csv"],
              "the primary alone wrote one CSV row and the checkpoints")
        steps_a_rank = (n_train // PAR_RANKS) // bt
        val_a_rank = -(-(n_val // PAR_RANKS) // bt)
        if on_card:
            for r in d:
                want_only("Trainer epoch, one rank", r["launches"],
                          {"sae_encode_topk_fused": steps_a_rank + val_a_rank,
                           "sae_decode_fused": steps_a_rank + val_a_rank})
        launches_by_path["dp_trainer"] = {n: sum(r["launches"][n] for r in d) for n in KERNELS}
        shutil.rmtree(run)

        # (e) TP step
        g_e = flat_to_named(torch, np.load(work / "grad_e.npy", mmap_mode="r"), model)
        ok, worst, floored = envelope_check(g_e, ref["e"]["g"], None, ref["e"]["env"])
        re_ = {"loss": e[0]["steps"][0]["terms"][0], "loss_one_process_plain_route":
               ref["e"]["loss"], "loss_envelope": ref["e"]["loss_env"],
               "grad_vs_one_process_plain_route": worst,
               "step_ms_by_rank": [r["steps"][0]["ms"] for r in e],
               "peak_gib_by_rank": [r["peak_bytes"] / 2**30 for r in e],
               "launches_by_rank": [r["launches"] for r in e]}
        res["e_tp"] = re_
        log(f"phase 19 (e) TP step: {json.dumps(re_)}")
        check(within_loss_envelope(re_["loss"], ref["e"]["loss"], ref["e"]["loss_env"]),
              "the TP step's loss agrees with the one-process plain-route step's")
        check(ok, "every gradient of the TP step is within TRAIN_ENVELOPE of the one-process "
                  "plain-route step's")
        check(e[0]["steps"][0]["terms"] == e[1]["steps"][0]["terms"],
              "both TP ranks compute the same loss")
        check(all(n == 0 for r in e for n in r["launches"].values()),
              "under TP no SAE kernel (rows 1-3, 5) is launched: the plain route")
        launches_by_path["tp_train"] = {n: sum(r["launches"][n] for r in e) for n in KERNELS}

        # (g) sequence-parallel step
        g_sp = flat_to_named(torch, np.load(work / "grad_g.npy", mmap_mode="r"), model)
        ok, worst, floored = envelope_check(g_sp, ref["g"]["g"], None, ref["g"]["env"])
        frames = model.config.encoder.num_frames(cut)
        chunk = -(-frames // SP_TRAIN[1])
        rg = {"mesh": {"data": SP_TRAIN[0], "seq": SP_TRAIN[1]}, "frames": frames,
              "frames_by_rank": [min(chunk, frames - i * chunk) for i in range(SP_TRAIN[1])],
              "dropout": SP_TRAIN_DROPOUT, "loss": g[0]["steps"][0]["terms"][0],
              "loss_one_process": ref["g"]["loss"], "loss_envelope": ref["g"]["loss_env"],
              "grad_vs_one_process": worst, "held_by_floor": floored,
              "step_ms_by_rank": [r["steps"][0]["ms"] for r in g],
              "allreduce_ms": [r.get("allreduce_ms") for r in g],
              "peak_gib_by_rank": [r["peak_bytes"] / 2**30 for r in g],
              "launches_by_rank": [r["launches"] for r in g]}
        res["g_sp_train"] = rg
        log(f"phase 19 (g) SP flagship step: {json.dumps(rg)}")
        check(within_loss_envelope(rg["loss"], ref["g"]["loss"], ref["g"]["loss_env"]),
              "the SP step's loss agrees with the one-process step on the same rows")
        check(ok, "every gradient of the SP step is within 2x the encoder's bf16 rounding of "
                  "the one-process step's")
        check(all(r["steps"][0]["terms"] == g[0]["steps"][0]["terms"] for r in g)
              and g[0]["steps"][0]["grad_sums"] == g[1]["steps"][0]["grad_sums"],
              "both seq ranks report the same loss terms and summed gradient")
        check(g[0]["checksum"] == g[1]["checksum"], "both seq ranks hold the same weights")
        check(all(n == 0 for r in g for n in r["launches"].values()),
              "the SP step launches no SAE kernel (nor any other hand-written kernel)")
        launches_by_path["sp_train"] = {n: sum(r["launches"][n] for r in g) for n in KERNELS}
        del ref, g_a, g_b, g_e, g_sp
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (f) DP serving: two replicas on the card, each batch cut in halves
    devices = [device] * PAR_RANKS
    _, dp_fn, _ = build_scorer_from_params(exp, model.state_dict(), batch, "int16", device,
                                           devices=devices)
    _, one_fn, _ = build_scorer_from_params(exp, model.state_dict(), batch // PAR_RANKS,
                                            "int16", device, warmup=False)
    wire_b = to_wire(np.resize(wavs, (batch, cut)).astype(np.float32), "int16")
    zero_counts()
    got = dp_fn(wire_b)
    launched = counts()
    halves = torch.cat([one_fn(h) for h in np.split(wire_b, PAR_RANKS)])
    diff = float(np.abs(log_probs_to_scores(got) - log_probs_to_scores(halves)).max())
    sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(PAR_SERVE_BATCHES):
        dp_fn(wire_b)
    sync(torch, device)
    rf = {"replicas": len(devices), "batch": batch, "max_score_diff_vs_one_replica": diff,
          "utts_per_s": PAR_SERVE_BATCHES * batch / (time.perf_counter() - t0),
          "phase_3_score_utts_per_s": score_utts_per_s, "launches": launched}
    res["f_dp_serving"] = rf
    log(f"phase 19 (f) DP serving, {len(devices)} replicas on one card: {json.dumps(rf)}")
    check(diff <= SERVE_TOL, "the DP scorer's scores are the one-replica scorer's on the halves")
    if on_card:
        want_only("DP serving batch", launched, {"sae_encode_topk_fused": PAR_RANKS})
    launches_by_path["dp_serving"] = launched
    del dp_fn, one_fn
    return res, launches_by_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print each path's eval-step device time by kernel")
    ap.add_argument("--cli-only", action="store_true",
                    help="phases 1 and 18 alone, for work on the entry points (a partial "
                         "run: it prints no result lines)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="phases 1 and 19 alone, for work on training across ranks and "
                         "serving over several devices (a partial run: no result lines)")
    ap.add_argument("--parent", metavar="DIR",
                    help="a git archive of another commit's sls_tpu_torch/ (e.g. the "
                         "parent's): phase 2 times its wrappers of rows 1-5 and 8 beside "
                         "this tree's")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    if not (Path(__file__).resolve().parent / "sls_tpu_torch").is_dir():
        # the port and its kernel sources must come from this checkout
        print("chip_smoke: no sls_tpu_torch/ beside this script; run it from the repo",
              file=sys.stderr)
        return 2

    from sls_tpu_torch import config as C
    from sls_tpu_torch.augment import rawboost as rb
    from sls_tpu_torch.data.audio import pad_or_tile
    from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
    from sls_tpu_torch.encoder import xlsr
    from sls_tpu_torch.evaluation import overlap as ev
    from sls_tpu_torch.kernels import attention as ta
    from sls_tpu_torch.kernels import build
    from sls_tpu_torch.kernels import frontend as tf
    from sls_tpu_torch.kernels import sae_kernels as tk
    from sls_tpu_torch.models.detector import Detector
    from sls_tpu_torch.parallel import distributed as dist
    from sls_tpu_torch.parallel import workers
    from sls_tpu_torch.parallel.launch import launch
    from sls_tpu_torch.parallel.sequence import sp_model_config
    from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
    from sls_tpu_torch.serve.engine import BatchingEngine
    from sls_tpu_torch.serve.scorer import build_scorer_from_params
    from sls_tpu_torch.train.loop import _PIPELINE_DEPTH as PIPELINE_DEPTH
    from sls_tpu_torch.train.loop import Trainer, epoch_row, produce_scores
    from sls_tpu_torch.train.steps import (
        create_train_state,
        dequantize_wire,
        make_eval_step,
        make_train_step,
    )

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    t_start = time.perf_counter()

    # -- phase 1: device and build ------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    if on_card:
        card = gpu_line()
        log(card)  # name, power limit
        t0 = time.perf_counter()
        out_dir = build.build_all()
        log(f"build: {len(build.sources())} sources with nvcc into {out_dir} "
            f"in {time.perf_counter() - t0:.2f} s")
        batch = 36
        enc_cfg = C.XLSRConfig(dtype=torch.bfloat16)
        sae_cfg = C.SAEConfig(activation_dim=1024, dict_size=4096, k=128, use_pallas=True)
        cut = 64600
        long_targets = (256, 512, 1280, 2560, 5120)  # length_buckets' defaults
        attn_long, attn_short = (1, 5120, 1024, 16), (batch, 201, 16, 64)
    else:
        log("rehearsal on the CPU: plain versions at a tiny size; no device result")
        batch = 4
        # the long-T route from 256 frames on, so phase 6 takes it
        enc_cfg = C.tiny_xlsr_config(dtype=torch.bfloat16, flash_long_t=256)
        sae_cfg = C.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True)
        cut = 4005  # the fused front-end's gate holds here (not at 4000)
        long_targets = (64, 256, 512)
        attn_long, attn_short = (1, 1024, 256, 4), (batch, 50, 4, 64)
    cfg = C.ModelConfig(encoder=enc_cfg, sae=sae_cfg)
    exp = C.ExperimentConfig(model=cfg, train=C.TrainConfig(cut_length=cut))
    frames = enc_cfg.num_frames(cut)

    modules = {**{n: tk for n in SAE_KERNELS}, **{n: ta for n in ATTN_KERNELS},
               **{n: tf for n in FRONTEND_KERNELS}}
    wrappers = {name: getattr(modules[name], name) for name in KERNELS}

    def zero_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def want_only(label, launches, expected):
        want = {n: 0 for n in KERNELS}
        want.update(expected)
        check(launches == want, f"{label}: launches {launches}, want {want}")

    if args.cli_only:
        log("--cli-only: phase 18 alone on the flagship's seeded weights (a partial run: no "
            "result lines)")
        model = Detector(cfg, device=device,
                         generator=torch.Generator(device=device).manual_seed(args.seed))
        phase_cli(torch, device, model, exp, batch, args.seed, counts, zero_counts, want_only,
                  None, None)
        log(f"phase 18 in {time.perf_counter() - t_start:.1f} s (with phase 1)")
        return 0
    if args.parallel_only:
        log("--parallel-only: phase 19 alone on the flagship's seeded weights (a partial run: "
            "no result lines)")
        model = Detector(cfg, device=device,
                         generator=torch.Generator(device=device).manual_seed(args.seed))
        wavs = synthetic_wavs(FULL_BATCHES * batch + batch // 5 + 1, cut, args.seed)
        phase_parallel(torch, tk, device, model, exp, wavs, batch, args.seed, counts,
                       zero_counts, want_only, None)
        log(f"phase 19 in {time.perf_counter() - t_start:.1f} s (with phase 1)")
        return 0

    # -- phase 2: kernels against their plain versions ----------------------
    shape = (batch, frames, sae_cfg.activation_dim, sae_cfg.dict_size, sae_cfg.k)
    log(f"phase 2: kernels at N={batch * frames} ({batch}x{frames}) D={shape[2]} "
        f"M={shape[3]} k={shape[4]} window={WINDOW}")
    parent = load_parent(args.parent) if on_card and args.parent else None
    rows = phase_kernels(torch, tk, device, shape, iters=20 if on_card else 2, parent=parent)
    log(f"phase 2: attention at [B, T, C, H] {attn_long} (long T) and [B, T, H, Dh] "
        f"{attn_short} (short T), bf16")
    rows += phase_attention(torch, ta, device, attn_long, attn_short,
                            iters=20 if on_card else 2)
    n_utts = FULL_BATCHES * batch + batch // 5 + 1  # and a short tail batch
    wavs = synthetic_wavs(n_utts, cut, args.seed)
    wire = to_wire(wavs, "int16")
    log(f"phase 2: the conv front-end tail on conv 0's output of {batch} utterances of {cut} "
        f"samples, {enc_cfg.conv_layers[0][0]} channels, {enc_cfg.dtype}")
    rows.append(phase_frontend(torch, tf, xlsr, enc_cfg, wavs[:batch], device,
                               iters=20 if on_card else 2, parent=parent))
    per_batch = path_kernels(enc_cfg.encoder_layers)

    reps = 10 if on_card else 1

    def drive(label, model, exp_cfg, encode_k, encode_p):
        """One path: produce_scores with its launch counts, the kernels
        against the plain versions end to end, throughput, and serving.
        ``encode_k`` / ``encode_p`` map flat features to codes [2, T, M]
        through the kernels / the plain versions."""
        loader = ArrayLoader(wire, None, batch_size=batch)
        step = make_eval_step(model, device=device)
        step(wire[:batch])  # one-time setup (library handles) outside the counted run
        sync(torch, device)
        if on_card:
            torch.cuda.reset_peak_memory_stats()

        zero_counts()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "scores.txt"
            t0 = time.perf_counter()
            written = produce_scores(step, loader, path)
            t_scores = time.perf_counter() - t0
            launches = counts()
            ids, scores = read_score_file(path)
        n_batches = loader.num_batches()
        log(f"{label} produce_scores: {written} lines in {t_scores:.3f} s over {n_batches} "
            f"batches; launches {launches}")
        check(written == n_utts and len(ids) == n_utts, "one score line per utterance")
        check(ids == [f"utt_{i}" for i in range(n_utts)], "score lines in utterance order")
        check(bool(np.all(np.isfinite(scores))), "every score is finite")
        check(bool(np.all((scores >= 0) & (scores <= 1))), "every score lies in [0, 1]")
        if on_card:
            for name, count in launches.items():
                want = n_batches * per_batch[label].get(name, 0)
                check(count == want, f"{label}: {name} launched {count} times, want {want}")

        # end to end on a small input: kernels vs plain versions, same features
        small = torch.from_numpy(wire[:2]).to(device)
        sae = model.sae
        with torch.inference_mode():
            feats = model.encoder(dequantize_wire(small)).float()
            flat = feats.reshape(-1, feats.shape[-1])
            c_k, c_p = encode_k(flat), encode_p(flat)
            lp_k, lp_p = model.classifier(c_k), model.classifier(c_p)
            codes = c_k.reshape(flat.shape[0], -1)
            r_k = tk.sae_decode_fused(codes, sae.W_dec, sae.b_dec)
            r_p = tk.sae_decode_fused_plain(codes, sae.W_dec, sae.b_dec)
        e2e = float((lp_k - lp_p).abs().max())
        loss_k, loss_p = float(((r_k - flat) ** 2).mean()), float(((r_p - flat) ** 2).mean())
        log(f"{label} end to end (2 utterances): log_probs kernels vs plain max_abs {e2e:.3e}; "
            f"sae_loss {loss_k:.6f} vs {loss_p:.6f}")
        check(e2e <= E2E_TOL, "log-probs through the kernels agree with the plain versions")
        check(math.isclose(loss_k, loss_p, rel_tol=1e-4), "sae_loss agrees")

        def throughput(fn):
            batch_wire = wire[:batch]
            fn(batch_wire)
            sync(torch, device)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(batch_wire)
            sync(torch, device)
            return reps * batch / (time.perf_counter() - t0)

        def score_only(w):
            with torch.inference_mode():
                return model.score(dequantize_wire(torch.from_numpy(w).to(device)))

        res = {"launches": launches, "eval_utts_per_s": throughput(step),
               "score_utts_per_s": throughput(score_only), "scores": dict(zip(ids, scores))}
        log(f"{label} throughput at batch {batch}: eval step {res['eval_utts_per_s']:.1f} "
            f"utts/s, score() {res['score_utts_per_s']:.1f} utts/s")
        if on_card:
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            log(f"{label} peak device memory {res['peak_gib']:.2f} GiB")
            if args.profile:
                prof = profile_step(step, wire[:batch])
                log(json.dumps({"profile": {"path": label, **prof}}))

        # serving: a bucket batch, a full batch and a bucket batch
        bucket = max(batch // 3, 2)
        n_partial = n_tail = bucket // 2  # both fit the bucket shape
        _, score_fn, _ = build_scorer_from_params(
            exp_cfg, model.state_dict(), batch_size=batch, wire_dtype="int16", device=device,
            bucket_sizes=(bucket,))
        rng = np.random.default_rng(args.seed + 1)
        clips = [wavs[i % n_utts][: int(rng.integers(cut // 4, cut))]
                 for i in range(n_partial + batch + n_tail)]

        def offline(idx, shape_):
            rows_ = [pad_or_tile(clips[i], cut) for i in idx]
            rows_ += [rows_[0]] * (shape_ - len(rows_))
            w = torch.from_numpy(to_wire(np.stack(rows_), "int16")).to(device)
            with torch.inference_mode():
                return log_probs_to_scores(model.score(dequantize_wire(w)))[: len(idx)]

        encoders = [n for n in per_batch[label] if n != "sae_decode_fused"]
        before = {n: wrappers[n].launches for n in encoders}
        partial = list(range(n_partial))
        multi = list(range(n_partial, len(clips)))
        with BatchingEngine(score_fn, batch, cut=cut, wire_dtype="int16",
                            bucket_sizes=(bucket,), max_wait_ms=500) as engine:
            got_partial = np.array([f.result(timeout=120) for f in
                                    [engine.submit(clips[i]) for i in partial]])
            got_multi = np.array([f.result(timeout=120) for f in
                                  [engine.submit(clips[i]) for i in multi]])
            stats = engine.stats().to_dict()
        served = {n: wrappers[n].launches - before[n] for n in encoders}
        want_partial = offline(partial, bucket)
        want_multi = np.concatenate([offline(multi[:batch], batch),
                                     offline(multi[batch:], bucket)])
        d1 = float(np.abs(got_partial - want_partial).max())
        d2 = float(np.abs(got_multi - want_multi).max())
        log(f"{label} serving: {len(partial)} + {len(multi)} requests; served vs offline "
            f"max_abs {d1:.3e} / {d2:.3e} (tolerance {SERVE_TOL}); kernel launches {served}; "
            f"stats {json.dumps(stats)}")
        check(stats["requests"] == len(clips) and stats["batches"] == 3,
              "requests grouped into a bucket batch, a full batch and a bucket batch")
        check(d1 <= SERVE_TOL and d2 <= SERVE_TOL, "served scores equal offline scores")
        if on_card:
            for n, count in served.items():
                check(count == stats["batches"] * per_batch[label][n],
                      f"serving launched {n} {per_batch[label][n]} times a batch")
        return res

    k = sae_cfg.k

    # -- phases 3-4: the flagship path ---------------------------------------
    log(f"phase 3: flagship detector, {enc_cfg.encoder_layers} layers, "
        f"{enc_cfg.embed_dim}/{enc_cfg.ffn_dim}, {enc_cfg.num_heads} heads, "
        f"dict {sae_cfg.dict_size}, k {k}, batch {batch}, int16 wire")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = Detector(cfg, device=device, generator=gen)
    sae = model.sae
    results = {"flagship": drive(
        "flagship", model, exp,
        lambda f: tk.sae_encode_topk_fused(f, sae.W_enc, sae.b_enc, sae.b_dec, k
                                           ).reshape(2, frames, -1),
        lambda f: tk.sae_encode_topk_fused_plain(f, sae.W_enc, sae.b_enc, sae.b_dec, k
                                                 ).reshape(2, frames, -1))}

    # -- phase 5: the window-overlap path, on the flagship's weights ----------
    win_cfg = dataclasses.replace(cfg, sae=dataclasses.replace(
        sae_cfg, variant="window_overlap", window_size=WINDOW))
    log(f"phase 5: window-overlap detector (window {WINDOW}), the flagship's weights")
    win_model = Detector(win_cfg, device="meta")  # no init: the weights are shared
    win_model.load_state_dict(model.state_dict(), strict=True, assign=True)
    results["window_overlap"] = drive(
        "window_overlap", win_model, dataclasses.replace(exp, model=win_cfg),
        lambda f: tk.window_vote_fused(
            tk.sae_encode_fused(f, sae.W_enc, sae.b_enc, sae.b_dec).reshape(2, frames, -1),
            k, WINDOW),
        lambda f: tk.window_vote_fused_plain(
            tk.sae_encode_fused_plain(f, sae.W_enc, sae.b_enc, sae.b_dec).reshape(2, frames, -1),
            k, WINDOW))

    # -- phase 6: long-clip unwindowed scoring, on the flagship's weights -----
    layers = enc_cfg.encoder_layers
    buckets = ev.length_buckets(enc_cfg, long_targets)
    if on_card:
        lengths = [16000 * sec for sec in LONG_CLIP_SECONDS]
    else:  # the same bucket pattern at the tiny size
        b_ = sorted(buckets.values())
        lengths = [b_[0] - 100, b_[-2] - 100, b_[-1] - 100, b_[-1] + b_[-1] // 2]
    long_clips = [(f"clip_{n / 16000:g}s", synthetic_wavs(1, n, args.seed + 3 + i)[0])
                  for i, n in enumerate(lengths)]
    log(f"phase 6: unwindowed scoring of {[u for u, _ in long_clips]}, buckets {buckets}, "
        f"flash_long_t {enc_cfg.flash_long_t}")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    long_out, seen = [], counts()
    for utt, score, t_bucket in ev.score_utterances_unwindowed(
            model, iter(long_clips), enc_cfg, t_targets=long_targets, device=device):
        now = counts()
        long_out.append((utt, score, t_bucket, {n: now[n] - seen[n] for n in now}))
        seen = now
    long_launches = counts()
    long_res = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30} if on_card else {}
    for utt, score, t_bucket, delta in long_out:
        log(f"  {utt}: score {score:.6f}, bucket T {t_bucket}, launches {delta}")
    check([u for u, *_ in long_out] == [u for u, _ in long_clips], "scores in input order")
    check(all(np.isfinite(sc) and 0 <= sc <= 1 for _, sc, _, _ in long_out),
          "every long-clip score is finite and in [0, 1]")
    check([t for _, _, t, _ in long_out] == [long_targets[0]] + [long_targets[-2]]
          + [long_targets[-1]] * 2, "clips land in the expected buckets")
    if on_card:
        for utt, _, t_bucket, delta in long_out:
            flash = layers if t_bucket >= enc_cfg.flash_long_t else 0
            want = {n: 0 for n in KERNELS}
            want.update(sae_encode_topk_fused=1, flash_attention_long=flash)
            check(delta == want, f"{utt}: launches {delta}, want {want}")

    # the same weights on the reference's einsum route (a config, not a
    # fallback), and in fp32 on that route (the truth both bf16 routes
    # are measured from; tanh GELU as the bf16 encoder's)
    def sharing(enc, sae_=sae_cfg):
        m = Detector(dataclasses.replace(cfg, encoder=enc, sae=sae_), device="meta")
        m.load_state_dict(model.state_dict(), strict=True, assign=True)
        return m

    plain_model = sharing(dataclasses.replace(enc_cfg, flash_long_t=0))
    fp32_encoder = sharing(dataclasses.replace(enc_cfg, flash_long_t=0, dtype=torch.float32,
                                               approx_gelu=True)).encoder

    def forward_ms(m, w, n):
        with torch.inference_mode():
            return timed(torch, lambda: m.score(w), device, n)

    long_res.update(ms_per_forward={}, einsum_route_ms_per_forward={}, audio_s_per_s={},
                    max_log_prob_diff=0.0)
    with torch.inference_mode():
        for utt, wav in long_clips:
            rows_, t_bucket = ev.unwindowed_batch(wav, buckets)
            w = torch.from_numpy(rows_).to(device)
            diff = float((model.score(w) - plain_model.score(w)).abs().max())
            long_res["max_log_prob_diff"] = max(long_res["max_log_prob_diff"], diff)
            if t_bucket == long_targets[-2]:
                f_k, f_p = model.encoder(w).float(), plain_model.encoder(w).float()
                truth = fp32_encoder(w)
                long_res["encoder_rel_l2"] = {
                    "kernel_vs_einsum_route": rel_l2(f_k, f_p),
                    "kernel_route_vs_fp32": rel_l2(f_k, truth),
                    "einsum_route_vs_fp32": rel_l2(f_p, truth)}
                envelope_rows = (rows_, f_p, truth)  # phase 10 holds its route to them
            if len(rows_) == 1 and t_bucket >= long_targets[-2]:
                ms = forward_ms(model, w, 3 if on_card else 1)
                long_res["ms_per_forward"][t_bucket] = ms
                long_res["einsum_route_ms_per_forward"][t_bucket] = forward_ms(
                    plain_model, w, 3 if on_card else 1)
                long_res["audio_s_per_s"][t_bucket] = rows_.shape[1] / 16000 / (ms / 1e3)
                if on_card and args.profile and t_bucket == long_targets[-1]:
                    prof = profile_step(lambda x: model.score(x), w)
                    log(json.dumps({"profile": {"path": f"long_clip_T{t_bucket}", **prof}}))
    log(f"long clip: {json.dumps(long_res)}")
    check(long_res["max_log_prob_diff"] <= ROUTE_TOL,
          "long-T log-probs agree with the einsum route")
    l2 = long_res["encoder_rel_l2"]
    envelope = l2["einsum_route_vs_fp32"]
    check(l2["kernel_route_vs_fp32"] <= ROUTE_ENVELOPE[0] * envelope,
          "long-T encoder output is within the einsum route's bf16 envelope of fp32")
    check(l2["kernel_vs_einsum_route"] <= ROUTE_ENVELOPE[1] * envelope,
          "long-T encoder output agrees with the einsum route within its envelope")

    # windowed full-utterance scoring of the same clips: every clip scored,
    # the last, short batch of the stream included
    n_windows = [len(ev.extract_windows(w, cut)) for _, w in long_clips]
    full = {u: ev.score_full_utterance(model, w, window=cut, batch_size=batch,
                                       device=device)["score"] for u, w in long_clips}
    streamed = list(ev.score_utterances_streamed(model, iter(long_clips), window=cut,
                                                 batch_size=batch, device=device))
    d_stream = max(abs(sc - full[u]) for u, sc in streamed)
    log(f"full utterance: {sum(n_windows)} windows {n_windows} in batches of {batch} (last "
        f"holds {sum(n_windows) % batch}); streamed vs per-clip max_abs {d_stream:.3e}")
    check(sum(n_windows) % batch != 0, "the stream ends on a short batch")
    check([u for u, _ in streamed] == [u for u, _ in long_clips], "every streamed clip scored")
    check(d_stream <= SERVE_TOL, "streamed scores equal per-clip scores")

    def serve_long(wav):
        _, score_fn, _ = build_scorer_from_params(exp, model.state_dict(), batch_size=batch,
                                                  wire_dtype="float32", device=device)
        with BatchingEngine(score_fn, batch, cut=cut, max_wait_ms=500) as engine:
            return engine.score_long(wav)

    served, n_served = serve_long(long_clips[1][1])
    d_long = abs(served - full[long_clips[1][0]])
    log(f"engine score_long of {long_clips[1][0]}: {n_served} windows, vs score_full_utterance "
        f"max_abs {d_long:.3e} (tolerance {SERVE_TOL})")
    check(n_served == n_windows[1] and d_long <= SERVE_TOL,
          "score_long equals score_full_utterance")
    results["long_clip"] = {"launches": long_launches}

    # -- phases 7-9: the flagship's weights on other encoder routes ---------
    encode_topk = (
        lambda f: tk.sae_encode_topk_fused(f, sae.W_enc, sae.b_enc, sae.b_dec, k
                                           ).reshape(2, frames, -1),
        lambda f: tk.sae_encode_topk_fused_plain(f, sae.W_enc, sae.b_enc, sae.b_dec, k
                                                 ).reshape(2, frames, -1))

    def drive_route(label, **enc_changes):
        m = sharing(dataclasses.replace(enc_cfg, **enc_changes))
        return m, drive(label, m, dataclasses.replace(exp, model=m.config), *encode_topk)

    with torch.inference_mode():
        w = dequantize_wire(torch.from_numpy(wire[:batch]).to(device))
        lp_default = model.score(w)
        lp_fp32 = sharing(dataclasses.replace(enc_cfg, flash_long_t=0, dtype=torch.float32,
                                              approx_gelu=True)).score(w)

    def route_envelope(label, m):
        """One batch's log-probs on route ``m`` within the default path's
        bf16 envelope of fp32 (ROUTE_ENVELOPE)."""
        with torch.inference_mode():
            lp = m.score(w)
        res = {key: float((a - b).abs().max()) for key, a, b in (
            ("route_vs_default", lp, lp_default), ("route_vs_fp32", lp, lp_fp32),
            ("default_vs_fp32", lp_default, lp_fp32))}
        log(f"{label} path, one batch of {batch}: log_probs max_abs {json.dumps(res)}")
        results[label]["log_probs_max_abs"] = res
        if not on_card:
            return  # the max over the rehearsal's few tiny log-probs is noise, not an envelope
        check(res["route_vs_fp32"] <= ROUTE_ENVELOPE[0] * res["default_vs_fp32"],
              f"{label} log-probs are within the default path's bf16 envelope of fp32")
        check(res["route_vs_default"] <= ROUTE_ENVELOPE[1] * res["default_vs_fp32"],
              f"{label} log-probs agree with the default path within its envelope")

    log(f"phase 7: fused_attention=True flagship, the flagship's weights, batch {batch}")
    fa_model, results["fused_attention"] = drive_route("fused_attention", fused_attention=True)
    route_envelope("fused_attention", fa_model)

    # -- phase 8: the fused conv front-end ------------------------------------
    log(f"phase 8: fused_frontend=True flagship, the flagship's weights, batch {batch}")
    ff_model, results["fused_frontend"] = drive_route("fused_frontend", fused_frontend=True)
    check(ff_model.encoder.feature_extractor._fused_ok(cut),
          "the fused front-end's gate holds at the flagship's cut")
    route_envelope("fused_frontend", ff_model)
    # one T 5120 unwindowed forward on each front-end route
    rows_, t_bucket = ev.unwindowed_batch(long_clips[2][1], buckets)
    w_long = torch.from_numpy(rows_).to(device)
    ff_long = {"T": t_bucket, "samples": rows_.shape[1]}
    lp_long = {}
    for route, m in (("unfused", model), ("fused", ff_model)):
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with torch.inference_mode():
            lp_long[route] = m.score(w_long)
        sync(torch, device)
        ff_long[route] = {"launches": tf.frontend_tail_fused.launches}
        ff_long[route]["ms_per_forward"] = forward_ms(m, w_long, 3 if on_card else 1)
        if on_card:
            ff_long[route]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    ff_long["log_probs_max_abs"] = float((lp_long["fused"] - lp_long["unfused"]).abs().max())
    log(f"fused front-end, T {t_bucket} forward on both front-end routes: {json.dumps(ff_long)}")
    check(ff_long["log_probs_max_abs"] <= ROUTE_TOL,
          "long-T log-probs agree across the front-end routes")
    if on_card:
        check(ff_long["unfused"]["launches"] == 0 and ff_long["fused"]["launches"] == 1,
              "the long-T forward takes the fused route once, and only when it is set")
        if args.profile:
            fe_ms = {}
            for route, m in (("unfused", model), ("fused", ff_model)):
                def front_end(x, m=m):
                    with torch.inference_mode():
                        return m.encoder.feature_extractor(x)
                prof = profile_step(front_end, w)
                fe_ms[route] = prof["device_ms_per_step"]
                log(json.dumps({"profile": {"path": f"front_end_{route}", **prof}}))
            results["fused_frontend"]["front_end_device_ms"] = fe_ms
    results["fused_frontend"]["long_t"] = ff_long

    # -- phase 9: int8 serving (bench.py's serving config) ---------------------
    log(f"phase 9: int8_serving flagship (scope ffn), the flagship's weights, batch {batch}")
    q_model, results["int8_ffn"] = drive_route("int8_ffn", int8_serving=True, int8_scope="ffn")
    with torch.inference_mode():
        f_q, f_d = q_model.encoder(w).float(), model.encoder(w).float()
        cos = torch.nn.functional.cosine_similarity(f_q.flatten(0, 1), f_d.flatten(0, 1), dim=-1)
        p_q, p_d = torch.exp(q_model.score(w)[:, 1]), torch.exp(lp_default[:, 1])
    q_res = {"min_frame_cosine": float(cos.min()),
             "p_bonafide_max_abs": float((p_q - p_d).abs().max())}
    log(f"int8_ffn path, one batch of {batch} against the default path: {json.dumps(q_res)} "
        f"(bounds: cosine > {INT8_COS_MIN}, P(bonafide) within {INT8_SCORE_TOL})")
    check(q_res["min_frame_cosine"] > INT8_COS_MIN, "int8 encoder output keeps every frame's "
          "direction")
    check(q_res["p_bonafide_max_abs"] <= INT8_SCORE_TOL, "int8 P(bonafide) near the default's")
    results["int8_ffn"]["against_default"] = q_res

    # -- phase 10: sequence-parallel unwindowed scoring -------------------------
    sp_cfg = sp_model_config(cfg)
    sp_enc = sp_cfg.encoder
    backend = dist.choose_backend(device.type, SP_RANKS)
    log(f"phase 10: sequence-parallel scoring of {[u for u, _ in long_clips]} on {SP_RANKS} "
        f"ranks, meshes sp{SP_RANKS} and dp2 x sp2, backend {backend}"
        + (f"; the ranks share {torch.cuda.device_count()} card(s), so their times are of "
           "processes time-sharing it, not of a rank with a card of its own"
           if on_card and backend == "gloo" else ""))
    # the single-process program of the same config: the layout is the
    # only difference (sp_model_config also clears use_pallas)
    base_model = sharing(dataclasses.replace(sp_enc, seq_axis=None), sp_cfg.sae)
    base = list(ev.score_utterances_unwindowed(base_model, iter(long_clips), enc_cfg,
                                               t_targets=long_targets, device=device))
    long_rows = {t: ev.unwindowed_batch(w, buckets)[0] for (_, w), (_, _, t) in
                 zip(long_clips[1:3], base[1:3])}  # one row each at the two long buckets
    jobs = [dict(kind="unwindowed", mesh=0, clips=long_clips, t_targets=long_targets),
            dict(kind="unwindowed", mesh=1, clips=long_clips[3:], t_targets=long_targets),
            dict(kind="encoder", mesh=0, wav=envelope_rows[0])]
    jobs += [dict(kind=sp_time_job, mesh=0, wav=row, iters=3 if on_card else 1)
             for row in long_rows.values()]
    if on_card and args.profile:
        jobs += [dict(kind=sp_profile_job, mesh=0, wav=row, iters=3)
                 for row in long_rows.values()]
    ranks = launch(workers.sp_score_rank,
                   SP_RANKS, ([(sp_cfg, {"seed": args.seed})], device.type,
                              list(SP_MESHES), jobs),
                   device_type=device.type, timeout_s=RANKS_TIMEOUT_S)

    def sp_layers(t_bucket, n_seq):
        """sp_flash_attention_long calls one forward makes: the encoder's gate."""
        takes = (sp_enc.flash_long_t and t_bucket >= sp_enc.flash_long_t
                 and t_bucket % n_seq == 0 and ta.sp_block_q(t_bucket // n_seq))
        return layers if takes else 0

    sp_scores = ranks[0][0]["scores"]
    for utt, score, t_bucket in sp_scores:
        log(f"  {utt}: score {score:.6f}, bucket T {t_bucket}")
    check([(u, t) for u, _, t in sp_scores] == [(u, t) for u, _, t in base],
          "sequence-parallel scores in input order, in the single-process buckets")
    across = max(abs(a[1] - b[1]) for r in ranks for j in (0, 1)
                 for a, b in zip(r[j]["scores"], ranks[0][j]["scores"]))
    d_base = max(abs(a[1] - b[1]) for a, b in zip(sp_scores, base))
    d_long = max(abs(a[1] - b[1]) for a, b in zip(sp_scores, long_out))
    d_mesh = abs(ranks[0][1]["scores"][0][1] - sp_scores[3][1])
    sp_res = {"backend": backend, "ranks": SP_RANKS, "ranks_share_a_card": bool(
        on_card and backend == "gloo"), "max_score_diff": {
            "across_ranks": across, "vs_single_process": d_base,
            "vs_phase_6_kernel_sae": d_long, "dp2xsp2_vs_sp4": d_mesh}}
    check(across <= 1e-6, "every rank gives the same scores")
    check(d_base <= ROUTE_TOL, "sequence-parallel scores agree with the single-process scores")
    check(d_long <= ROUTE_TOL, "sequence-parallel scores agree with phase 6's scores")
    check(d_mesh <= ROUTE_TOL, "the dp2 x sp2 score of the two-row clip agrees with sp4's")
    want_calls = [sum(sp_layers(t, SP_MESHES[0][0]) for _, _, t in base),
                  sp_layers(base[3][2], SP_MESHES[1][0])]
    for r, rank in enumerate(ranks):
        check([rank[j]["sp_calls"] for j in (0, 1)] == want_calls,
              f"rank {r}: sp_flash_attention_long called {want_calls} times over the jobs")
        if not on_card:
            continue
        for j, clips_ in ((0, base), (1, base[3:])):
            for (utt, _, t_bucket), delta in zip(clips_, rank[j]["per_clip"]):
                want = {n: 0 for n in KERNELS}
                want["sp_flash_attention_long"] = sp_layers(t_bucket, SP_MESHES[j][0])
                check(delta == want, f"rank {r}, job {j}, {utt}: launches {delta}, want {want}")
    f_sp = torch.from_numpy(ranks[0][2]["features"]).to(device)
    sp_l2 = {"sp_route_vs_einsum_route": rel_l2(f_sp, envelope_rows[1]),
             "sp_route_vs_fp32": rel_l2(f_sp, envelope_rows[2]),
             "einsum_route_vs_fp32": envelope}
    sp_res["encoder_rel_l2"] = sp_l2
    check(sp_l2["sp_route_vs_fp32"] <= ROUTE_ENVELOPE[0] * envelope,
          "the sequence-parallel encoder output is within the einsum route's envelope of fp32")
    check(sp_l2["sp_route_vs_einsum_route"] <= ROUTE_ENVELOPE[1] * envelope,
          "the sequence-parallel encoder output agrees with the einsum route within its "
          "envelope")
    for job, t_bucket in enumerate(long_rows, start=3):  # the sp_time_job results, in bucket order
        timing = ranks[0][job]
        sp_res[f"T{t_bucket}"] = {
            "forward_ms_by_rank": [r[job]["forward_ms"] for r in ranks],
            "enqueue_ms_by_rank": [r[job]["enqueue_ms"] for r in ranks],
            "gather_ms": timing["gather_ms"], "gather_split_ms": timing["gather_split_ms"],
            "gather_shape": timing["gather_shape"],
            "peak_gib_per_rank": timing["peak_gib"]}
    log(f"sequence parallel: {json.dumps(sp_res)}")
    if on_card and args.profile:
        for job, t_bucket in enumerate(long_rows, start=3 + len(long_rows)):
            for r, rank in enumerate(ranks):
                log(json.dumps({"profile": {"path": f"sequence_parallel_T{t_bucket}", "rank": r,
                                            **rank[job]["profile"]}}))
    del envelope_rows, f_sp
    results["sequence_parallel"] = {"launches": {
        n: sum(ranks[0][j]["launches"][n] for j in (0, 1)) for n in KERNELS}}

    # -- phase 11: a multi-process score file -----------------------------------
    log(f"phase 11: {SCORE_RANKS} ranks score their host_shard of the {n_utts} utterances into "
        f"one score file")
    utt_ids = [f"utt_{i}" for i in range(n_utts)]
    with tempfile.TemporaryDirectory() as tmp:
        out_path = str(Path(tmp) / "scores.txt")
        ranks = launch(workers.produce_scores_rank,
                       SCORE_RANKS, (cfg, {"seed": args.seed}, device.type, wire, utt_ids,
                                     batch, out_path),
                       device_type=device.type, timeout_s=RANKS_TIMEOUT_S)
        ids, merged = read_score_file(out_path)
        left = sorted(q.name for q in Path(tmp).iterdir() if q.name != "scores.txt")
    single = results["flagship"]["scores"]
    d_file = max(abs(sc - single[u]) for u, sc in zip(ids, merged))
    log(f"multi-process score file: {len(ids)} lines from shards of "
        f"{[r['local'] for r in ranks]}; returned counts {[r['count'] for r in ranks]}; merged vs "
        f"single-process max_abs {d_file:.3e} (tolerance {SERVE_TOL}); files left {left}")
    check(sorted(ids) == sorted(utt_ids), "the merged file has every utterance once")
    check(ids == [u for r in range(SCORE_RANKS) for u in utt_ids[r::SCORE_RANKS]],
          "the merged file holds the ranks' shards in rank order")
    check(all(r["count"] == n_utts for r in ranks), "every rank returns the global count")
    check(not left, "no part file is left")
    check(d_file <= SERVE_TOL, "merged scores equal the single-process scores")
    if on_card:
        for r, rank in enumerate(ranks):
            want = {n: 0 for n in KERNELS}
            for n in per_batch["flagship"]:
                want[n] = -(-rank["local"] // batch)
            check(rank["launches"] == want, f"rank {r}: launches {rank['launches']}, want {want}")
    results["multi_process_scores"] = {"launches": ranks[0]["launches"]}

    # -- phase 12: the flagship train step ---------------------------------------
    train_batches = TRAIN_BATCHES if on_card else (2, 3)
    tcfg = exp.train
    log(f"phase 12: flagship train step, {layers} layers, batches {train_batches}, lr {tcfg.lr}, "
        f"weight decay {tcfg.weight_decay}, class weights {tcfg.loss_weights}, SAE weight "
        f"{tcfg.sae_weight}, int16 wire, the flagship's weights")
    del plain_model, fp32_encoder, fa_model, ff_model, q_model, base_model
    if on_card:
        torch.cuda.empty_cache()
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    def restore():
        """The flagship's weights as phase 3 drew them (training moves them
        in place, and every sharing model with them)."""
        with torch.no_grad():
            for n, p_ in model.named_parameters():
                p_.copy_(init[n])

    train_res, first_loss = {}, {}
    train_launches = {n: 0 for n in KERNELS}
    flagship_batch = None
    for b_ in train_batches:
        restore()
        batch_ = train_batch(torch, wavs, b_, args.seed + 7, device)
        state = create_train_state(model, exp)
        step = make_train_step(model, exp, device=device)
        for i in range(TRAIN_WARMUP):
            _, m_ = step(state, *batch_, args.seed)
            if i == 0:
                first_loss[b_] = float(m_["loss"])
        if on_card:
            resident = torch.cuda.memory_allocated()  # weights, moments, what earlier phases keep
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = time_train_steps(torch, step, state, batch_, args.seed, device,
                               TRAIN_TIMED if on_card else 1)
        launches = counts()
        n_steps = len(res["losses"]) + 1
        if on_card:
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            res["resident_gib"] = resident / 2**30
            want_only(f"train step at batch {b_}", launches,
                      {"sae_encode_topk_fused": n_steps, "sae_decode_fused": n_steps})
        res["launches_per_step"] = {n: c / n_steps for n, c in launches.items() if c}
        check(all(math.isfinite(x) for x in res["losses"]), "every train loss is finite")
        check(int(state.step) == TRAIN_WARMUP + n_steps, "every train step committed")
        train_launches = {n: train_launches[n] + launches[n] for n in KERNELS}
        log(f"train step, batch {b_}: {json.dumps(res)}")
        if on_card and args.profile:
            einsum_pos = sharing(dataclasses.replace(enc_cfg, grouped_conv_einsum=True))
            prof = profile_train_step(torch, tk, model, einsum_pos.encoder.pos_conv, state,
                                      step, batch_, exp.train, args.seed, frames, device)
            del einsum_pos
            log(json.dumps({"profile": {"path": f"train_step_batch_{b_}", **prof}}))
            res["profile"] = {key: val for key, val in prof.items() if key != "top"}
        train_res[f"batch_{b_}"] = res
        if b_ == train_batches[0]:
            flagship_batch, flagship_state, flagship_step = batch_, state, step
        else:
            del state, step
    results["train_flagship"] = {"launches": train_launches}

    # (c) one step's gradients through the kernels, through their plain
    # versions, and through the fp32 SAE route, from the same weights
    restore()
    loss_k, codes_k, g_k = grads_of(torch, model, tcfg, flagship_batch, args.seed, device)
    with plain_sae_kernels(tk):
        zero_counts()
        loss_p, codes_p, g_p = grads_of(torch, model, tcfg, flagship_batch, args.seed, device)
        check(all(c == 0 for c in counts().values()), "the plain step launches no kernel")
    fp32_sae = sharing(enc_cfg, dataclasses.replace(sae_cfg, use_pallas=False))
    loss_t, _, g_t = grads_of(torch, fp32_sae, tcfg, flagship_batch, args.seed, device)
    del fp32_sae

    def over(err, envelope):
        return err / envelope if envelope else (0.0 if err == 0 else math.inf)

    ratios = {}
    for n in g_p:
        e_pt = rel_l2(g_p[n], g_t[n])
        ratios[n] = (over(rel_l2(g_k[n], g_t[n]), e_pt), over(rel_l2(g_k[n], g_p[n]), e_pt), e_pt)
    rows_differ = int(((codes_k > 0) != (codes_p > 0)).reshape(-1, codes_k.shape[-1])
                      .any(-1).sum())
    worst_t = max(ratios, key=lambda n: ratios[n][0])
    worst_p = max(ratios, key=lambda n: ratios[n][1])
    kp = {"loss_kernels": loss_k, "loss_plain": loss_p, "loss_fp32_sae": loss_t,
          "loss_abs_diff": abs(loss_k - loss_p), "support_rows_differ": rows_differ,
          "rows": int(codes_k.numel() // codes_k.shape[-1]), "tensors": len(ratios),
          "worst_vs_fp32_over_envelope": [worst_t, ratios[worst_t][0]],
          "worst_vs_plain_over_envelope": [worst_p, ratios[worst_p][1]],
          "median_envelope_rel_l2": float(np.median([r[2] for r in ratios.values()]))}
    log(f"train step, kernels vs plain versions at batch {train_batches[0]}: {json.dumps(kp)}")
    del g_k, g_p, g_t
    check(kp["loss_abs_diff"] <= E2E_TOL,
          "the train loss through the kernels agrees with the plain versions'")
    check(all(r[0] <= TRAIN_ENVELOPE[0] for r in ratios.values()),
          "every gradient of the kernel step is within the SAE rounding's envelope of the fp32 "
          "route")
    check(all(r[1] <= TRAIN_ENVELOPE[1] for r in ratios.values()),
          "every gradient of the kernel step agrees with the plain step within the envelope")
    train_res["kernels_vs_plain"] = kp

    # (d) remat at the larger batch, from the weights (a) started from
    restore()
    remat_model = sharing(dataclasses.replace(enc_cfg, remat=True))
    state = create_train_state(remat_model, exp)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    _, m_ = make_train_step(remat_model, exp, device=device)(
        state, *train_batch(torch, wavs, train_batches[-1], args.seed + 7, device), args.seed)
    remat = {"loss": float(m_["loss"]), "loss_without_remat": first_loss[train_batches[-1]]}
    if on_card:
        remat["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        remat["peak_gib_without_remat"] = train_res[f"batch_{train_batches[-1]}"]["peak_gib"]
    log(f"train step with remat at batch {train_batches[-1]}: {json.dumps(remat)}")
    check(math.isclose(remat["loss"], remat["loss_without_remat"], rel_tol=REMAT_LOSS_REL),
          "remat gives the loss of the step without it")
    train_res["remat"] = remat
    del state, remat_model

    # (g) remat at the encoder's dropout 0.1: the backward replays each
    # layer's forward, which must draw the same masks; the step without
    # remat run twice gives its own run-to-run difference
    restore()
    drop = dict(dropout=REMAT_DROPOUT, attention_dropout=REMAT_DROPOUT,
                activation_dropout=REMAT_DROPOUT)
    no_remat_d = sharing(dataclasses.replace(enc_cfg, **drop))
    remat_d = sharing(dataclasses.replace(enc_cfg, remat=True, **drop))
    loss_n, _, g_n = grads_of(torch, no_remat_d, tcfg, flagship_batch, args.seed, device)
    loss_n2, _, g_n2 = grads_of(torch, no_remat_d, tcfg, flagship_batch, args.seed, device)
    loss_r, _, g_r = grads_of(torch, remat_d, tcfg, flagship_batch, args.seed, device)
    loss_0, _, _ = grads_of(torch, model, tcfg, flagship_batch, args.seed, device)
    errs = {n: (rel_l2(g_r[n], g_n[n]), rel_l2(g_n2[n], g_n[n])) for n in g_n}
    worst = max(errs, key=lambda n: errs[n][0] / max(REMAT_GRAD_REL, 2 * errs[n][1]))
    remat_drop = {"dropout": REMAT_DROPOUT, "loss": loss_r, "loss_without_remat": loss_n,
                  "loss_run_to_run": abs(loss_n2 - loss_n), "loss_at_dropout_0": loss_0,
                  "worst_grad": [worst, *errs[worst]],
                  "grads_bit_equal": sum(torch.equal(g_r[n], g_n[n]) for n in g_n),
                  "tensors": len(g_n)}
    log(f"train step with remat at encoder dropout {REMAT_DROPOUT}, batch {train_batches[0]}: "
        f"{json.dumps(remat_drop)} (worst: rel L2 against the step without remat, and that "
        f"step's own run to run)")
    del g_n, g_n2, g_r, no_remat_d, remat_d
    check(loss_r != loss_0, "dropout 0.1 changes the loss (the masks are live)")
    check(math.isclose(loss_r, loss_n, rel_tol=REMAT_LOSS_REL),
          "remat with dropout gives the loss of the step without it")
    check(all(e <= max(REMAT_GRAD_REL, 2 * noise) for e, noise in errs.values()),
          "remat with dropout gives the gradients of the step without it")
    train_res["remat_dropout"] = remat_drop

    # (e) one batch fitted at a larger learning rate: the loss falls
    restore()
    fit_exp = dataclasses.replace(exp, train=dataclasses.replace(tcfg, lr=FIT_LR))
    state = create_train_state(model, fit_exp)
    fit_step = make_train_step(model, fit_exp, device=device)
    fit = [float(fit_step(state, *flagship_batch, args.seed)[1]["loss"])
           for _ in range(FIT_STEPS)]
    log(f"train step, one batch fitted at lr {FIT_LR} over {FIT_STEPS} steps: losses {fit}")
    check(all(math.isfinite(x) for x in fit), "the fitted loss is finite at every step")
    check(fit[-1] < fit[0], "the fitted loss falls")
    train_res["fit"] = {"lr": FIT_LR, "losses": fit}
    del state, fit_step

    # (f) a batch holding a NaN sample leaves the state as it was
    wav_nan = dequantize_wire(flagship_batch[0]).clone()
    wav_nan[1, 1000] = float("nan")
    before = ({n: p_.detach().clone() for n, p_ in model.named_parameters()},
              flagship_state.exp_avg.clone(), flagship_state.exp_avg_sq.clone(),
              flagship_state.step.clone())
    _, m_ = flagship_step(flagship_state, wav_nan, *flagship_batch[1:], args.seed)
    finite = bool(m_["finite"])
    def bits(t):
        return t.detach().view(torch.int32)

    same = (all(torch.equal(bits(p_), bits(before[0][n])) for n, p_ in model.named_parameters())
            and torch.equal(bits(flagship_state.exp_avg), bits(before[1]))
            and torch.equal(bits(flagship_state.exp_avg_sq), bits(before[2]))
            and torch.equal(flagship_state.step, before[3]))
    log(f"train step on a batch with a NaN sample: finite {finite}, loss {float(m_['loss'])}, "
        f"state bit-equal {same} (after {int(before[3])} committed steps)")
    check(not finite and same, "the non-finite guard keeps the state bit for bit")
    train_res["nan_guard"] = {"finite": finite, "state_bit_equal": same}
    del before, wav_nan

    del flagship_state, flagship_step

    # -- phase 13: the window-overlap train step ---------------------------------
    restore()
    log(f"phase 13: window-overlap train step (window {WINDOW}), the flagship's weights, batch "
        f"{train_batches[0]}")
    win_train = sharing(enc_cfg, win_cfg.sae)
    win_exp = dataclasses.replace(exp, model=win_train.config)
    state = create_train_state(win_train, win_exp)
    step = make_train_step(win_train, win_exp, device=device)
    step(state, *flagship_batch, args.seed)
    zero_counts()
    res = time_train_steps(torch, step, state, flagship_batch, args.seed, device,
                           WINDOW_TRAIN_STEPS)
    launches = counts()
    n_steps = len(res["losses"]) + 1
    if on_card:
        want_only("window-overlap train step", launches,
                  {"sae_encode_fused": n_steps, "window_vote_fused": n_steps,
                   "sae_decode_fused": n_steps})
    check(all(math.isfinite(x) for x in res["losses"]), "every window-overlap train loss is finite")
    res["launches_per_step"] = {n: c / n_steps for n, c in launches.items() if c}
    log(f"window-overlap train step, batch {train_batches[0]}: {json.dumps(res)}")
    train_res["window_overlap"] = res
    results["train_window_overlap"] = {"launches": launches}
    del state, step, win_train

    # -- phase 14: the Trainer ------------------------------------------------------
    restore()
    t_phase = time.perf_counter()
    t_batch, n_train, n_val, n_timed = TRAINER_SIZES[device.type]
    t_exp = dataclasses.replace(exp, train=dataclasses.replace(exp.train, batch_size=t_batch))
    rcfg = t_exp.train.rawboost
    log(f"phase 14: the Trainer, {layers} layers, batch {t_batch}, lr {t_exp.train.lr}, "
        f"weight decay {t_exp.train.weight_decay}, class weights {t_exp.train.loss_weights}, "
        f"SAE weight {t_exp.train.sae_weight}, RawBoost algorithm {rcfg.algo}; {n_train} train "
        f"(shuffled), {n_val} val utterances on the int16 wire, the flagship's weights")
    trainer_res = {}

    # (a) RawBoost on a batch of the train shape
    x = torch.from_numpy(synthetic_wavs(t_batch, cut, args.seed + 11)).to(device)
    trainer_res["rawboost"] = phase_rawboost(torch, rb, rcfg, x, device, 10 if on_card else 1)
    log(f"RawBoost at [{t_batch}, {cut}]: {json.dumps(trainer_res['rawboost'])}")
    del x

    def utterances(n, seed):
        labels = np.random.default_rng(seed).permutation(np.arange(n) % 2)  # both classes
        return to_wire(synthetic_wavs(n, cut, seed), "int16"), labels

    train_loader = ArrayLoader(*utterances(n_train, args.seed + 12), batch_size=t_batch,
                               shuffle=True, seed=args.seed)
    val_loader = ArrayLoader(*utterances(n_val, args.seed + 13), batch_size=t_batch)
    timed_loader = ArrayLoader(*utterances(n_timed, args.seed + 14), batch_size=t_batch,
                               shuffle=True, seed=args.seed)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        ckpt_bytes = 4 * (sum(t.numel() for t in model.state_dict().values())
                          + 2 * sum(p.numel() for p in model.parameters()))
        free = shutil.disk_usage(work).free
        trainer_res["disk"] = {"dir": str(work), "free_gb": free / 1e9,
                               "checkpoint_gb_estimate": ckpt_bytes / 1e9}
        log(f"trainer run directories in {work}: {free / 1e9:.1f} GB free, a checkpoint "
            f"~{ckpt_bytes / 1e9:.2f} GB")
        check(free >= CKPT_FILES_FREE * ckpt_bytes,
              f"{work} must hold {CKPT_FILES_FREE} checkpoints of ~{ckpt_bytes / 1e9:.2f} GB "
              f"({CKPT_FILES_FREE * ckpt_bytes / 1e9:.1f} GB) and has {free / 1e9:.1f} GB free: "
              "point TMPDIR at a larger disk")

        # (b) Trainer A fits epoch 0 from the flagship's weights
        a = Trainer(t_exp, work / "a", tensorboard=False, device=device)
        a.model.load_state_dict(model.state_dict(), strict=True)
        a.init_state()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        a.fit(train_loader, val_loader, num_epochs=1)
        fit_s = time.perf_counter() - t0
        launches = counts()
        results["trainer"] = {"launches": launches}
        fit_steps, val_batches = train_loader.num_batches(), val_loader.num_batches()
        if on_card:
            want_only("Trainer.fit, one epoch", launches,
                      {"sae_encode_topk_fused": fit_steps + val_batches,
                       "sae_decode_fused": fit_steps + val_batches})
        rows_a = csv_rows(work / "a")
        check(len(rows_a) == 1 and rows_a[0]["epoch"] == "0", "one CSV row for epoch 0")
        check(all(math.isfinite(float(rows_a[0][k])) for k in ("train_loss", "train_cls_loss",
                                                                "train_sae_loss", "val_loss",
                                                                "val_sae_loss")),
              "the epoch's losses are finite")
        check(a.ckpt.last_path.exists() and a.ckpt.best_path.exists(),
              "epoch 0 wrote last.ckpt and best.ckpt")
        save = dict(a.ckpt.last_save)
        fit = {"seconds": fit_s, "epoch_seconds_csv": float(rows_a[0]["epoch_seconds"]),
               "row": rows_a[0], "save": save, "save_gb": save["bytes"] / 1e9,
               "free_gb_after": shutil.disk_usage(work).free / 1e9,
               "launches_per_batch": {n: c / (fit_steps + val_batches)
                                      for n, c in launches.items() if c}}
        if on_card:
            fit["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"Trainer.fit, epoch 0: {json.dumps(fit)}")
        trainer_res["fit"] = fit

        # (c) Trainer B, fresh with other weights, resumes from A's last.ckpt,
        # and so does F with a planted fault: its calls are not restored
        b = Trainer(t_exp, work / "b", tensorboard=False, device=device)
        b.init_state()
        check(not all(torch.equal(p_, q_) for p_, q_ in zip(a.model.parameters(),
                                                            b.model.parameters())),
              "trainer B starts from other weights")
        t0 = time.perf_counter()
        check(b.resume(a.ckpt.last_path) and b.start_epoch == 1, "B resumes at epoch 1")
        resume_s = time.perf_counter() - t0
        check(b.state.calls == a.state.calls and int(b.state.step) == int(a.state.step),
              "B has A's step and calls")
        check(trainer_bits_equal(torch, a, b), "B has every parameter and moment of A, bit for bit")
        faulty = Trainer(t_exp, work / "fault", tensorboard=False, device=device)
        faulty.init_state()
        faulty.resume(a.ckpt.last_path)
        faulty.state.calls = 0  # the fault: the classifier's dropout masks of epoch 0 again
        # epoch 1 under deterministic algorithms: A goes on in memory, B from the file
        a.start_epoch = 1
        with deterministic_algorithms(torch) as nondeterministic:
            t0 = time.perf_counter()
            a.fit(train_loader, val_loader, num_epochs=2)
            det_fit_s = time.perf_counter() - t0
            b.fit(train_loader, val_loader, num_epochs=2)
            row_f = epoch_row(1, faulty.train_epoch(train_loader, 1),
                              faulty.validate(val_loader), 0.0)
        row_a, row_b = csv_rows(work / "a")[-1], csv_rows(work / "b")[-1]
        resume = {"resume_seconds": resume_s, "step": int(b.state.step), "calls": b.state.calls,
                  "deterministic_fit_seconds": det_fit_s,
                  "nondeterministic_ops_warned": nondeterministic,
                  "a_b_bit_equal": trainer_bits_equal(torch, a, b),
                  "a_b_max_abs": trainer_diff(torch, a, b),
                  "a_b_row_max_abs": row_diff(row_a, row_b),
                  "fault": "calls not restored",
                  "fault_max_abs": trainer_diff(torch, a, faulty),
                  "fault_row_max_abs": row_diff(row_a, row_f),
                  "row_a": row_a, "row_b": row_b, "row_fault": row_f}
        log(f"resume, epoch 1 under deterministic algorithms: A (in memory) against B (from "
            f"A's last.ckpt) and against a run resumed with calls not restored: "
            f"{json.dumps(resume)}")
        check(resume["a_b_bit_equal"] and resume["a_b_row_max_abs"] == 0,
              "B's epoch 1 equals A's bit for bit: every parameter, moment and CSV field")
        check(resume["fault_max_abs"] > 0,
              "a resume that drops calls differs from A (the check sees a resume fault)")
        trainer_res["resume"] = resume
        del b, faulty

        # (d) throughput of the epoch loop and of validation, and its host syncs
        a.train_epoch(timed_loader, 2)  # this set's shapes seen once
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            epoch_s, sync_sites, wait_sites = epoch_with_sync_count(torch, a, timed_loader, 3)
            loop_syncs = len(sync_sites)
        else:
            t0 = time.perf_counter()
            a.train_epoch(timed_loader, 3)
            epoch_s, loop_syncs, sync_sites, wait_sites = time.perf_counter() - t0, None, [], []
        sync(torch, device)
        t0 = time.perf_counter()
        a.validate(timed_loader)
        val_s = time.perf_counter() - t0
        thr = {"train_epoch_utts_per_s": n_timed / epoch_s, "train_epoch_seconds": epoch_s,
               "steps": timed_loader.num_batches(),
               "step_alone_utts_per_s": train_res.get(f"batch_{t_batch}", {}).get("utts_per_s"),
               "validate_utts_per_s": n_timed / val_s, "loop_host_syncs": loop_syncs,
               "loop_sync_sites": sorted(set(sync_sites)),
               "bounding_waits_counted": len(wait_sites),
               "bounding_wait_sites": sorted(set(wait_sites))}
        if on_card:
            thr["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"Trainer throughput over {n_timed} utterances: {json.dumps(thr)}")
        if on_card:
            check(loop_syncs == 0, "the epoch loop makes no host sync outside its bounding waits")
            want_waits = sum(1 for i in range(timed_loader.num_batches())
                             if i >= PIPELINE_DEPTH and i % PIPELINE_DEPTH == 0)
            check(len(wait_sites) == want_waits,
                  f"the epoch loop waits {want_waits} time(s) for the step {PIPELINE_DEPTH} "
                  f"behind, counted {len(wait_sites)}")
        trainer_res["throughput"] = thr

        # (e) Trainer.produce_scores against the eval step on the same batches
        with tempfile.TemporaryDirectory() as tmp:
            written = a.produce_scores(val_loader, Path(tmp) / "scores.txt")
            _, scores_t = read_score_file(Path(tmp) / "scores.txt")
        eval_step = make_eval_step(a.model, device=device)
        want = np.concatenate([log_probs_to_scores(eval_step(bt.wav)["log_probs"])[bt.valid]
                               for bt in val_loader.epoch(0)])
        scores_err = float(np.abs(scores_t - want).max())
        check(written == n_val and scores_err <= SCORES_TOL,
              f"Trainer.produce_scores equals the eval step's scores within {SCORES_TOL}")
        trainer_res["scores_max_abs_vs_eval_step"] = scores_err
        del a
    finally:
        shutil.rmtree(work, ignore_errors=True)
    trainer_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 in {trainer_res['phase_seconds']:.1f} s; produce_scores against the eval "
        f"step: max abs {scores_err:.3e}")

    # -- phase 15: offline evaluation from files on disk ------------------------------
    restore()
    t_phase = time.perf_counter()
    log(f"phase 15: offline evaluation from files on disk, {layers} layers, batch {batch}, "
        "int16 wire, the flagship's weights written in the reference's namings and read back")
    offline_res = phase_offline(torch, device, exp, model, batch, args.seed, counts, zero_counts,
                                want_only, results["flagship"]["eval_utts_per_s"])
    results["offline"] = {"launches": offline_res["scoring"]["launches"]}
    offline_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 15 in {offline_res['phase_seconds']:.1f} s")

    # -- phase 16: the SLS family ------------------------------------------------------
    restore()
    t_phase = time.perf_counter()
    log(f"phase 16: the SLS family (XLS-R + SLS head), {layers} layers, {enc_cfg.dtype}, "
        f"seeded weights, int16 wire; eval at batch {batch}, train at {train_batches}")
    sls_res = phase_sls(torch, device, enc_cfg, cut, batch, wire, wavs, args.seed, counts,
                        zero_counts, want_only, results["flagship"]["eval_utts_per_s"],
                        train_batches)
    results["sls"] = {"launches": sls_res["launches"]}
    sls_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 in {sls_res['phase_seconds']:.1f} s")

    # -- phase 17: the CPC variant -----------------------------------------------------
    restore()
    t_phase = time.perf_counter()
    log(f"phase 17: the CPC variant (window_hard, window {WINDOW}, CPC steps {CPC_STEPS}, "
        f"cpc_weight 0.5), the flagship's weights, batch {train_batches[0]}")
    cpc_res = phase_cpc(torch, tk, device, model, sae_cfg, flagship_batch, wire, batch,
                        args.seed, counts, zero_counts, want_only,
                        train_res["window_overlap"]["utts_per_s"])
    results["train_cpc"] = {"launches": cpc_res["launches"]}
    results["cpc_eval"] = {"launches": cpc_res["eval"]["launches"]}
    cpc_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 in {cpc_res['phase_seconds']:.1f} s")

    # -- phase 18: the entry points ----------------------------------------------------
    restore()
    if on_card:
        torch.cuda.empty_cache()  # the CLIs' processes and ranks share the card
    t_phase = time.perf_counter()
    log(f"phase 18: the entry points (cli.main eval, long clips, --seq_parallel {SP_RANKS}, "
        f"training; cli.export; cli.serve) on the flagship's weights, batch {batch}")
    cli_res = phase_cli(torch, device, model, exp, batch, args.seed, counts, zero_counts,
                        want_only, offline_res["speed"]["produce_scores_utts_per_s"],
                        results["flagship"]["score_utts_per_s"])
    for label, launched in cli_res.pop("launches").items():
        results[label] = {"launches": launched}
    cli_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 in {cli_res['phase_seconds']:.1f} s")

    # -- phase 19: training across ranks, serving over several devices --------------------
    restore()
    if on_card:
        torch.cuda.empty_cache()  # the ranks share the card
    t_phase = time.perf_counter()
    par_res, par_launches = phase_parallel(
        torch, tk, device, model, exp, wavs, batch, args.seed, counts, zero_counts, want_only,
        results["flagship"]["score_utts_per_s"])
    for label, launched in par_launches.items():
        results[label] = {"launches": launched}
    par_res["phase_seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 in {par_res['phase_seconds']:.1f} s")

    for row in rows:
        by_path = {label: res["launches"][row["name"]] for label, res in results.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path

    log(f"total {time.perf_counter() - t_start:.1f} s")
    if not on_card:
        log("rehearsal passed (CPU, plain versions): not a device result")
        return 0
    kernels = [{key: row[key] for key in (
        "name", "route", "source", "replaces", "launches", "launches_by_path", "max_abs_err",
        "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tolerance",
        "elements_beyond_one_bf16_ulp", "form", "device_ms", "library_device_ms",
        "exp_floor_ms", "emulation_max_abs_err",
        "elements_beyond_one_bf16_ulp_vs_emulation", "cases", "unfused_route_ms", "rel_l2_vs_plain",
        "envelope_rel_l2", "strips_vs_whole_max_abs", "strips_bit_equal", "rel_l2_vs_fp64",
        "plain_rel_l2_vs_fp64", "fp64_ratio_worst_small_n", "split_ms", "cast_ms", "gemm_ms",
        "select_ms", "ln0_ms", "streamed_form",
        "ln0_channels_first_ms", "parent_ms",
        "parent_alternation_ms") if key in row}
        for row in rows]
    batch_paths = [label for label in results if "eval_utts_per_s" in results[label]]
    print(json.dumps({"run": {"card": card.replace("\n", "; "), "batch": batch, "layers": layers,
                              "paths": {label: {key: results[label][key] for key in (
                                  "eval_utts_per_s", "score_utts_per_s", "peak_gib",
                                  "log_probs_max_abs", "long_t", "front_end_device_ms",
                                  "against_default") if key in results[label]}
                                  for label in batch_paths},
                              "long_clip": long_res, "sequence_parallel": sp_res,
                              "train": train_res, "trainer": trainer_res,
                              "offline": offline_res, "sls": sls_res, "cpc": cpc_res,
                              "cli": cli_res, "parallel": par_res}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
