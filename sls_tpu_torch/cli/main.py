"""Train / eval CLI, counterpart of ``sls_tpu/cli/main.py``.

The reference's argparse surface, flag for flag as the JAX package keeps
it (``build_parser``; ``config_from_args`` gives the JAX function's
config), run on the port:

    python -m sls_tpu_torch.cli.main --database_path DATA --protocols_path PROTO \
        --pallas_sae --cp_path xlsr2_300m.pt                          # train
    python -m sls_tpu_torch.cli.main ... --is_eval --track DF \
        --model_path models/<tag>/best.ckpt [--full_utterance [--unwindowed]]

Runs go to ``<model_dir>/<ExperimentConfig.model_tag()>/``, the JAX
package's directory for the same flags, with ``training_log.csv`` and
``last.ckpt`` / ``best.ckpt`` (``train/loop.py``); ``--is_eval`` writes
``scores/scores_<track>.txt`` by default.  ``--pallas_sae`` sets
``use_pallas``: the hand-written CUDA kernels.

Everything runs on the card; ``SLS_TPU_PLATFORM=cpu`` (the variable the
JAX CLI honours) asks for the CPU, and without a card and without it the
run raises.  ``--seq_parallel N`` runs a process a rank: inside an
N-rank job (torchrun, ``parallel/distributed.initialize``) its ranks,
else N ranks spawned on this host (``parallel/launch.py``), which share
its cards.

Training across ranks: inside a job (torchrun, or the
``SLS_TPU_COORDINATOR`` / ``SLS_TPU_NUM_PROCESSES`` /
``SLS_TPU_PROCESS_ID`` variables of ``parallel/distributed.initialize``)
every rank runs this command and the trainer trains data parallel
(``train/loop.py``), each rank on its shard of the train and dev lists;
no flag asks for it, as in the JAX CLI.  ``--model_parallel M`` trains
tensor parallel over M ranks of one host (``parallel/tensor.py``):
inside a job whose ranks M divides, those ranks; else M ranks spawned on
this host, as ``--seq_parallel`` spawns them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from sls_tpu_torch.config import (
    CPCConfig,
    ExperimentConfig,
    ModelConfig,
    RawBoostConfig,
    SAEConfig,
    TrainConfig,
    XLSRConfig,
    tiny_xlsr_config,
)
from sls_tpu_torch.device import resolve_device
from sls_tpu_torch.parallel import distributed as dist

PLATFORM_ENV = "SLS_TPU_PLATFORM"
TRAIN_JOB_TIMEOUT_S = 7 * 86400.0  # a spawned --model_parallel job, and its collectives


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="sls_tpu_torch anti-spoofing train/eval")
    # datasets (reference: main.py:404-418)
    p.add_argument("--database_path", type=str, default="./data/",
                   help="root with ASVspoof2019/2021 audio dirs")
    p.add_argument("--protocols_path", type=str, default="./database/",
                   help="root with CM protocol files")
    p.add_argument("--track", type=str, default="LA",
                   choices=["LA", "DF", "In-the-Wild", "2019LA"])
    p.add_argument("--model_type", type=str, default="sae",
                   choices=["sae", "sls"],
                   help="sae = TopK-SAE detector; sls = upstream XLS-R+SLS "
                        "parity model")
    p.add_argument("--audio_ext", type=str, default="flac")
    # hyperparameters (reference: main.py:419-424)
    p.add_argument("--batch_size", type=int, default=14)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    # encoder
    p.add_argument("--cp_path", type=str, default=None,
                   help="pretrained XLS-R checkpoint (fairseq .pt, HF "
                   "export, or .npz); when omitted, ./xlsr2_300m.pt is "
                   "auto-used if present (reference default name). An "
                   "explicitly given path that doesn't exist is an error")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no_bf16", dest="bf16", action="store_false")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize transformer layers (memory for FLOPs)")
    p.add_argument("--pallas_sae", action="store_true",
                   help="the hand-written CUDA SAE kernels (encode + top-k, "
                   "encode, window vote, decode)")
    p.add_argument("--int8", action="store_true",
                   help="int8 dynamic-quantized serving (eval paths only; "
                   "same checkpoints; training stays bf16/fp32).  Default "
                   "scope quantizes the FFN GEMMs only")
    p.add_argument("--int8_scope", choices=["ffn", "all"], default="ffn",
                   help="which matmuls go int8: 'ffn' (fc1/fc2) or 'all' "
                   "(+QKVO)")
    wire = p.add_mutually_exclusive_group()
    wire.add_argument("--wire_int16", action="store_true",
                      help="upload waveforms as int16 (half the "
                      "host->device bytes; device dequantizes in-step — "
                      "lossless for 16-bit sources like all ASVspoof FLAC)")
    wire.add_argument("--wire_mulaw", action="store_true",
                      help="upload waveforms as 8-bit mu-law (quarter the "
                      "float32 bytes; LOSSY — opt-in for "
                      "wire-bandwidth-bound serving)")
    # SAE (reference: main.py:430-441)
    p.add_argument("--use_sae", action="store_true", default=True)
    p.add_argument("--no_sae", dest="use_sae", action="store_false")
    p.add_argument("--use_sparse_features", action="store_true", default=True)
    p.add_argument("--use_reconstructed_features", dest="use_sparse_features",
                   action="store_false")
    p.add_argument("--sae_dict_size", type=int, default=4096)
    p.add_argument("--sae_k", type=int, default=128)
    p.add_argument("--sae_weight", type=float, default=0.1)
    p.add_argument("--use_window_topk", action="store_true")
    p.add_argument("--overlap_windows", action="store_true",
                   help="50%%-overlap vote windows (else hard windows)")
    p.add_argument("--sae_window_size", type=int, default=8)
    # CPC (reference: train_cpc.py:442-452)
    p.add_argument("--use_cpc", action="store_true")
    p.add_argument("--cpc_weight", type=float, default=0.5)
    p.add_argument("--cpc_hidden_dim", type=int, default=256)
    p.add_argument("--cpc_prediction_steps", type=int, nargs="+",
                   default=[1, 2, 4])
    # runtime (reference: main.py:425-429)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--comment", type=str, default=None)
    p.add_argument("--quick_test", action="store_true",
                   help="truncate loops to 5 batches")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of N early steps "
                   "into <run dir>/profile (cli/profile_diff reads it)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel degree over the ranks of one host "
                   "(parallel/tensor.py): the ranks of a job, else spawned "
                   "on this host; 1 = off")
    # checkpointing (reference: main.py:420-423,462-464)
    p.add_argument("--model_dir", type=str, default="models")
    p.add_argument("--model_path", type=str, default=None,
                   help="explicit checkpoint to load")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--fresh_start", action="store_true")
    # eval (reference: main.py:426-428)
    p.add_argument("--is_eval", action="store_true")
    p.add_argument("--eval_output", type=str, default=None)
    p.add_argument("--full_utterance", action="store_true",
                   help="score variable-length audio with overlapping "
                        "windows instead of the fixed 64,600-sample crop")
    p.add_argument("--unwindowed", action="store_true",
                   help="with --full_utterance: one forward per clip "
                        "with the WHOLE waveform in attention context "
                        "(length-bucketed; long clips use the long-T "
                        "attention kernel)")
    p.add_argument("--seq_parallel", type=int, default=1,
                   help="with --full_utterance --unwindowed: shard each "
                        "clip's frame axis over this many ranks "
                        "(sequence parallelism, parallel/sequence.py): "
                        "the ranks of a torchrun job, else spawned on "
                        "this host; 1 = off")
    # RawBoost (reference: main.py:443-459)
    p.add_argument("--algo", type=int, default=3)
    p.add_argument("--nBands", type=int, default=5)
    p.add_argument("--minF", type=int, default=20)
    p.add_argument("--maxF", type=int, default=8000)
    p.add_argument("--minBW", type=int, default=100)
    p.add_argument("--maxBW", type=int, default=1000)
    p.add_argument("--minCoeff", type=int, default=10)
    p.add_argument("--maxCoeff", type=int, default=100)
    p.add_argument("--minG", type=int, default=0)
    p.add_argument("--maxG", type=int, default=0)
    p.add_argument("--minBiasLinNonLin", type=int, default=5)
    p.add_argument("--maxBiasLinNonLin", type=int, default=20)
    p.add_argument("--N_f", type=int, default=5)
    p.add_argument("--P", type=int, default=10)
    p.add_argument("--g_sd", type=int, default=2)
    p.add_argument("--SNRmin", type=int, default=10)
    p.add_argument("--SNRmax", type=int, default=40)
    # testing escape hatch: tiny encoder + short crops (CI-scale e2e)
    p.add_argument("--tiny", action="store_true", help=argparse.SUPPRESS)
    return p


def config_from_args(args) -> ExperimentConfig:
    """The experiment config of parsed arguments: the JAX function's
    config field for field (``config_to_json`` of both agree)."""
    if args.use_window_topk:
        variant = "window_overlap" if args.overlap_windows else "window_hard"
    elif args.use_cpc:
        variant = "window_hard"  # the CPC model uses hard windows (model_cpc.py)
    else:
        variant = "per_timestep"

    # int8 is a serving config: honoured only under --is_eval, so that a
    # training run's validation (and its best-checkpoint choice) stays
    # exact-precision
    int8 = getattr(args, "int8", False) and getattr(args, "is_eval", False)
    if getattr(args, "int8", False) and not int8:
        print("NOTE: --int8 is serving-only; ignored for this training "
              "run (validation stays exact-precision). Pass it with "
              "--is_eval to serve quantized.")
    if getattr(args, "tiny", False):
        encoder = tiny_xlsr_config(int8_serving=int8,
                                   int8_scope=getattr(args, "int8_scope", "ffn"))
        act_dim = encoder.embed_dim
    else:
        encoder = XLSRConfig(dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             remat=args.remat, int8_serving=int8,
                             int8_scope=getattr(args, "int8_scope", "ffn"))
        act_dim = 1024

    use_sae = args.use_sae and getattr(args, "model_type", "sae") != "sls"
    model = ModelConfig(
        encoder=encoder,
        use_sae=use_sae,
        use_sparse_features=args.use_sparse_features,
        sae=SAEConfig(activation_dim=act_dim, dict_size=args.sae_dict_size, k=args.sae_k,
                      variant=variant, window_size=args.sae_window_size,
                      use_pallas=args.pallas_sae),
        use_cpc=args.use_cpc,
        cpc=CPCConfig(hidden_dim=args.cpc_hidden_dim,
                      prediction_steps=tuple(args.cpc_prediction_steps)),
    )
    rawboost = RawBoostConfig(
        algo=args.algo, nBands=args.nBands, minF=args.minF, maxF=args.maxF,
        minBW=args.minBW, maxBW=args.maxBW, minCoeff=args.minCoeff,
        maxCoeff=args.maxCoeff, minG=args.minG, maxG=args.maxG,
        minBiasLinNonLin=args.minBiasLinNonLin,
        maxBiasLinNonLin=args.maxBiasLinNonLin, N_f=args.N_f, P=args.P,
        g_sd=args.g_sd, SNRmin=args.SNRmin, SNRmax=args.SNRmax,
    )
    train = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.num_epochs, lr=args.lr,
        weight_decay=args.weight_decay, sae_weight=args.sae_weight,
        cpc_weight=args.cpc_weight, seed=args.seed, rawboost=rawboost,
        cut_length=1000 if getattr(args, "tiny", False) else 64600,
        model_parallel=getattr(args, "model_parallel", 1),
    )
    return ExperimentConfig(model=model, train=train, track=args.track, comment=args.comment)


def _device_type() -> str:
    """``cpu`` when ``SLS_TPU_PLATFORM=cpu`` asks for it, else ``cuda``."""
    plat = os.environ.get(PLATFORM_ENV, "cuda").lower()
    if plat not in ("cpu", "cuda", "gpu"):
        raise ValueError(f"{PLATFORM_ENV}={plat!r}: the port runs on 'cuda' or 'cpu'")
    return "cpu" if plat == "cpu" else "cuda"


def platform_device() -> torch.device:
    """The device entry points run on: the card, or the CPU when
    ``SLS_TPU_PLATFORM=cpu`` asks for it; raises when the card is asked
    for and absent (``device.resolve_device``).  In a multi-process job,
    this rank's card."""
    if dist.process_count() > 1:
        return resolve_device(dist.local_device(_device_type()))
    return resolve_device(_device_type())


def _protocol_paths(args):
    """The per-track protocol files (reference: main.py:661-676)."""
    proto = Path(args.protocols_path)
    return {
        "train": proto / "ASVspoof2019.LA.cm.train.trn.txt",
        "dev": proto / "ASVspoof2019.LA.cm.dev.trl.txt",
        "eval_2019": proto / "ASVspoof2019.LA.cm.eval.trl.txt",
        "eval_LA": proto / "ASVspoof2021.LA.cm.eval.trl.txt",
        "eval_DF": proto / "ASVspoof2021.DF.cm.eval.trl.txt",
        "eval_wild": proto / "in_the_wild.eval.txt",
    }


def eval_index(args):
    """(DatasetIndex, default score path) of ``args.track``'s eval list."""
    from sls_tpu_torch.data.pipeline import DatasetIndex
    from sls_tpu_torch.data.protocols import parse_eval_list, parse_train_protocol

    paths = _protocol_paths(args)
    db = Path(args.database_path)
    if args.track == "2019LA":
        # the 2019 LA eval protocol has labels; ids are its second column
        _, ids = parse_train_protocol(paths["eval_2019"])
        return (DatasetIndex.for_eval(ids, db / "ASVspoof2019_LA_eval", ext=args.audio_ext),
                "scores/scores_2019LA.txt")
    if args.track in ("LA", "DF"):
        ids = parse_eval_list(paths[f"eval_{args.track}"])
        return (DatasetIndex.for_eval(ids, db / f"ASVspoof2021_{args.track}_eval",
                                      ext=args.audio_ext),
                f"scores/scores_{args.track}.txt")
    ids = parse_eval_list(paths["eval_wild"])
    return DatasetIndex.for_in_the_wild(ids, db / "release_in_the_wild"), \
        "scores/scores_Wild.txt"


def _wire_dtype(args) -> str:
    if getattr(args, "wire_mulaw", False):
        return "mulaw"
    return "int16" if args.wire_int16 else "float32"


def run_eval(args, cfg: ExperimentConfig, trainer) -> int:
    """Write the track's score file; returns the number of lines."""
    from sls_tpu_torch.data.pipeline import BatchLoader
    from sls_tpu_torch.scores.writer import ScoreWriter

    index, default_out = eval_index(args)
    seq_parallel = args.seq_parallel > 1
    if dist.process_count() > 1 and not seq_parallel:
        # each data shard is scored on its own; the part files are merged
        # by the primary
        index = index.host_shard(*trainer.data_shard())
    out = args.eval_output or default_out
    if not args.full_utterance:
        loader = BatchLoader(index, batch_size=args.batch_size, shuffle=False,
                             cut=cfg.train.cut_length,
                             limit_batches=5 if args.quick_test else None,
                             wire_dtype=_wire_dtype(args))
        n = trainer.produce_scores(loader, out)
        _say(f"wrote {n} scores to {out}")
        return n

    from sls_tpu_torch.data.audio import load_audio
    from sls_tpu_torch.evaluation.overlap import (
        score_utterances_streamed,
        score_utterances_unwindowed,
    )

    def audio_iter():
        cap = 5 * args.batch_size if args.quick_test else None
        for i, (utt, path) in enumerate(zip(index.utt_ids, index.paths)):
            if cap is not None and i >= cap:
                return
            wav = load_audio(path)
            yield utt, wav if wav.size else np.zeros(cfg.train.cut_length, np.float32)

    if args.unwindowed:
        # the whole clip in one forward; long-T buckets take the long-T
        # attention kernel, or its sequence-parallel form across ranks
        score_model, mesh = trainer.model, None
        if seq_parallel:
            from sls_tpu_torch.models.detector import Detector
            from sls_tpu_torch.parallel.sequence import sp_mesh, sp_model_config

            # the trainer's weights under the sequence-parallel config
            score_model = Detector(sp_model_config(cfg.model), device="meta")
            score_model.load_state_dict(trainer.model.state_dict(), strict=True, assign=True)
            mesh = sp_mesh(args.seq_parallel)
        results = ((utt, score) for utt, score, _ in score_utterances_unwindowed(
            score_model, audio_iter(), cfg.model.encoder, sp_mesh=mesh,
            device=trainer.device))
    else:
        results = score_utterances_streamed(trainer.model, audio_iter(),
                                            window=cfg.train.cut_length,
                                            batch_size=args.batch_size, device=trainer.device)
    if seq_parallel:
        # every rank scores every clip (the ranks meet inside each
        # forward); the primary alone writes
        scored = list(results)
        if dist.is_primary():
            with ScoreWriter(out) as writer:
                for utt, score in scored:
                    writer.write_batch([utt], [score])
        n = len(scored)
    else:
        n = 0
        with ScoreWriter(dist.part_path(out)) as writer:
            for utt, score in results:
                writer.write_batch([utt], [score])
                n += 1
        dist.merge_part_files(out)
        n = int(dist.allreduce_sum_scalars([float(n)])[0])
    _say(f"wrote {n} scores to {out}")
    return n


def run_train(args, cfg: ExperimentConfig, trainer) -> None:
    from sls_tpu_torch.data.pipeline import BatchLoader, DatasetIndex
    from sls_tpu_torch.data.protocols import parse_train_protocol

    paths = _protocol_paths(args)
    db = Path(args.database_path)
    labels_tr, ids_tr = parse_train_protocol(paths["train"])
    labels_dev, ids_dev = parse_train_protocol(paths["dev"])
    train_index = DatasetIndex.for_train(ids_tr, labels_tr, db / "ASVspoof2019_LA_train",
                                         ext=args.audio_ext)
    dev_index = DatasetIndex.for_train(ids_dev, labels_dev, db / "ASVspoof2019_LA_dev",
                                       ext=args.audio_ext)
    if dist.process_count() > 1:
        # equal-length train shards keep the ranks in step; dev shards
        # cover every utterance (a shard a data coordinate)
        train_index = train_index.host_shard(*trainer.data_shard(), drop_remainder=True)
        dev_index = dev_index.host_shard(*trainer.data_shard())
    limit = 5 if args.quick_test else None
    wire = _wire_dtype(args)
    train_loader = BatchLoader(train_index, args.batch_size, shuffle=True,
                               cut=cfg.train.cut_length, seed=args.seed,
                               limit_batches=limit, wire_dtype=wire)
    dev_loader = BatchLoader(dev_index, args.batch_size, cut=cfg.train.cut_length,
                             limit_batches=limit, wire_dtype=wire)
    trainer.fit(train_loader, dev_loader)


def _say(msg: str) -> None:
    if dist.is_primary():
        print(msg, flush=True)


def _refusal(args):
    """The JAX CLI's rc-2 refusals of a flag combination, or None."""
    if args.resume and args.fresh_start:
        return "ERROR: --resume and --fresh_start are mutually exclusive"
    if args.unwindowed and not (args.is_eval and args.full_utterance):
        # fail loud: the fixed crop would score another behaviour than asked
        return ("ERROR: --unwindowed requires --is_eval --full_utterance "
                "(it scores whole clips in one forward)")
    if args.seq_parallel > 1 and not (args.is_eval and args.full_utterance and args.unwindowed):
        return ("ERROR: --seq_parallel requires --is_eval "
                "--full_utterance --unwindowed (it shards the frame axis "
                "of whole-clip forwards)")
    if args.cp_path and not Path(args.cp_path).exists():
        # a typo must not launch a run on a random encoder
        return f"ERROR: --cp_path checkpoint not found: {args.cp_path}"
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        print(refusal)
        return 2

    # joins a torchrun / SLS_TPU_COORDINATOR job; a no-op otherwise
    dist.initialize(device_type=_device_type())
    spawn = max(args.seq_parallel, args.model_parallel)
    if spawn > 1 and dist.process_count() == 1:
        # no job: a job of N ranks on this host, each running this
        # command (``main`` again, inside the job); this process holds
        # no model meanwhile
        from sls_tpu_torch.parallel.launch import launch

        device = platform_device()
        flag = "--seq_parallel" if args.seq_parallel > 1 else "--model_parallel"
        print(f"{flag} {spawn}: spawning {spawn} ranks on {device.type}", flush=True)
        # a training job runs for as long as it trains
        limit = 600.0 if args.seq_parallel > 1 else TRAIN_JOB_TIMEOUT_S
        return max(launch(main, spawn, (argv,), device_type=device.type, timeout_s=limit))
    if args.seq_parallel > 1 and dist.process_count() != args.seq_parallel:
        print(f"ERROR: --seq_parallel {args.seq_parallel} in a job of "
              f"{dist.process_count()} ranks: start {args.seq_parallel}")
        return 2
    device = platform_device()

    cfg = config_from_args(args)
    run_dir = Path(args.model_dir) / cfg.model_tag()
    _say(f"run dir: {run_dir}")

    if args.model_type == "sls":
        from sls_tpu_torch.models.sls import SLSTrainer as TrainerCls
    else:
        from sls_tpu_torch.train.loop import Trainer as TrainerCls

    trainer = TrainerCls(cfg, run_dir, profile_steps=args.profile_steps, device=device)

    # pretrained encoder weights: with no flag, the reference's default
    # checkpoint name is used when present
    cp_path = args.cp_path
    if not cp_path and Path("xlsr2_300m.pt").exists():
        cp_path = "xlsr2_300m.pt"
    if cp_path:
        from sls_tpu_torch.convert import load_pretrained_encoder

        trainer.model.encoder.load_state_dict(
            load_pretrained_encoder(cp_path, cfg.model.encoder), strict=True)
        _say(f"loaded pretrained encoder from {cp_path}")
    elif not args.is_eval:
        _say("WARNING: no pretrained encoder (--cp_path): training from "
             "a RANDOMLY INITIALIZED XLS-R encoder")
    trainer.init_state()

    # resume only when asked (--resume / --model_path), or for eval runs,
    # which need trained weights: an old checkpoint in the run dir must
    # not hijack a fresh training launch
    want_resume = bool(args.resume or args.model_path or args.is_eval)
    resumed = (trainer.resume(args.model_path, fresh_start=args.fresh_start)
               if want_resume else False)
    if resumed:
        _say(f"resumed at epoch {trainer.start_epoch}")

    if args.is_eval:
        run_eval(args, cfg, trainer)
    else:
        run_train(args, cfg, trainer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
