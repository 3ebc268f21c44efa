"""Turn-key real-weights parity kit, counterpart of
``sls_tpu/cli/parity_kit.py``: the command to run once trained reference
weights and real audio are at hand.

    python -m sls_tpu_torch.cli.parity_kit \\
        --cp_path best_checkpoint_eer.pth \\
        --wav_dir /data/ASVspoof2021_DF_eval/flac \\
        --ref_scores scores_DF_reference.txt \\
        --out scores_DF_port.txt

One invocation loads the reference PyTorch checkpoint, infers the
architecture from its weights and stored args (the reference's
checkpoint-as-config idiom), converts it (``convert.py``), scores every
utterance as ``train/loop.py::produce_scores`` does (P(bonafide) a line,
``scores/writer.py``), and diffs the score file against the reference's,
keyed by utterance id.  Without ``--ref_scores`` it is a plain
checkpoint-driven scorer; ``--eval_list`` / ``--database_path`` take a
protocol's layout instead of a directory.

It runs on the card (or the CPU with ``SLS_TPU_PLATFORM=cpu``).  By
default the production route: a bf16 encoder and the SAE through the
hand-written kernels (rows 1 and 2 a batch for a per-timestep
checkpoint, 3 and 5 for a window-overlap one; an SLS checkpoint has no
SAE).  ``--fp32`` runs the encoder and the SAE in fp32 on the plain
route, with TF32 off, for tight numerics.

Exit code 0: scores written (and, when diffed, max |Δscore| within
``--tolerance``); 1: a parity failure; 2: a usage error (argparse).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pickle
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from sls_tpu_torch.config import ModelConfig, SAEConfig, XLSRConfig
from sls_tpu_torch.convert import infer_sae_config_from_state, strip_prefixes


def load_reference_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A reference ``.pth``: a dict checkpoint (``{'model': state, 'args':
    ..., 'epoch': ...}``) or a bare state dict, ``module.`` prefixes
    stripped.  Read with ``weights_only=True``; only a file that the safe
    unpickler refuses for its embedded ``argparse.Namespace`` (the
    reference's ``args``) is read again with the full unpickler."""
    try:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as exc:
        if "argparse.Namespace" not in str(exc):
            raise
        raw = torch.load(path, map_location="cpu", weights_only=False)

    meta: Dict[str, Any] = {}
    if isinstance(raw, dict) and "model" in raw:
        state = raw["model"]
        meta["epoch"] = raw.get("epoch")
        args = raw.get("args")
        if args is not None:
            meta["args"] = vars(args) if hasattr(args, "__dict__") else dict(args)
    else:
        state = raw
    state = strip_prefixes({k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                            for k, v in state.items()})
    return state, meta


def infer_architecture(state: Dict[str, np.ndarray], meta: Dict, variant: str = "auto",
                       window_size: int = 0) -> Tuple[str, Optional[ModelConfig]]:
    """(family, config) from the weights and the stored args.

    The weights give the family (SLS head or SAE detector), dict_size, k,
    ``use_sparse_features`` and the encoder's depth and widths; the
    stored args what shapes cannot tell: the window variant (the same
    parameters, another forward) and its window."""
    if "fc0.weight" in state:  # the upstream SLS head
        return "sls", None
    if not any(k.startswith("sae.") for k in state):
        raise ValueError("checkpoint has neither an SLS head (fc0.*) nor a SAE (sae.*); "
                         f"keys look like: {sorted(state)[:6]} ...")

    sae = infer_sae_config_from_state(state)
    args = meta.get("args", {})
    if variant == "auto":
        if args.get("use_cpc"):
            variant = "window_hard"  # CPC trains on hard windows
        elif args.get("use_window_topk"):
            variant = "window_overlap"
        else:
            variant = "per_timestep"
    w = window_size or int(args.get("sae_window_size", 8) or 8)
    sae = SAEConfig(activation_dim=sae.activation_dim, dict_size=sae.dict_size, k=sae.k,
                    variant=variant, window_size=w)

    cls_in = state["classifier.1.weight"].shape[1]
    use_sparse = cls_in == sae.dict_size

    # the encoder's depth and widths from the weights; the conv strides
    # are the fixed wav2vec2 spec, which shapes do not show
    prefix = "ssl_model.model.encoder.layers."
    n_layers = 1 + max(int(k[len(prefix):].split(".")[0]) for k in state
                       if k.startswith(prefix))
    embed = state["ssl_model.model.post_extract_proj.weight"].shape[0]
    ffn = state["ssl_model.model.encoder.layers.0.fc1.weight"].shape[0]
    defaults = XLSRConfig()
    enc = XLSRConfig(encoder_layers=n_layers, embed_dim=embed, ffn_dim=ffn,
                     num_heads=(defaults.num_heads if embed == defaults.embed_dim
                                else max(1, embed // 64)))
    return "sae", ModelConfig(encoder=enc, sae=sae, use_sae=True,
                              use_sparse_features=use_sparse,
                              classifier_hidden=state["classifier.1.weight"].shape[0])


def build_scorer(kind: str, state: Dict[str, np.ndarray], mcfg: Optional[ModelConfig],
                 device: torch.device, kernels: bool = True, cut: int = 64600) -> Callable:
    """The eval step (wav on the wire -> log-probs and scores on the
    device) of a ``Detector`` or, for ``kind`` "sls", an ``SLSDetector``
    of ``cut``-sample clips, on the checkpoint's converted weights;
    ``kernels`` routes the SAE through the hand-written kernels."""
    if kind == "sls":
        from sls_tpu_torch.convert import sls_detector_state_from_reference
        from sls_tpu_torch.models.sls import SLSDetector, make_sls_eval_step

        mcfg = mcfg or ModelConfig(use_sae=False)
        model = SLSDetector(mcfg, device="meta", cut_length=cut)
        weights = sls_detector_state_from_reference(state, mcfg)
        step = make_sls_eval_step
    else:
        from sls_tpu_torch.convert import detector_state_from_reference
        from sls_tpu_torch.models.detector import Detector
        from sls_tpu_torch.train.steps import make_eval_step

        mcfg = dataclasses.replace(mcfg, sae=dataclasses.replace(mcfg.sae, use_pallas=kernels))
        model = Detector(mcfg, device="meta")
        weights = detector_state_from_reference(state, mcfg)
        step = make_eval_step
    model.load_state_dict({k: v.to(device).contiguous() for k, v in weights.items()},
                          strict=True, assign=True)
    return step(model, device=device)


def score_index(index, eval_step: Callable, out_path, batch_size: int, cut: int) -> int:
    """The reference's score loop over ``index``: fixed-shape batches of
    ``cut`` samples (``BatchLoader``; a padded tail's rows are not
    written), one ``utt score`` line each (``produce_scores``); returns
    the number of lines."""
    from sls_tpu_torch.data.pipeline import BatchLoader
    from sls_tpu_torch.train.loop import produce_scores

    return produce_scores(eval_step, BatchLoader(index, batch_size, cut=cut, num_threads=4),
                          out_path)


def diff_scores(ours_path, ref_path, tolerance: float) -> Dict[str, Any]:
    """Elementwise score-file comparison keyed on utterance id."""
    from sls_tpu_torch.scores.writer import read_score_file

    our_ids, our_s = read_score_file(ours_path)
    ref_ids, ref_s = read_score_file(ref_path)
    ref_map = dict(zip(ref_ids, ref_s))
    our_map = dict(zip(our_ids, our_s))
    common = [u for u in our_ids if u in ref_map]
    if not common:
        return {"ok": False, "error": "no common utterance ids",
                "n_ours": len(our_ids), "n_ref": len(ref_ids)}
    ours = (np.asarray([our_map[u] for u in common])
            if len(common) != len(our_ids) else our_s)
    ref = np.asarray([ref_map[u] for u in common])
    d = np.abs(ours - ref)
    # decision flips at the P(bonafide) = 0.5 boundary: what the EER feels
    flips = int(((ours > 0.5) != (ref > 0.5)).sum())
    corr = float(np.corrcoef(ours, ref)[0, 1]) if len(common) > 1 else 1.0
    return {
        "n_compared": len(common),
        "n_missing_in_ref": len(our_ids) - len(common),
        "n_missing_in_ours": sum(1 for u in ref_ids if u not in our_map),
        "max_abs_diff": float(d.max()),
        "mean_abs_diff": float(d.mean()),
        "pearson": corr,
        "decision_flips": flips,
        "tolerance": tolerance,
        "ok": bool(d.max() < tolerance),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="real-weights parity kit: convert, score, diff")
    p.add_argument("--cp_path", required=True, help="reference PyTorch checkpoint (.pth)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav_dir", help="directory of .flac/.wav files to score")
    src.add_argument("--eval_list", help="protocol file of utterance ids (one per line)")
    p.add_argument("--database_path",
                   help="base dir for --eval_list (<base>/flac/<utt>.flac)")
    p.add_argument("--ref_scores", help="reference score file to diff against")
    p.add_argument("--out", default="scores_parity.txt")
    p.add_argument("--batch_size", type=int, default=36)
    p.add_argument("--cut_length", type=int, default=64600)
    p.add_argument("--num_utts", type=int, default=0, help="cap utterances (0 = all)")
    p.add_argument("--variant", default="auto",
                   choices=["auto", "per_timestep", "window_overlap", "window_hard"])
    p.add_argument("--window_size", type=int, default=0,
                   help="override SAE window size (0 = from checkpoint args)")
    p.add_argument("--tolerance", type=float, default=2e-3,
                   help="max |Δ P(bonafide)| gate for --ref_scores")
    p.add_argument("--config_json",
                   help="ExperimentConfig JSON overriding the inferred model topology "
                        "(testing / nonstandard encoders)")
    p.add_argument("--fp32", action="store_true",
                   help="fp32 encoder and SAE on the plain route, TF32 off (tight "
                        "numerics; default the bf16 production path)")
    args = p.parse_args(argv)

    from sls_tpu_torch.cli.main import platform_device
    from sls_tpu_torch.data.pipeline import DatasetIndex

    device = platform_device()
    state, meta = load_reference_checkpoint(args.cp_path)
    if args.config_json:
        from sls_tpu_torch.config import ExperimentConfig, config_from_dict

        cfg = config_from_dict(ExperimentConfig, json.loads(Path(args.config_json).read_text()))
        kind = "sls" if "fc0.weight" in state else "sae"
        mcfg = cfg.model
    else:
        kind, mcfg = infer_architecture(state, meta, args.variant, args.window_size)
    print(f"checkpoint: {args.cp_path} (family: {kind}, epoch: {meta.get('epoch')})")
    if mcfg is not None and mcfg.use_sae:
        print(f"inferred: dict={mcfg.sae.dict_size} k={mcfg.sae.k} "
              f"variant={mcfg.sae.variant} w={mcfg.sae.window_size} "
              f"sparse_features={mcfg.use_sparse_features} "
              f"layers={mcfg.encoder.encoder_layers} embed={mcfg.encoder.embed_dim}")

    if args.fp32 and mcfg is not None:
        mcfg = dataclasses.replace(
            mcfg, encoder=dataclasses.replace(mcfg.encoder, dtype=torch.float32))

    if args.wav_dir:
        wavs = sorted(list(Path(args.wav_dir).glob("*.flac"))
                      + list(Path(args.wav_dir).glob("*.wav")))
        if not wavs:
            print(f"no .flac/.wav files in {args.wav_dir}", file=sys.stderr)
            return 1
        index = DatasetIndex(utt_ids=[w.stem for w in wavs], paths=wavs)
    else:
        if not args.database_path:
            p.error("--eval_list requires --database_path")
        utts = [line.split()[0] for line in Path(args.eval_list).read_text().splitlines()
                if line.strip()]
        index = DatasetIndex.for_eval(utts, args.database_path)
    if args.num_utts:
        index = DatasetIndex(utt_ids=index.utt_ids[:args.num_utts],
                             paths=index.paths[:args.num_utts])

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if args.fp32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        step = build_scorer(kind, state, mcfg, device, kernels=not args.fp32,
                            cut=args.cut_length)
        n = score_index(index, step, args.out, args.batch_size, args.cut_length)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    print(f"scored {n} utterances -> {args.out}")

    if not args.ref_scores:
        return 0
    report = diff_scores(args.out, args.ref_scores, args.tolerance)
    print(json.dumps(report, indent=2))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
