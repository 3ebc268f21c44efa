"""The published XLS-R + SLS model: ``models/sls.py::SLSDetector`` and its
``SLSTrainer``, weights through ``convert.sls_detector_state_from_reference``;
its reference is ``perfbench/reference/sls.py``."""

from __future__ import annotations

from typing import Any, Dict, Optional

from perfbench import weights
from perfbench.families import encoder_config
from perfbench.reference import sls as reference
from perfbench.reference.xlsr import num_frames


def model_config(cfg, overrides: Optional[Dict[str, Any]] = None):
    from sls_tpu_torch.config import ModelConfig

    return ModelConfig(encoder=encoder_config(cfg, overrides), use_sae=False)


def head_specs(cfg):
    """The SLS head's tensors in the upstream ``.pth`` naming
    (``weights.Spec``)."""
    C, head = cfg["encoder"]["hidden_size"], cfg["sls_head"]
    fc1_in = (num_frames(cfg["encoder"], cfg["cut_length"]) // 3) * (C // 3)
    return [("fc0.weight", (1, C), "w"), ("fc0.bias", (1,), "b"),
            ("first_bn.weight", (1,), "ln"), ("first_bn.bias", (1,), "b"),
            ("first_bn.running_mean", (1,), "bn_mean"), ("first_bn.running_var", (1,), "bn_var"),
            ("fc1.weight", (head["hidden"], fc1_in), "w"), ("fc1.bias", (head["hidden"],), "b"),
            ("fc3.weight", (head["num_classes"], head["hidden"]), "w"),
            ("fc3.bias", (head["num_classes"],), "b")]


def head_flops(cfg, t: int) -> float:
    """Model FLOPs of the head over ``t`` frames: the layer gate over
    every hidden state, fc1 over the pooled map, fc3."""
    c, layers, head = cfg["encoder"]["hidden_size"], cfg["encoder"]["num_hidden_layers"], cfg[
        "sls_head"]
    fc1_in = (t // 3) * (c // 3)
    return 2.0 * layers * c + 2.0 * fc1_in * head["hidden"] + 2.0 * head["hidden"] * head[
        "num_classes"]


def program_state(run, mcfg):
    from sls_tpu_torch.convert import sls_detector_state_from_reference

    state = weights.make_state(run.cell.config, run.seed, run.device)
    sd = sls_detector_state_from_reference(state, mcfg)
    del state
    return sd


def build(run):
    """The program's model with the seed's weights, on the run's device."""
    from sls_tpu_torch.models.sls import SLSDetector

    mcfg = model_config(run.cell.config, (run.control or {}).get("encoder"))
    with run.span("weights"):
        sd = program_state(run, mcfg)
        model = SLSDetector(mcfg, device="meta", cut_length=run.cell.config["cut_length"])
        model = model.to_empty(device=run.device)
        model.load_state_dict(sd, strict=True)
    return model


def build_trainer(run, recipe: Dict[str, Any]):
    """An ``SLSTrainer`` of the recipe (``TrainConfig`` fields; RawBoost's
    algorithm), its model holding the seed's weights, its state made."""
    from sls_tpu_torch.config import ExperimentConfig, RawBoostConfig, TrainConfig
    from sls_tpu_torch.models.sls import SLSTrainer

    mcfg = model_config(run.cell.config)
    tcfg = TrainConfig(batch_size=run.params["batch"], lr=recipe["lr"],
                       weight_decay=recipe["weight_decay"],
                       loss_weights=tuple(recipe["loss_weights"]),
                       cut_length=run.cell.config["cut_length"],
                       rawboost=RawBoostConfig(algo=recipe["rawboost_algo"]))
    exp = ExperimentConfig(model=mcfg, train=tcfg)
    with run.span("weights"):
        trainer = SLSTrainer(exp, run.tmp / "run", tensorboard=False, device=run.device)
        trainer.model.load_state_dict(program_state(run, mcfg), strict=True)
        trainer.init_state()
    return trainer


def eval_step(model, device):
    from sls_tpu_torch.models.sls import make_sls_eval_step

    return make_sls_eval_step(model, device=device)


def reference_log_probs(state, cfg, wav, ops):
    return reference.log_probs(state, cfg, wav, ops)[0]


def reference_train_forward(cfg, ops):
    """``forward(state, leaves, wav) -> log_probs`` of the train step."""

    def forward(state, leaves, wav):
        return reference.log_probs({**state, **leaves}, cfg, wav, ops, train=True,
                                   params=leaves)[0]

    return forward


def leaf_name(name: str) -> str:
    """The reference's name (``reference/train.py``'s leaves) of a program
    parameter."""
    if name.startswith("sls_head."):
        return name[len("sls_head."):]
    if not name.startswith("encoder."):
        raise KeyError(name)
    n = name[len("encoder."):]
    rules = (("feature_extractor.conv.", "feature_extractor.conv_layers.", ".0."),
             ("feature_extractor.norm.", "feature_extractor.conv_layers.", ".2.1."))
    for src, dst, mid in rules:
        if n.startswith(src):
            idx, leaf = n[len(src):].split(".", 1)
            return f"{dst}{idx}{mid}{leaf}"
    fixed = {"post_extract_norm.": "layer_norm.", "post_extract_proj.": "post_extract_proj.",
             "pos_conv.conv.": "encoder.pos_conv.0.", "encoder_layer_norm.": "encoder.layer_norm.",
             "layers.": "encoder.layers."}
    for src, dst in fixed.items():
        if n.startswith(src):
            return dst + n[len(src):]
    raise KeyError(name)
