"""The flagship: ``models/detector.py::Detector``, XLS-R with the
per-timestep TopK SAE and the mean-pool classifier, weights through
``convert.detector_state_from_reference``; its reference is
``perfbench/reference/topk_sae.py``."""

from __future__ import annotations

from typing import Any, Dict, Optional

from perfbench import weights
from perfbench.families import encoder_config
from perfbench.reference import topk_sae as reference


def model_config(cfg, overrides: Optional[Dict[str, Any]] = None):
    from sls_tpu_torch.config import ModelConfig, SAEConfig

    sae, head = cfg["sae"], cfg["classifier"]
    return ModelConfig(
        encoder=encoder_config(cfg, overrides),
        use_sae=True, use_sparse_features=True,
        sae=SAEConfig(activation_dim=sae["activation_dim"], dict_size=sae["dict_size"],
                      k=sae["k"], variant=sae["variant"], use_pallas=cfg["use_pallas"]),
        classifier_hidden=head["hidden"], classifier_dropout=head["dropout"],
        num_classes=head["num_classes"])


def head_specs(cfg):
    """The SAE's and the classifier's tensors in the checkpoint's naming
    (``weights.Spec``); the encoder's weight is tied to the decoder's."""
    D, M = cfg["sae"]["activation_dim"], cfg["sae"]["dict_size"]
    hid, ncls = cfg["classifier"]["hidden"], cfg["classifier"]["num_classes"]
    return [("sae.decoder.weight", (D, M), "unit_col"), ("sae.encoder.bias", (M,), "b"),
            ("sae.b_dec", (D,), "b"),
            ("classifier.0.weight", (M,), "ln"), ("classifier.0.bias", (M,), "b"),
            ("classifier.1.weight", (hid, M), "w"), ("classifier.1.bias", (hid,), "b"),
            ("classifier.4.weight", (ncls, hid), "w"), ("classifier.4.bias", (ncls,), "b")]


def head_flops(cfg, t: int) -> float:
    """Model FLOPs of the head over ``t`` frames: the SAE's encode (no
    decode: the score does not need it) and the classifier."""
    d, m = cfg["encoder"]["hidden_size"], cfg["sae"]["dict_size"]
    hid, ncls = cfg["classifier"]["hidden"], cfg["classifier"]["num_classes"]
    return 2.0 * t * d * m + 2.0 * m * hid + 2.0 * hid * ncls


def build(run):
    """The program's model with the seed's weights, on the run's device."""
    from sls_tpu_torch.convert import detector_state_from_reference
    from sls_tpu_torch.models.detector import Detector

    mcfg = model_config(run.cell.config, (run.control or {}).get("encoder"))
    with run.span("weights"):
        state = weights.make_state(run.cell.config, run.seed, run.device)
        sd = detector_state_from_reference(state, mcfg)
        del state
        model = Detector(mcfg, device="meta").to_empty(device=run.device)
        model.load_state_dict(sd, strict=True)
    return model


def eval_step(model, device):
    from sls_tpu_torch.train.steps import make_eval_step

    return make_eval_step(model, device=device)


def reference_log_probs(state, cfg, wav, ops):
    return reference.log_probs(state, cfg, wav, ops)
