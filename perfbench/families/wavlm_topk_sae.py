"""WavLM-Large under the flagship's head: ``models/detector.py::Detector``
with a ``WavLMConfig`` encoder (the gated relative-position bias in every
layer's attention), the per-timestep TopK SAE and the mean-pool
classifier, weights through ``convert.detector_state_from_reference``;
its reference is ``perfbench/reference/wavlm.py``.

``weights.make_state`` draws XLS-R's encoder tensors, conv biases
included; ``head_specs`` adds WavLM's own (each layer's gate, layer 0's
bias table) beside the SAE's and the classifier's.  ``prepared`` makes
the state the model holds, for the program and the reference alike: the
conv biases dropped where the configuration says the model has none,
and the bias table at std ``TABLE_STD`` where ``make_state``'s
1/sqrt(fan-in) draws it at 1/sqrt(heads), 0.25.  Std 4 is an
assumption that no trained table has checked: no WavLM checkpoint is in
the repository.  It is drawn so large because at std 0.25 and at 1 the
bias moved no clip's pooled log-probability beyond the program's own
rounding on the long clips, so the check could not tell a program that
drops it (PERF.md)."""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional

from perfbench import weights
from perfbench.families import topk_sae
from perfbench.reference import wavlm as reference
from perfbench.reference.xlsr import FAIRSEQ

CONV_BIAS = re.compile(re.escape(FAIRSEQ) + r"feature_extractor\.conv_layers\.\d+\.0\.bias$")
TABLE = f"{FAIRSEQ}encoder.layers.0.self_attn.relative_attention_bias.weight"
TABLE_STD = 4.0


def model_config(cfg, overrides: Optional[Dict[str, Any]] = None):
    from sls_tpu_torch.config import WavLMConfig

    mcfg = topk_sae.model_config(cfg, overrides)
    enc, xlsr = cfg["encoder"], mcfg.encoder
    wavlm = WavLMConfig(**{f.name: getattr(xlsr, f.name) for f in dataclasses.fields(xlsr)},
                        num_buckets=enc["num_buckets"], max_distance=enc["max_bucket_distance"])
    return dataclasses.replace(mcfg, encoder=wavlm)


def head_specs(cfg):
    """The SAE's and classifier's tensors, and WavLM's beyond XLS-R's:
    each layer's ``grep_linear`` and ``grep_a`` (near 1 + 0.1 z, as a
    LayerNorm scale), layer 0's ``relative_attention_bias``."""
    enc = cfg["encoder"]
    heads = enc["num_attention_heads"]
    d = enc["hidden_size"] // heads
    specs = [(f"{FAIRSEQ}encoder.layers.0.self_attn.relative_attention_bias.weight",
              (enc["num_buckets"], heads), "w")]
    for i in range(enc["num_hidden_layers"]):
        base = f"{FAIRSEQ}encoder.layers.{i}.self_attn"
        specs += [(f"{base}.grep_linear.weight", (8, d), "w"),
                  (f"{base}.grep_linear.bias", (8,), "b"),
                  (f"{base}.grep_a", (1, heads, 1, 1), "ln")]
    return specs + topk_sae.head_specs(cfg)


def head_flops(cfg, t: int) -> float:
    """The SAE's encode and the classifier (``topk_sae.head_flops``), and
    every layer's gate: ``grep_linear``'s [t H, d] x [d, 8] product, 16 t C."""
    enc = cfg["encoder"]
    gates = 16.0 * t * enc["hidden_size"] * enc["num_hidden_layers"]
    return topk_sae.head_flops(cfg, t) + gates


def prepared(state, cfg):
    """The model's state from ``make_state``'s: no conv biases where
    ``conv_bias`` is false, and the bias table at std ``TABLE_STD``."""
    enc = cfg["encoder"]
    out = {k: v for k, v in state.items() if enc["conv_bias"] or not CONV_BIAS.match(k)}
    out[TABLE] = state[TABLE] * (TABLE_STD * enc["num_attention_heads"] ** 0.5)
    return out


def build(run):
    """The program's model with the seed's weights, on the run's device."""
    from sls_tpu_torch.convert import detector_state_from_reference
    from sls_tpu_torch.models.detector import Detector

    mcfg = model_config(run.cell.config, (run.control or {}).get("encoder"))
    with run.span("weights"):
        state = prepared(weights.make_state(run.cell.config, run.seed, run.device),
                         run.cell.config)
        sd = detector_state_from_reference(state, mcfg)
        del state
        model = Detector(mcfg, device="meta").to_empty(device=run.device)
        model.load_state_dict(sd, strict=True)
    return model


eval_step = topk_sae.eval_step


def reference_log_probs(state, cfg, wav, ops):
    return reference.log_probs(prepared(state, cfg), cfg, wav, ops)
