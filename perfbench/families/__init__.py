"""The program's models of each configuration family, built from a
configuration file and weights in the reference's naming, and the plain
reference beside each.

A configuration file's ``family`` names its module here, and everything
that knows the family lives in it: ``head_specs(cfg)``, the head's
tensors for ``weights.make_state``; ``head_flops(cfg, t)``, the head's
model FLOPs over ``t`` frames for ``flops.forward``; ``build(run)`` and
``eval_step(model, device)``, the program's model and its step; and
``reference_log_probs(state, cfg, wav, ops)``, the plain reference's.
A new family is a new module, with no edit to the shared files."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional


def encoder_config(cfg: Mapping, overrides: Optional[Dict[str, Any]] = None):
    """The program's ``XLSRConfig`` of a configuration file's ``encoder``
    group and ``dtype``.  Every route flag stays at the program's default
    unless ``overrides`` (a control) sets it."""
    import torch

    from sls_tpu_torch.config import XLSRConfig

    enc = cfg["encoder"]
    if enc["feat_extract_norm"] != "layer" or not enc["do_stable_layer_norm"]:
        raise ValueError("the families here are XLS-R's layer-norm, pre-LN encoder")
    return XLSRConfig(
        conv_layers=tuple(zip(enc["conv_dim"], enc["conv_kernel"], enc["conv_stride"])),
        extractor_mode="layer_norm", conv_bias=enc["conv_bias"],
        encoder_layers=enc["num_hidden_layers"], embed_dim=enc["hidden_size"],
        ffn_dim=enc["intermediate_size"], num_heads=enc["num_attention_heads"],
        activation=enc["hidden_act"], layer_norm_first=True,
        conv_pos=enc["num_conv_pos_embeddings"],
        conv_pos_groups=enc["num_conv_pos_embedding_groups"],
        dtype=getattr(torch, cfg["dtype"]), **(overrides or {}))

