"""The weights bridge and the config JSON between the two packages."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sls_tpu import config as jcfg
from sls_tpu.models.detector import Detector as JaxDetector
from sls_tpu_torch import config as tcfg
from sls_tpu_torch.convert import detector_state_from_flax
from sls_tpu_torch.models.detector import Detector

TINY = [
    ("layer_norm", True, True, True),    # XLS-R topology, sparse codes, kernels
    ("default", False, False, False),    # group-norm, post-LN, recon head
]


def _pair_configs(mode, lnf, sparse, pallas):
    sae = dict(activation_dim=64, dict_size=256, k=32, use_pallas=pallas)
    j = jcfg.ModelConfig(
        encoder=jcfg.tiny_xlsr_config(extractor_mode=mode, layer_norm_first=lnf),
        use_sparse_features=sparse, sae=jcfg.SAEConfig(**sae))
    t = tcfg.ModelConfig(
        encoder=tcfg.tiny_xlsr_config(extractor_mode=mode, layer_norm_first=lnf),
        use_sparse_features=sparse, sae=tcfg.SAEConfig(**sae))
    return j, t


def _flagship_configs():
    sae = dict(activation_dim=1024, dict_size=4096, k=128, use_pallas=True)
    j = jcfg.ModelConfig(encoder=jcfg.XLSRConfig(dtype=jnp.bfloat16),
                         sae=jcfg.SAEConfig(**sae))
    t = tcfg.ModelConfig(encoder=tcfg.XLSRConfig(dtype=torch.bfloat16),
                         sae=tcfg.SAEConfig(**sae))
    return j, t


@pytest.mark.parametrize("topology", TINY, ids=["xlsr", "default_postln_recon"])
def test_state_covers_every_key_strict(topology):
    j, t = _pair_configs(*topology)
    wav = jnp.zeros((1, 4000), jnp.float32)
    params = jax.eval_shape(lambda k: JaxDetector(j).init(k, wav), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    arrays = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                          params["params"])
    port = Detector(t, device="cpu")
    result = port.load_state_dict(detector_state_from_flax(arrays), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # values land where they belong: a Dense kernel [in, out] -> [out, in]
    np.testing.assert_array_equal(
        port.encoder.layers[0].fc1.weight.detach().numpy(),
        arrays["encoder"]["layer_0"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        port.encoder.pos_conv.conv.weight.detach().numpy(),
        arrays["encoder"]["pos_conv"]["conv"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(port.sae.W_enc.detach().numpy(),
                                  arrays["sae"]["W_enc"])


def test_state_shapes_at_flagship_width():
    """The one real-width check: the flagship's ~325M-parameter tree goes
    through the converter by shape alone (zero-stride stand-ins, no
    compute) and must match the port's Detector on the meta device."""
    j, t = _flagship_configs()
    wav = jax.ShapeDtypeStruct((1, 64600), jnp.float32)
    shapes = jax.eval_shape(JaxDetector(j).init, jax.random.PRNGKey(0), wav)["params"]
    zero = np.zeros(1, np.float32)
    stand_ins = jax.tree.map(
        lambda s: np.lib.stride_tricks.as_strided(zero, s.shape, (0,) * len(s.shape)),
        shapes)
    state = detector_state_from_flax(stand_ins)
    expected = {k: tuple(v.shape) for k, v in Detector(t, device="meta").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == expected
    assert expected["encoder.pos_conv.conv.weight"] == (1024, 64, 128)
    assert expected["encoder.feature_extractor.conv.0.weight"] == (512, 1, 10)
    # 24 layers x 16 tensors, 7 convs and 7 norms x 2, projection, pos-conv
    # and two encoder norms x 2, the SAE's 4, the head's 6
    assert len(expected) == 24 * 16 + 7 * 4 + 8 + 4 + 6


def test_config_json_loads_into_equal_values():
    exp = jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(encoder=jcfg.XLSRConfig(dtype=jnp.bfloat16),
                               sae=jcfg.SAEConfig(use_pallas=True, k=64)),
        train=jcfg.TrainConfig(batch_size=36, loss_weights=(0.2, 0.8)),
        track="DF", comment="port")
    d = json.loads(jcfg.config_to_json(exp))
    port = tcfg.config_from_dict(tcfg.ExperimentConfig, d)
    assert port.model.encoder.dtype is torch.bfloat16
    assert port.model.sae.use_pallas and port.model.sae.k == 64
    assert port.train.loss_weights == (0.2, 0.8)
    assert port.model.encoder.conv_layers == exp.model.encoder.conv_layers
    # every field equal: the port writes back the same JSON
    assert json.loads(tcfg.config_to_json(port)) == d
    # and the field names and defaults are the reference's
    for ours, ref in ((tcfg.XLSRConfig, jcfg.XLSRConfig), (tcfg.SAEConfig, jcfg.SAEConfig),
                      (tcfg.ModelConfig, jcfg.ModelConfig),
                      (tcfg.TrainConfig, jcfg.TrainConfig)):
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(ref)]
    assert json.loads(tcfg.config_to_json(tcfg.ExperimentConfig())) == \
        json.loads(jcfg.config_to_json(jcfg.ExperimentConfig()))
