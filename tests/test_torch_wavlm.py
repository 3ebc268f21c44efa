"""WavLM in the port: the gated relative-position bias of ``WavLMConfig``
encoders, on the CPU against unilm's bucket function (transcribed below
line by line) and the plain reference ``perfbench/reference/wavlm.py``;
the biased kernel's plain version and emulation against a dense
attention built from the bucket table directly; the weight bridges, the
config's JSON, the training gradients, and the routes that refuse it.
On a card (``cuda``) the biased kernel against its plain version and
emulation, and ``attention_long_kernel`` bit-equal to the biased kernel
at a zero bias:

    python -m pytest --noconftest -m cuda tests/test_torch_wavlm.py
"""

import dataclasses
import json
import math

import pytest
import torch

from perfbench import weights
from perfbench.families import wavlm_topk_sae as family
from perfbench.reference import wavlm as ref
from perfbench.reference import xlsr as ref_xlsr
from perfbench.tests.tiny import tiny_config
from sls_tpu_torch import config as tcfg
from sls_tpu_torch import convert
from sls_tpu_torch.encoder.xlsr import XLSREncoder, init_weights_, relative_position_bucket
from sls_tpu_torch.kernels import attention as ta
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel.sequence import sp_model_config
from sls_tpu_torch.train.profiling import recording

DH = 64
# small buckets at tiny T, so that the logarithmic branch and the cap run
SMALL_BUCKETS = {"num_buckets": 32, "max_bucket_distance": 64}
# float32 on both sides: what is left is the order of sums and the
# program's fast-variance LayerNorm
F32_TOL = 1e-4


class _UnilmBuckets:
    """unilm ``wavlm/modules.py`` ``MultiheadAttention._relative_positions_bucket``,
    line by line."""

    def __init__(self, num_buckets, max_distance):
        self.num_buckets = num_buckets
        self.max_distance = max_distance

    def _relative_positions_bucket(self, relative_positions, bidirectional=True):
        num_buckets = self.num_buckets
        max_distance = self.max_distance
        relative_buckets = 0

        if bidirectional:
            num_buckets = num_buckets // 2
            relative_buckets += (relative_positions > 0).to(torch.long) * num_buckets
            relative_positions = torch.abs(relative_positions)
        else:
            relative_positions = -torch.min(relative_positions, torch.zeros_like(relative_positions))

        max_exact = num_buckets // 2
        is_small = relative_positions < max_exact

        relative_postion_if_large = max_exact + (
                torch.log(relative_positions.float() / max_exact)
                / math.log(max_distance / max_exact)
                * (num_buckets - max_exact)
        ).to(torch.long)
        relative_postion_if_large = torch.min(
            relative_postion_if_large, torch.full_like(relative_postion_if_large, num_buckets - 1)
        )

        relative_buckets += torch.where(is_small, relative_positions, relative_postion_if_large)
        return relative_buckets


def tiny_wavlm(**overrides):
    base = dataclasses.asdict(tcfg.tiny_xlsr_config(conv_bias=False))
    base.update(num_buckets=32, max_distance=64, **overrides)
    return tcfg.WavLMConfig(**base)


def _samples(cfg, frames):
    n = 1
    while cfg.num_frames(n) < frames:
        n += 1
    return n


def _cfg_dict():
    cfg = tiny_config("wavlm_large_topk_sae")
    cfg["encoder"].update(SMALL_BUCKETS)
    cfg["use_pallas"] = False  # the SAE in float32 too
    return cfg


def _program(cfg, seed=7, overrides=None):
    """(the Detector on the reference state of ``seed``, that state)."""
    state = family.prepared(weights.make_state(cfg, seed, torch.device("cpu")), cfg)
    mcfg = family.model_config(cfg, overrides)
    model = Detector(mcfg, device="cpu")
    model.load_state_dict(convert.detector_state_from_reference(state, mcfg), strict=True)
    return model, state


# -- the bucket function and the table ---------------------------------------


@pytest.mark.parametrize("nb,md", [(320, 800), (32, 64), (8, 20)])
def test_bucket_matches_unilm(nb, md):
    delta = torch.arange(-3000, 3001)
    got = relative_position_bucket(delta, nb, md)
    want = _UnilmBuckets(nb, md)._relative_positions_bucket(delta)
    assert torch.equal(got, want)
    # every branch ran: exact, logarithmic and the cap, on both sides
    n = delta.abs()
    assert bool((got[n < nb // 4] == (delta > 0).long()[n < nb // 4] * (nb // 2)
                 + n[n < nb // 4]).all())
    assert set(got[delta <= 0].tolist()) == set(range(nb // 2))
    assert set(got[delta > 0].tolist()) == set(range(nb // 2 + 1, nb))  # no n = 0 there
    # from max_distance on a side holds its last bucket (the kernel's `flat`)
    assert bool((got[delta >= md] == nb - 1).all())
    assert bool((got[delta <= -md] == nb // 2 - 1).all())


def test_table_holds_each_distance_bucket():
    cfg = tiny_wavlm()
    enc = XLSREncoder(cfg, device="cpu")
    init_weights_(enc, torch.Generator().manual_seed(1))
    attn = enc.layers[0].self_attn
    t = 150
    table = attn.relpos_table(t)
    assert table.shape == (cfg.num_heads, 2 * t - 1) and table.is_contiguous()
    dense = ta.relpos_dense(table, t)
    pos = torch.arange(t)
    bucket = _UnilmBuckets(32, 64)._relative_positions_bucket(pos[None, :] - pos[:, None])
    assert torch.equal(dense, attn.relative_attention_bias.weight[bucket].permute(2, 0, 1))
    assert not any(hasattr(layer.self_attn, "relative_attention_bias") for layer in enc.layers[1:])


# -- the encoder and the detector against the plain reference ----------------


@pytest.mark.parametrize("route", ["einsum", "kernel_plain"])
def test_encoder_matches_reference(route):
    """The tiny fp32 WavLM encoder on seeded weights against the plain
    reference, on the einsum route (T 79) and on the long-T route's
    plain version (T 256, ``flash_long_t`` 256)."""
    cfg = _cfg_dict()
    overrides = {"flash_long_t": 256} if route == "kernel_plain" else None
    model, state = _program(cfg, overrides=overrides)
    frames = 256 if route == "kernel_plain" else 79
    wav = torch.randn(2, _samples(model.config.encoder, frames),
                      generator=torch.Generator().manual_seed(3))
    before = ta.flash_attention_long_relpos.launches
    with torch.no_grad(), recording() as rec:
        got = model.encoder(wav)
    want, _ = ref.encoder_forward(ref_xlsr.encoder_params(state), cfg["encoder"], wav)
    assert got.shape == want.shape == (2, frames, cfg["encoder"]["hidden_size"])
    assert float((got - want).abs().max()) <= F32_TOL * float(want.abs().max())
    layers = cfg["encoder"]["num_hidden_layers"]
    name = f"sls.attention.relpos_{'kernel' if route == 'kernel_plain' else 'dense'}"
    assert rec.counts.get(name) == layers
    assert sum(s.name == "sls.relpos" for s in rec.spans) == 1
    assert ta.flash_attention_long_relpos.launches == before  # the CPU takes the plain version


def test_detector_log_probs_match_reference():
    cfg = _cfg_dict()
    model, state = _program(cfg)
    wav = torch.randn(3, 1600, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(wav)["log_probs"]
        want = ref.log_probs(state, cfg, wav)
    assert float((got - want).abs().max()) <= 1e-3  # the classifier's LayerNorm eps differs


def test_the_bias_moves_the_output():
    """Dropping the bias (a zero table) changes the features far beyond
    the tolerance above."""
    cfg = _cfg_dict()
    model, _ = _program(cfg)
    wav = torch.randn(1, 1600, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        out = model.encoder(wav)
        model.encoder.layers[0].self_attn.relative_attention_bias.weight.zero_()
        dropped = model.encoder(wav)
    assert float((out - dropped).abs().max()) > 100 * F32_TOL * float(out.abs().max())


def test_train_gradients_match_reference():
    """One backward through the encoder's training route (dropout 0)
    against autograd through the reference: the bias table, and each
    layer's grep_linear and grep_a."""
    cfg = _cfg_dict()
    model, state = _program(cfg)
    enc = model.encoder
    wav = torch.randn(2, 1600, generator=torch.Generator().manual_seed(6))
    r = torch.randn(2, enc.config.num_frames(1600), enc.config.embed_dim,
                    generator=torch.Generator().manual_seed(7))
    out = enc(wav, train=True, generator=torch.Generator().manual_seed(0))
    (out * r).sum().backward()
    p = {k: v.clone().requires_grad_(True) for k, v in ref_xlsr.encoder_params(state).items()}
    want, _ = ref.encoder_forward(p, cfg["encoder"], wav)
    (want * r).sum().backward()
    names = ["layers.0.self_attn.relative_attention_bias.weight"]
    for i in range(cfg["encoder"]["num_hidden_layers"]):
        names += [f"layers.{i}.self_attn.{n}"
                  for n in ("grep_linear.weight", "grep_linear.bias", "grep_a")]
    params = dict(enc.named_parameters())
    for name in names:
        got = params[name].grad
        theirs = p[f"encoder.{name}"].grad.reshape(got.shape)
        assert bool(torch.isfinite(got).all()) and float(theirs.norm()) > 0, name
        assert float((got - theirs).norm()) <= 1e-3 * float(theirs.norm()), name


# -- the kernel's plain version and emulation ---------------------------------


def _attention_inputs(b, t, h, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(b, t, h * DH, generator=g, device=device) * 0.5 for _ in range(3))
    gate = 1.0 + torch.rand(b, h, t, generator=g, device=device)
    emb = torch.randn(32, h, generator=g, device=device)
    pos = torch.arange(1 - t, t, device="cpu")
    table = emb[relative_position_bucket(pos, 32, 64).to(device)].t().contiguous()
    return q, k, v, gate, table, emb


def _dense_reference(q, k, v, gate, emb, h):
    """float64 attention with the bias [B, H, T, T] built from the buckets."""
    b, t, c = q.shape
    pos = torch.arange(t)
    bias = emb.double()[_UnilmBuckets(32, 64)._relative_positions_bucket(
        pos[None, :] - pos[:, None]).to(emb.device)].permute(2, 0, 1)
    qh, kh, vh = (x.double().reshape(b, t, h, DH).transpose(1, 2) for x in (q, k, v))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) + gate.double()[..., None] * bias, -1)
    return (probs @ vh).transpose(1, 2).reshape(b, t, c)


@pytest.mark.parametrize("t", [130, 384])
def test_plain_version_matches_dense_reference(t):
    q, k, v, gate, table, emb = _attention_inputs(2, t, 2, seed=t)
    plain = ta.flash_attention_long_relpos_plain(q, k, v, gate, table, 2)
    want = _dense_reference(q, k, v, gate, emb, 2)
    assert float((plain.double() - want).abs().max()) <= 1e-5
    wrapped = ta.flash_attention_long_relpos(q, k, v, gate, table, 2, block_q=t // 2)
    assert torch.equal(wrapped, plain)
    emulated = ta.attention_online_emulated(q, k, v, 2, gate=gate, table=table)
    assert float((emulated.double() - want).abs().max()) <= 1e-5
    # without the bias the answer is another
    assert float((ta.flash_attention_long_plain(q, k, v, 2).double() - want).abs().max()) > 1e-2


def test_wrapper_checks_its_inputs():
    q, k, v, gate, table, _ = _attention_inputs(1, 256, 2, seed=1)
    with pytest.raises(ValueError, match="multiple of block_q"):
        ta.flash_attention_long_relpos(q[:, :200], k[:, :200], v[:, :200], gate, table, 2)
    with pytest.raises(ValueError, match="flat=0"):
        ta.flash_attention_long_relpos(q, k, v, gate, table, 2, flat=0)


# -- weights, JSON, refusals ---------------------------------------------------


def test_convert_round_trip():
    cfg = tcfg.ModelConfig(encoder=tiny_wavlm(), sae=tcfg.SAEConfig(activation_dim=64,
                                                                     dict_size=256, k=16))
    state = Detector(cfg, device="cpu", generator=torch.Generator().manual_seed(2)).state_dict()
    assert not any(k.startswith("encoder.feature_extractor.conv.") and k.endswith(".bias")
                   for k in state)
    out = convert.detector_state_to_reference(state, cfg)
    fs = "ssl_model.model.encoder.layers"
    assert out[f"{fs}.1.self_attn.grep_a"].shape == (1, 4, 1, 1)
    assert f"{fs}.0.self_attn.relative_attention_bias.weight" in out
    assert f"{fs}.1.self_attn.relative_attention_bias.weight" not in out
    assert "ssl_model.model.feature_extractor.conv_layers.0.0.bias" not in out
    back = convert.detector_state_from_reference(out, cfg)
    assert set(back) == set(state)
    pos_conv = "encoder.pos_conv.conv.weight"  # folded in float64 and back
    assert all(torch.equal(back[k], v) for k, v in state.items() if k != pos_conv)


def test_config_json_round_trip():
    exp = tcfg.ExperimentConfig(model=tcfg.ModelConfig(encoder=tiny_wavlm(dtype=torch.bfloat16)))
    d = json.loads(tcfg.config_to_json(exp))
    assert d["model"]["encoder"]["num_buckets"] == 32
    back = tcfg.config_from_dict(tcfg.ExperimentConfig, d)
    assert type(back.model.encoder) is tcfg.WavLMConfig and back == exp
    # an XLS-R dict stays an XLSRConfig
    xlsr = json.loads(tcfg.config_to_json(tcfg.XLSRConfig()))
    plain = tcfg.config_from_dict(tcfg.XLSRConfig, xlsr)
    assert type(plain) is tcfg.XLSRConfig


def test_routes_without_a_bias_refuse_wavlm():
    with pytest.raises(ValueError, match="fused_attention"):
        tiny_wavlm(fused_attention=True)
    with pytest.raises(ValueError, match="sequence-parallel"):
        tiny_wavlm(seq_axis="seq")
    with pytest.raises(ValueError, match="sequence-parallel"):
        sp_model_config(tcfg.ModelConfig(encoder=tiny_wavlm()))
    with pytest.raises(ValueError, match="fused_attention"):
        dataclasses.replace(tiny_wavlm(), fused_attention=True)


# -- on a card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table_of(emb, t, nb, md):
    pos = torch.arange(1 - t, t)
    return emb[relative_position_bucket(pos, nb, md).to(emb.device)].t().contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("t,nb,md,flat", [(2560, 320, 800, 800), (5120, 320, 800, 800),
                                          (5120, 320, 800, None), (256, 32, 64, 64),
                                          (384, 32, 64, 64), (1280, 32, 64, None)],
                         ids=["T2560", "T5120", "T5120_no_flat", "T256_small", "T384_small",
                              "T1280_small_no_flat"])
def test_biased_kernel_matches_plain_and_emulation(cuda, t, nb, md, flat):
    h = 16 if t >= 2560 else 4
    g = torch.Generator(device=cuda).manual_seed(t + nb)
    q, k, v = ((torch.randn(1, t, h * DH, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    gate = 1.0 + torch.rand(1, h, t, generator=g, device=cuda)
    table = _table_of(torch.randn(nb, h, generator=g, device=cuda), t, nb, md)
    before = ta.flash_attention_long_relpos.launches
    out = ta.flash_attention_long_relpos(q, k, v, gate, table, h, flat=flat, block_q=128)
    torch.cuda.synchronize()
    assert ta.flash_attention_long_relpos.launches == before + 1
    plain = ta.flash_attention_long_relpos_plain(q, k, v, gate, table, h)
    emulated = ta.attention_online_emulated(q, k, v, h, gate=gate, table=table)
    for ref_out in (plain, emulated):
        err = (out.float() - ref_out.float()).abs().max()
        assert err <= 1e-2 * ref_out.float().abs().max()
    unbiased = ta.flash_attention_long_plain(q, k, v, h)
    assert float((out.float() - unbiased.float()).abs().max()) > 0.05 * float(
        unbiased.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [2560, 5120])
def test_unbiased_kernel_bit_equal_to_a_zero_bias(cuda, t):
    """``attention_long_kernel`` and the biased kernel share their code:
    at a zero gate the biased form gives the unbiased one's bits."""
    g = torch.Generator(device=cuda).manual_seed(t)
    q, k, v = ((torch.randn(1, t, 16 * DH, generator=g, device=cuda) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    zero = torch.zeros(1, 16, t, device=cuda)
    table = torch.randn(16, 2 * t - 1, generator=g, device=cuda)
    out = ta.flash_attention_long(q, k, v, 16)
    biased = ta.flash_attention_long_relpos(q, k, v, zero, table, 16)
    torch.cuda.synchronize()
    assert torch.equal(out, biased)


@pytest.mark.cuda
def test_fp32_kernel_takes_the_bias(cuda):
    q, k, v, gate, table, _ = _attention_inputs(2, 256, 2, seed=9, device=cuda)
    out = ta.flash_attention_long_relpos(q, k, v, gate, table, 2)
    torch.cuda.synchronize()
    plain = ta.flash_attention_long_relpos_plain(q, k, v, gate, table, 2)
    assert float((out - plain).abs().max()) <= 2e-5


@pytest.mark.cuda
def test_encoder_long_route_on_card_matches_einsum_route(cuda):
    """The tiny bf16 WavLM encoder at T 256 through the biased kernel,
    against the same weights on the einsum route (flash_long_t=0)."""
    cfg = tiny_wavlm(dtype=torch.bfloat16, embed_dim=256, num_heads=4, flash_long_t=256)
    enc = XLSREncoder(cfg, device=cuda)
    init_weights_(enc, torch.Generator(device=cuda).manual_seed(0))
    plain = XLSREncoder(dataclasses.replace(cfg, flash_long_t=0), device=cuda)
    plain.load_state_dict(enc.state_dict())
    wav = torch.randn(1, _samples(cfg, 256), device=cuda) * 0.1
    before = ta.flash_attention_long_relpos.launches
    with torch.inference_mode():
        out, want = enc(wav).float(), plain(wav).float()
    assert ta.flash_attention_long_relpos.launches == before + cfg.encoder_layers
    assert float(torch.linalg.vector_norm(out - want) / torch.linalg.vector_norm(want)) < 1e-2
