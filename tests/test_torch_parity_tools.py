"""The port's parity tools, ``encoder/parity.py`` and
``cli/parity_kit.py``, against the JAX package's (after
``tests/test_parity_kit.py``), at ``tiny_xlsr_config`` width on the CPU.

- ``run_parity`` on a fairseq-named checkpoint written by the test
  (``sls_tpu.encoder.torch_ref.make_fairseq_state``) says ``PARITY OK``
  with max|Δ| <= 1e-4 in fp32; the port's copy of the reference forward
  is the JAX package's, bit for bit; an HF-named checkpoint passes
  against ``transformers``; a weight the converter gets wrong gives
  ``PARITY FAIL`` (exit 1), and ``--format hf`` without ``transformers``
  exits 1 saying so.
- ``infer_architecture`` reads what the reference's reads from the same
  state: per-timestep, window-overlap, window-hard / CPC and SLS, with
  ``use_sparse_features`` either way; ``load_reference_checkpoint`` reads
  a ``.pth`` whose ``args`` is an ``argparse.Namespace``.
- ``cli.parity_kit`` over a directory of WAV files, on a ``.pth`` in the
  reference's naming that carries the JAX package's weights (through the
  port's ``convert.py``), writes the reference kit's score file within
  rtol 1e-5 (``--fp32``), exits 0 against its own scores and 1 against a
  file shifted by 1e-2 (the default tolerance is 2e-3).
"""

import argparse
import json

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.cli import parity_kit
from sls_tpu_torch.encoder import parity
from sls_tpu_torch.scores.writer import read_score_file
from tests.test_torch_cli import _write_wav

WAV_LEN = 1000
DICT, K = 64, 8
PARITY_TOL = 1e-4
SCORE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jcfg():
    from sls_tpu.config import tiny_xlsr_config

    return tiny_xlsr_config()


@pytest.fixture(scope="module")
def fairseq_ckpt(jcfg, tmp_path_factory):
    from sls_tpu.encoder.torch_ref import make_fairseq_state

    state = make_fairseq_state(jcfg, seed=3, weight_scale=0.125)
    path = tmp_path_factory.mktemp("parity") / "fairseq.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    return path, state


def _run(path, capsys, fmt="auto"):
    ok = parity.run_parity(str(path), fmt, None, PARITY_TOL, cfg=tcfg.tiny_xlsr_config(),
                           device=torch.device("cpu"))
    out = capsys.readouterr()
    return ok, out.out, out.err


def _max_diff(out: str) -> float:
    line = next(x for x in out.splitlines() if x.startswith("final max|Δ|"))
    return float(line.split()[2])


def test_fairseq_checkpoint_parity_ok(fairseq_ckpt, capsys):
    path, _ = fairseq_ckpt
    ok, out, _ = _run(path, capsys)
    assert ok and out.splitlines()[-1] == "PARITY OK", out
    assert "(format: fairseq)" in out and "output shape: (1, 49, 64)" in out
    assert _max_diff(out) <= PARITY_TOL
    assert "stage layer_1" in out


def test_reference_forward_is_the_reference_packages(fairseq_ckpt, jcfg):
    from sls_tpu.encoder.torch_ref import torch_reference_forward

    _, state = fairseq_ckpt
    wav = (np.random.default_rng(1).normal(size=(2, WAV_LEN)) * 0.1).astype(np.float32)
    got, stages = parity.reference_forward(state, tcfg.tiny_xlsr_config(), wav,
                                           return_stages=True)
    want, want_stages = torch_reference_forward(state, jcfg, wav, return_stages=True)
    assert list(stages) == list(want_stages)
    for name in stages:
        np.testing.assert_array_equal(stages[name], want_stages[name], err_msg=name)
    np.testing.assert_array_equal(got, want)


def test_a_wrong_weight_fails_parity(fairseq_ckpt, capsys, monkeypatch):
    path, _ = fairseq_ckpt
    convert = parity.fairseq_encoder_to_torch

    def wrong(state, cfg):
        out = convert(state, cfg)
        out["layers.1.fc1.weight"] = out["layers.1.fc1.weight"] * 1.01
        return out

    monkeypatch.setattr(parity, "fairseq_encoder_to_torch", wrong)
    ok, out, _ = _run(path, capsys)
    assert not ok and out.splitlines()[-1] == "PARITY FAIL" and _max_diff(out) > PARITY_TOL


def _hf_model():
    from transformers import Wav2Vec2Config, Wav2Vec2Model

    cfg = tcfg.tiny_xlsr_config()
    torch.manual_seed(0)
    return Wav2Vec2Model(Wav2Vec2Config(
        hidden_size=cfg.embed_dim, num_hidden_layers=cfg.encoder_layers,
        num_attention_heads=cfg.num_heads, intermediate_size=cfg.ffn_dim,
        conv_dim=[c for c, _, _ in cfg.conv_layers],
        conv_kernel=[k for _, k, _ in cfg.conv_layers],
        conv_stride=[s for _, _, s in cfg.conv_layers], conv_bias=cfg.conv_bias,
        num_conv_pos_embeddings=cfg.conv_pos, num_conv_pos_embedding_groups=cfg.conv_pos_groups,
        do_stable_layer_norm=True, feat_extract_norm="layer", apply_spec_augment=False)).eval()


def test_hf_checkpoint_parity_ok(tmp_path, capsys):
    pytest.importorskip("transformers")
    path = tmp_path / "hf.pt"
    torch.save({f"wav2vec2.{k}": v for k, v in _hf_model().state_dict().items()}, path)
    ok, out, _ = _run(path, capsys)
    assert ok and out.splitlines()[-1] == "PARITY OK", out
    assert "(format: hf)" in out and _max_diff(out) <= PARITY_TOL


def test_hf_without_transformers_exits_1(fairseq_ckpt, capsys, monkeypatch):
    path, _ = fairseq_ckpt
    monkeypatch.setitem(__import__("sys").modules, "transformers", None)
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")
    assert parity.main(["--checkpoint", str(path), "--format", "hf"]) == 1
    err = capsys.readouterr().err
    assert "transformers does not import" in err


# -- infer_architecture and the checkpoint loader -------------------------------------


def _inferred(kind, cfg):
    """What ``infer_architecture`` sets, from either package's config."""
    if cfg is None:
        return kind, None
    e, s = cfg.encoder, cfg.sae
    return (kind, (e.encoder_layers, e.embed_dim, e.ffn_dim, e.num_heads),
            (s.activation_dim, s.dict_size, s.k, s.variant, s.window_size),
            cfg.use_sae, cfg.use_sparse_features, cfg.classifier_hidden)


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("args", [{}, {"use_window_topk": True, "sae_window_size": 4},
                                  {"use_cpc": True, "sae_window_size": 6}, None])
def test_infer_architecture_matches_the_reference(jcfg, args, sparse):
    from sls_tpu.cli import parity_kit as jax_kit
    from sls_tpu.encoder.torch_ref import make_detector_state, make_sls_head_state

    if args is None:  # the SLS family: the upstream head beside the encoder
        state = {**{f"ssl_model.model.{k}": v for k, v in make_detector_state(
            jcfg, DICT, K).items() if not k.startswith(("sae.", "classifier."))},
                 **make_sls_head_state(flat_dim=16 * 21, embed_dim=64)}
        meta = {}
    else:
        state = make_detector_state(jcfg, DICT, K, use_sparse_features=sparse)
        meta = {"args": args}
    got = parity_kit.infer_architecture(state, meta)
    want = jax_kit.infer_architecture(state, meta)
    assert _inferred(*got) == _inferred(*want)
    for variant in ("per_timestep", "window_hard"):
        assert (_inferred(*parity_kit.infer_architecture(state, meta, variant, 2))
                == _inferred(*jax_kit.infer_architecture(state, meta, variant, 2)))


def test_load_reference_checkpoint_with_namespace_args(jcfg, tmp_path):
    from sls_tpu.cli import parity_kit as jax_kit
    from sls_tpu.encoder.torch_ref import make_detector_state

    state = make_detector_state(jcfg, DICT, K)
    path = tmp_path / "ns.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.asarray(v))
                          for k, v in state.items()},
                "epoch": 3, "args": argparse.Namespace(use_window_topk=True,
                                                       sae_window_size=4)}, path)
    got, meta = parity_kit.load_reference_checkpoint(str(path))
    want, want_meta = jax_kit.load_reference_checkpoint(str(path))
    assert meta == want_meta == {"epoch": 3, "args": {"use_window_topk": True,
                                                      "sae_window_size": 4}}
    assert set(got) == set(want) == set(state)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert parity_kit.infer_architecture(got, meta)[1].sae.variant == "window_overlap"


def test_diff_scores_misaligned_ids(tmp_path):
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    ours.write_text("".join(f"u{i} {0.1 * i:.6f}\n" for i in range(5)))
    ref.write_text("".join(f"u{i} {0.1 * i:.6f}\n" for i in (3, 5, 1, 4, 2)))
    report = parity_kit.diff_scores(ours, ref, tolerance=1e-6)
    assert report["n_compared"] == 4
    assert report["n_missing_in_ref"] == 1 and report["n_missing_in_ours"] == 1
    assert report["max_abs_diff"] < 1e-12 and report["ok"]
    nothing = tmp_path / "none.txt"
    nothing.write_text("x 0.5\n")
    assert parity_kit.diff_scores(ours, nothing, 1e-3)["ok"] is False


# -- the kit end to end against the reference's -----------------------------------------


@pytest.fixture(scope="module")
def kit(jcfg, tmp_path_factory):
    """A reference-named ``.pth`` of the JAX package's detector weights,
    ten WAV files of varied lengths, and the experiment config."""
    import jax
    import jax.numpy as jnp

    from sls_tpu import config as jc
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu_torch.convert import detector_state_from_flax, detector_state_to_reference

    root = tmp_path_factory.mktemp("parity_kit")
    jmodel = jc.ModelConfig(encoder=jcfg, sae=jc.SAEConfig(activation_dim=64, dict_size=DICT,
                                                           k=K))
    params = JaxDetector(jmodel).init(jax.random.PRNGKey(4),
                                      jnp.zeros((1, WAV_LEN), jnp.float32))["params"]
    pmodel = tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), sae=tcfg.SAEConfig(
        activation_dim=64, dict_size=DICT, k=K))
    ref_state = detector_state_to_reference(detector_state_from_flax(params), pmodel)
    ckpt = root / "best_checkpoint_eer.pth"
    torch.save({"model": ref_state, "epoch": 7,
                "args": {"use_window_topk": False, "sae_window_size": 8}}, ckpt)
    wav_dir = root / "wav"
    rng = np.random.default_rng(23)
    for i in range(10):
        _write_wav(wav_dir / f"UTT_{i:03d}.wav",
                   rng.normal(0, 0.08, int(rng.integers(600, 1600))).astype(np.float32))
    cfg_path = root / "config.json"
    cfg_path.write_text(jc.config_to_json(jc.ExperimentConfig(model=jmodel)))
    return root, ckpt, wav_dir, cfg_path


def _kit_args(kit_, out, *extra):
    _, ckpt, wav_dir, cfg_path = kit_
    return ["--cp_path", str(ckpt), "--wav_dir", str(wav_dir), "--out", str(out),
            "--config_json", str(cfg_path), "--cut_length", str(WAV_LEN), "--batch_size", "4",
            "--fp32", *extra]


def test_kit_matches_the_reference_kit(kit, tmp_path, monkeypatch, capsys):
    from sls_tpu.cli import parity_kit as jax_kit

    ref = tmp_path / "scores_jax.txt"
    assert jax_kit.main(_kit_args(kit, ref)) == 0
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")
    ours = tmp_path / "scores_port.txt"
    assert parity_kit.main(_kit_args(kit, ours)) == 0
    assert "scored 10 utterances" in capsys.readouterr().out
    got_ids, got = read_score_file(ours)
    want_ids, want = read_score_file(ref)
    assert got_ids == want_ids and len(got) == 10
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=0)

    # against its own scores: 0; against a file shifted by 1e-2: 1
    assert parity_kit.main(_kit_args(kit, tmp_path / "again.txt", "--ref_scores",
                                     str(ours))) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert report["ok"] and report["n_compared"] == 10 and report["max_abs_diff"] == 0.0
    shifted = tmp_path / "shifted.txt"
    shifted.write_text("".join(f"{u} {s + 1e-2}\n" for u, s in zip(got_ids, got)))
    assert parity_kit.main(_kit_args(kit, tmp_path / "third.txt", "--ref_scores",
                                     str(shifted))) == 1

