"""The SLS family's weights and runs across packages: an upstream XLS-R +
SLS state dict (``module.`` prefixes, ``first_bn.num_batches_tracked``)
loaded by the port against the same state through the JAX package; the
export back; ``SLSTrainer`` against the JAX ``SLSTrainer`` over one epoch
(CSV row), its own checkpoints and resume, resume from a JAX run
directory and from an upstream ``.pth``; ``build_scorer`` over run
directories of both packages.

Both trainers see the float32 wire (the JAX SLS steps do not decode the
wire; ROADMAP §3).  The JAX trainer's train step is the reference's
computed in two programs (``test_torch_sls.py::jax_sls_step``): its
jitted form gets the head's gradients wrong on XLA:CPU.
"""

import csv
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch import convert as pconv
from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
from sls_tpu_torch.models.sls import SLSTrainer, make_sls_eval_step
from sls_tpu_torch.serve.scorer import build_scorer, load_serving_parts
from sls_tpu_torch.train.loop import CSV_FIELDS
from test_torch_sls import jax_sls_step

WAV_LEN = 1000  # 49 frames through the tiny conv stack: fc1 reads 16 * 21
# batch 8: the JAX trainer pads a batch to its test mesh's 8 devices,
# and the BatchNorm's statistics would see those rows
BATCH, N_TRAIN, N_VAL, LR = 8, 20, 12, 1e-4
LOGP_TOL = 1e-4  # the tiny fp32 encoder and head, sums in other orders
CSV_TOL = 1e-4   # each loss / accuracy field of the CSV row
EER_TOL = 1.0    # percent: one step of a DET curve over 20 or 12 rows is 5-17
ZERO_FIELDS = ("train_cls_loss", "train_sae_loss", "train_cpc_loss", "val_sae_loss")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sls_tpu import config as jcfg
    from sls_tpu.data.pipeline import ArrayLoader as JaxArrayLoader
    from sls_tpu.encoder import convert as jconv
    from sls_tpu.encoder import torch_ref
    from sls_tpu.heads.sls import SLSHead as JaxSLSHead
    from sls_tpu.models import sls as jsls

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, conv=jconv, ref=torch_ref, sls=jsls,
                           SLSHead=JaxSLSHead, ArrayLoader=JaxArrayLoader)


def _cfgs(J, **train):
    train = dict(batch_size=BATCH, lr=LR, num_epochs=1, cut_length=WAV_LEN, **train)
    jexp = J.cfg.ExperimentConfig(
        model=J.cfg.ModelConfig(encoder=J.cfg.tiny_xlsr_config(), use_sae=False),
        train=J.cfg.TrainConfig(rawboost=J.cfg.RawBoostConfig(algo=0), **train))
    pexp = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(), use_sae=False),
        train=tcfg.TrainConfig(rawboost=tcfg.RawBoostConfig(algo=0), **train))
    return jexp, pexp


def _data(seed, n):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n)
    wavs = rng.normal(0, 0.05, size=(n, WAV_LEN)).astype(np.float32)
    wavs[labels == 1] += 0.3 * np.sin(2 * np.pi * 440 * np.arange(WAV_LEN) / 16000.0
                                      ).astype(np.float32)
    return to_wire(wavs, "float32"), labels


TRAIN, VAL = _data(0, N_TRAIN), _data(1, N_VAL)


def _upstream(J, prefix="module."):
    """An upstream-named XLS-R + SLS state dict (numpy), as the upstream
    ``torch.save(model.state_dict())`` of a DataParallel model holds it."""
    enc_cfg = J.cfg.tiny_xlsr_config()
    frames = tcfg.tiny_xlsr_config().num_frames(WAV_LEN)
    enc = J.ref.make_fairseq_state(enc_cfg, seed=0)
    head = J.ref.make_sls_head_state(seed=1, flat_dim=(frames // 3) * (enc_cfg.embed_dim // 3),
                                     embed_dim=enc_cfg.embed_dim)
    full = {f"ssl_model.model.{k}": v for k, v in enc.items()}
    full.update(head)
    return {prefix + k: v for k, v in full.items()}


def _wav(seed=3, n=BATCH):
    return np.random.default_rng(seed).normal(0, 0.3, (n, WAV_LEN)).astype(np.float32)


def test_upstream_state_dict_matches_jax(J):
    jexp, pexp = _cfgs(J)
    full = _upstream(J)
    assert "module.first_bn.num_batches_tracked" in full
    state = pconv.sls_detector_state_from_reference(full, pexp.model)
    assert not any("num_batches_tracked" in k for k in state)
    from sls_tpu_torch.models.sls import SLSDetector

    model = SLSDetector(pexp.model, device="cpu", cut_length=WAV_LEN)
    model.load_state_dict(state, strict=True)
    for key in ("fc1.weight", "first_bn.running_var", "fc0.bias"):
        assert np.array_equal(state[f"sls_head.{key}"].numpy(), full[f"module.{key}"])
    variables = J.conv.sls_detector_state_to_flax(full, jexp.model)
    wav = _wav()
    want = J.sls.make_sls_eval_step(J.sls.SLSDetector(jexp.model))(
        variables["params"], variables["batch_stats"], J.jnp.asarray(wav))
    got = make_sls_eval_step(model, device="cpu")(wav)
    np.testing.assert_allclose(got["log_probs"].numpy(), np.asarray(want["log_probs"]),
                               atol=LOGP_TOL, rtol=0)


def test_upstream_loader_refuses_unknown_head_entries(J):
    _, pexp = _cfgs(J)
    full = _upstream(J, prefix="")
    pconv.sls_detector_state_from_reference(
        {k: v for k, v in full.items() if "num_batches_tracked" not in k}, pexp.model)
    with pytest.raises(ValueError, match="fc2.weight"):
        pconv.sls_detector_state_from_reference({**full, "fc2.weight": full["fc3.weight"]},
                                                pexp.model)
    with pytest.raises(KeyError):
        pconv.sls_detector_state_from_reference(
            {k: v for k, v in full.items() if k != "first_bn.running_var"}, pexp.model)


def test_export_round_trip(J):
    _, pexp = _cfgs(J)
    state = pconv.sls_detector_state_from_reference(_upstream(J), pexp.model)
    out = pconv.sls_detector_state_to_reference(state, pexp.model, num_batches_tracked=7)
    assert int(out["first_bn.num_batches_tracked"]) == 7
    back = pconv.sls_detector_state_from_reference(out, pexp.model)
    assert back.keys() == state.keys()
    pos = "encoder.pos_conv.conv.weight"
    for k in state:
        if k == pos:  # through weight norm: g * v / ||v||
            assert float((back[k] - state[k]).norm() / state[k].norm()) <= 1e-6
        else:
            assert torch.equal(back[k], state[k]), k


# -- trainers ------------------------------------------------------------------------


def _rows(run_dir):
    with open(run_dir / "training_log.csv") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def fits(J, tmp_path_factory):
    """Both trainers fit one epoch from the JAX trainer's initial weights:
    (JAX run dir, port run dir, JAX trainer, port trainer)."""
    jexp, pexp = _cfgs(J)
    jdir, pdir = tmp_path_factory.mktemp("jax_sls"), tmp_path_factory.mktemp("port_sls")
    jt = J.sls.SLSTrainer(jexp, jdir, tensorboard=False)
    jt.init_state(np.zeros((2, WAV_LEN), np.float32))
    split = jax_sls_step(J, jexp)
    jt.train_step = lambda state, wav, labels, valid, rng: split(state, wav, labels, valid)
    start = pconv.sls_detector_state_from_flax(J.jax.device_get(jt.state.params),
                                               J.jax.device_get(jt.state.batch_stats))
    pt = SLSTrainer(pexp, pdir, tensorboard=False, device="cpu")
    pt.model.load_state_dict(start, strict=True)
    pt.init_state()
    jt.fit(J.ArrayLoader(*TRAIN, batch_size=BATCH, shuffle=True),
           J.ArrayLoader(*VAL, batch_size=BATCH))
    pt.fit(ArrayLoader(*TRAIN, batch_size=BATCH, shuffle=True),
           ArrayLoader(*VAL, batch_size=BATCH))
    return jdir, pdir, jt, pt


def test_csv_row_matches_the_jax_sls_trainer(fits):
    jdir, pdir, _, _ = fits
    (jrow,), (prow,) = _rows(jdir), _rows(pdir)
    assert list(prow) == CSV_FIELDS
    for key in ZERO_FIELDS:  # the JAX fold's missing keys, and the port's zeros
        assert float(jrow[key]) == float(prow[key]) == 0.0, key
    for key in ("train_loss", "train_acc", "val_loss", "val_acc"):
        assert float(prow[key]) == pytest.approx(float(jrow[key]), abs=CSV_TOL), key
    for key in ("train_eer", "val_eer"):
        assert abs(float(prow[key]) - float(jrow[key])) <= EER_TOL, key
    assert float(prow["train_loss"]) > 0


def test_own_checkpoints_and_resume_bit_equal(J, fits, tmp_path):
    _, pdir, _, pt = fits
    assert (pdir / "last.ckpt").exists() and (pdir / "best.ckpt").exists()
    _, pexp = _cfgs(J, seed=99)
    fresh = SLSTrainer(pexp, tmp_path / "b", tensorboard=False, device="cpu")
    fresh.init_state()
    assert not torch.equal(fresh.model.sls_head.fc1.weight, pt.model.sls_head.fc1.weight)
    assert fresh.resume(pdir / "last.ckpt") and fresh.start_epoch == 1
    got, want = fresh.model.state_dict(), pt.model.state_dict()
    assert "sls_head.first_bn.running_mean" in want
    assert float(want["sls_head.first_bn.running_var"]) != 1.0  # the epoch moved it
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(fresh.state.exp_avg, pt.state.exp_avg)
    assert torch.equal(fresh.state.exp_avg_sq, pt.state.exp_avg_sq)
    assert int(fresh.state.step) == int(pt.state.step) == 3 and fresh.state.calls == 3


def test_resume_from_a_jax_run_directory(J, fits, tmp_path):
    jdir, _, jt, _ = fits
    _, pexp = _cfgs(J)
    pt = SLSTrainer(pexp, tmp_path / "c", tensorboard=False, device="cpu")
    pt.init_state()
    assert pt.resume(jdir / "last.ckpt") and pt.start_epoch == 1
    want = pconv.sls_detector_state_from_flax(J.jax.device_get(jt.state.params),
                                              J.jax.device_get(jt.state.batch_stats))
    got = pt.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k].reshape(got[k].shape)) for k in want)
    assert int(pt.state.step) == int(jt.state.step) == pt.state.calls
    mu = pt.state.moments("sls_head.fc1.weight")[0]
    opt = J.jax.device_get(jt.state.opt_state)
    jmu = next(s.mu for s in opt if hasattr(s, "mu"))["sls_head"]["fc1"]["kernel"]
    assert torch.equal(mu, torch.from_numpy(np.array(jmu)).t())


def test_resume_from_an_upstream_pth(J, tmp_path):
    _, pexp = _cfgs(J)
    full = _upstream(J)
    pth = tmp_path / "epoch_5.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in full.items()}, pth)
    pt = SLSTrainer(pexp, tmp_path / "d", tensorboard=False, device="cpu")
    pt.init_state()
    assert pt.resume(str(pth)) and pt.start_epoch == 6
    want = pconv.sls_detector_state_from_reference(full, pexp.model)
    got = pt.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert int(pt.state.step) == 0


def test_model_parallel_raises(J, tmp_path):
    _, pexp = _cfgs(J, model_parallel=2)
    with pytest.raises(ValueError, match="model_parallel"):
        SLSTrainer(pexp, tmp_path / "e", tensorboard=False, device="cpu")


def test_build_scorer_serves_both_packages(J, fits):
    jdir, pdir, jt, pt = fits
    wav = _wav(seed=4)
    for run_dir, want in (
            (pdir, make_sls_eval_step(pt.model, device="cpu")(wav)["log_probs"]),
            (jdir, torch.from_numpy(np.array(J.sls.make_sls_eval_step(jt.model)(
                jt.state.params, jt.state.batch_stats, J.jnp.asarray(wav))["log_probs"])))):
        cfg, params = load_serving_parts(run_dir)
        assert "sls_head.first_bn.running_var" in params
        cfg, score_fn, cut = build_scorer(run_dir, batch_size=BATCH, device="cpu")
        assert cut == WAV_LEN and not cfg.model.use_sae
        got = score_fn(wav)
        if run_dir == pdir:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=LOGP_TOL, rtol=0)
