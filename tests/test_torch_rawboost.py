"""The port's RawBoost (``sls_tpu_torch/augment/rawboost.py``) against the
JAX package's and scipy.

The deterministic parts (band-stop design, truncated convolution, freqz
peak, FIR filtering with the group-delay trim, peak normalisation) are
held to the JAX functions on the same inputs within ``REL`` of the
reference's largest value; the cascades and the three primitives built
from given draws are held to the same composition of the JAX functions,
and the cascade to scipy's ``firwin`` / ``freqz``.  The random streams
differ from ``jax.random``'s, so the composed algorithms are held
statistically, as ``tests/test_rawboost.py`` holds the reference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import sls_tpu.augment.rawboost as jrb
from sls_tpu.config import RawBoostConfig as JaxRawBoostConfig
from sls_tpu_torch.augment import rawboost as rb
from sls_tpu_torch.config import RawBoostConfig

FS = 16000.0
CFG = RawBoostConfig()
JCFG = JaxRawBoostConfig()
REL = 1e-5  # of max|reference|: fp32, FFT sums against direct ones


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_close(ours, ref, rel=REL):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    err = float(np.max(np.abs(ours - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), (err, float(np.max(np.abs(ref))))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# -- deterministic parts against the JAX functions -----------------------------------


FIRWIN_CASES = [(11, 100.0, 900.0), (51, 500.0, 2500.0), (99, 20.0, 7900.0),
                (21, 1000.0, 1100.0), (101, 7000.0, 7999.0)]


@pytest.mark.parametrize("c,f1,f2", FIRWIN_CASES)
def test_firwin_matches_jax_and_scipy(c, f1, f2):
    ours = rb.firwin_bandstop(torch.tensor(c), torch.tensor(f1), torch.tensor(f2), FS, 102)
    ref = jrb.firwin_bandstop(jnp.asarray(c), jnp.asarray(f1), jnp.asarray(f2), FS, max_taps=102)
    _assert_close(ours, ref)
    assert torch.all(ours[c:] == 0)
    np.testing.assert_allclose(ours[:c].numpy(),
                               signal.firwin(c, [f1, f2], window="hamming", fs=FS), atol=1e-6)


def test_firwin_batched_rows_are_independent():
    c = torch.tensor([[11, 51], [99, 21]])
    f1 = torch.tensor([[100.0, 500.0], [20.0, 1000.0]])
    f2 = torch.tensor([[900.0, 2500.0], [7900.0, 1100.0]])
    ours = rb.firwin_bandstop(c, f1, f2, FS, 102)
    assert ours.shape == (2, 2, 102)
    for i in range(2):
        for j in range(2):
            ref = jrb.firwin_bandstop(jnp.asarray(int(c[i, j])), jnp.asarray(float(f1[i, j])),
                                      jnp.asarray(float(f2[i, j])), FS, max_taps=102)
            _assert_close(ours[i, j], ref)


@pytest.mark.parametrize("la,lb,out_len", [(102, 506, 506), (7, 5, 11), (101, 1, 101)])
def test_convolve_trunc_matches_jax(la, lb, out_len):
    rng = np.random.default_rng(la + lb)
    a = rng.normal(size=la).astype(np.float32)
    b = rng.normal(size=lb).astype(np.float32)
    ref = jrb._convolve_trunc(jnp.asarray(a), jnp.asarray(b), out_len)
    _assert_close(rb._convolve_trunc(torch.from_numpy(a), torch.from_numpy(b), out_len), ref)


@pytest.mark.parametrize("support", [1, 77, 300, 506])
def test_freqz_peak_matches_jax_and_scipy(support):
    rng = np.random.default_rng(support)
    taps = np.zeros(506, np.float32)
    taps[:support] = rng.normal(size=support).astype(np.float32)
    ours = rb._freqz_peak(torch.from_numpy(taps))
    _assert_close(ours, jrb._freqz_peak(jnp.asarray(taps)))
    _, h = signal.freqz(taps[:support].astype(np.float64), 1, fs=FS)
    assert float(ours) == pytest.approx(float(np.max(np.abs(h))), rel=1e-5)


@pytest.mark.parametrize("length", [1, 31, 255, 506])
def test_filter_fir_matches_jax(length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=4000).astype(np.float32)
    b = np.zeros(506, np.float32)
    b[:length] = rng.normal(size=length).astype(np.float32)
    ref = jrb.filter_fir(jnp.asarray(x), jnp.asarray(b), jnp.asarray(length))
    ours = rb.filter_fir(torch.from_numpy(x), torch.from_numpy(b), torch.tensor(length))
    _assert_close(ours, ref)


def test_filter_fir_rows_keep_their_own_trim():
    """One FFT over rows of different filter lengths: each row is the
    JAX function's output for that row alone."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 2000)).astype(np.float32)
    lengths = np.array([5, 200, 506])
    b = np.zeros((3, 506), np.float32)
    for i, n in enumerate(lengths):
        b[i, :n] = rng.normal(size=n)
    ours = rb.filter_fir(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(lengths))
    for i, n in enumerate(lengths):
        _assert_close(ours[i], jrb.filter_fir(jnp.asarray(x[i]), jnp.asarray(b[i]),
                                              jnp.asarray(int(n))))


@pytest.mark.parametrize("always", [False, True])
@pytest.mark.parametrize("peak", [0.5, 2.0])
def test_norm_wav_matches_jax(always, peak):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=100).astype(np.float32)
    x *= peak / np.abs(x).max()
    _assert_close(rb.norm_wav(torch.from_numpy(x), always),
                  jrb.norm_wav(jnp.asarray(x), always))


def test_filter_sizes_raise_beyond_the_freqz_grid():
    assert rb._filter_sizes(CFG) == jrb._filter_sizes(JCFG) == (102, 506)
    with pytest.raises(ValueError, match="512"):
        rb._filter_sizes(dataclasses.replace(CFG, nBands=6))


# -- cascades and primitives from given draws ------------------------------------------


def _jax_cascade(draw: rb.NotchDraw, row, cfg=CFG):
    """``gen_notch_coeffs``'s arithmetic from given draws, through the
    JAX package's own functions: (taps [max_total], length)."""
    max_taps, max_total = jrb._filter_sizes(cfg)
    b = jnp.zeros(max_total, jnp.float32).at[0].set(1.0)
    length = 1
    for i in range(cfg.nBands):
        fc, bw, c = (float(draw.fc[row][i]), float(draw.bw[row][i]), int(draw.c[row][i]))
        f1 = jnp.maximum(jnp.float32(fc - bw / 2.0), 1.0 / 1000.0)
        f2 = jnp.minimum(jnp.float32(fc + bw / 2.0), FS / 2.0 - 1.0 / 1000.0)
        taps = jrb.firwin_bandstop(jnp.asarray(c), f1, f2, FS, max_taps)
        b = jrb._convolve_trunc(taps, b, max_total)
        length += c - 1
    gain = float(draw.gain_db[row])
    return (10.0 ** (gain / 20.0)) * b / jrb._freqz_peak(b), length


def _scipy_cascade(draw: rb.NotchDraw, row, cfg=CFG):
    """The reference's ``genNotchCoeffs`` in float64 with scipy."""
    b = np.ones(1)
    for i in range(cfg.nBands):
        fc, bw, c = (float(draw.fc[row][i]), float(draw.bw[row][i]), int(draw.c[row][i]))
        f1, f2 = max(fc - bw / 2.0, 1.0 / 1000.0), min(fc + bw / 2.0, FS / 2.0 - 1.0 / 1000.0)
        b = np.convolve(signal.firwin(c, [f1, f2], window="hamming", fs=FS), b)
    _, h = signal.freqz(b, 1, fs=FS)
    return 10.0 ** (float(draw.gain_db[row]) / 20.0) * b / np.max(np.abs(h))


def test_notch_draws_lie_in_range():
    d = rb.draw_notch(_gen(), (64,), CFG)
    assert d.fc.shape == d.bw.shape == d.c.shape == (64, CFG.nBands) and d.gain_db.shape == (64,)
    assert torch.all((d.c % 2 == 1) & (d.c >= CFG.minCoeff) & (d.c <= CFG.maxCoeff + 1))
    assert torch.all((d.fc >= CFG.minF) & (d.fc < CFG.maxF))
    assert torch.all((d.bw >= CFG.minBW) & (d.bw < CFG.maxBW))


def test_cascade_matches_jax_and_scipy():
    cfg = dataclasses.replace(CFG, minG=-3, maxG=6)
    draw = rb.draw_notch(_gen(1), (4,), cfg)
    max_taps, max_total = rb._filter_sizes(cfg)
    b, length = rb.notch_coeffs(draw, cfg, FS, max_taps, max_total)
    b64, length64 = rb.notch_coeffs(draw.to("cpu", torch.float64), cfg, FS, max_taps, max_total)
    assert torch.equal(length, length64)
    for row in range(4):
        ref, ref_len = _jax_cascade(draw, row, cfg)
        assert int(length[row]) == ref_len
        _assert_close(b[row], ref)
        want = _scipy_cascade(draw, row, cfg)
        assert np.all(b64[row, ref_len:].abs().numpy() < 1e-15)
        _assert_close(b64[row, :ref_len], want, rel=1e-12)


def test_apply_ssi_matches_jax_composition():
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 0.1, (3, 3000)).astype(np.float32))
    draw = rb.draw_ssi(_gen(2), x.shape, CFG)
    ours = rb.apply_ssi(x, draw, CFG, FS)
    for row in range(3):
        b, length = _jax_cascade(draw.notch, row)
        noise = jrb.filter_fir(jnp.asarray(draw.noise[row].numpy()), b, jnp.asarray(length))
        noise = jrb.norm_wav(noise, always=True)
        xr = jnp.asarray(x[row].numpy())
        snr = float(draw.snr[row])
        ref = xr + noise / jnp.linalg.norm(noise) * jnp.linalg.norm(xr) / (10.0 ** (0.05 * snr))
        _assert_close(ours[row], ref)


def test_apply_lnl_matches_jax_composition():
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 0.3, (2, 3000)).astype(np.float32))
    draw = rb.draw_lnl(_gen(3), x.shape[:-1], CFG)
    assert draw.gain_db.shape == (2, CFG.N_f)
    # the first filter at the config's gain (0 dB), the others lowered
    assert torch.all(draw.gain_db[:, 0] == 0)
    assert torch.all(draw.gain_db[:, 1:] <= -CFG.minBiasLinNonLin)
    ours = rb.apply_lnl(x, draw, CFG, FS)
    for row in range(2):
        xr = jnp.asarray(x[row].numpy())
        y = jnp.zeros_like(xr)
        for i in range(CFG.N_f):
            sub = rb.NotchDraw(draw.fc[row], draw.bw[row], draw.c[row], draw.gain_db[row])
            b, length = _jax_cascade(sub, i)
            y = y + jrb.filter_fir(jnp.power(xr, i + 1), b, jnp.asarray(length))
        _assert_close(ours[row], jrb.norm_wav(y - jnp.mean(y), always=False))


def test_apply_isd_matches_its_definition():
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 0.1, (2, 5000)).astype(np.float32))
    draw = rb.draw_isd(_gen(4), x.shape, CFG)
    ours = rb.apply_isd(x, draw, CFG).numpy()
    for row in range(2):
        n = int(np.float32(5000) * draw.beta[row].numpy() / np.float32(100.0))
        picked = np.argsort(draw.z[row].numpy())[:n]  # the n smallest uniforms
        f_r = (2 * draw.u1[row].numpy() - 1) * (2 * draw.u2[row].numpy() - 1)
        want = x[row].numpy().copy()
        want[picked] += CFG.g_sd * want[picked] * f_r[picked]
        np.testing.assert_allclose(ours[row], want, rtol=1e-6, atol=1e-8)
        assert (ours[row] != x[row].numpy()).sum() <= n


# -- the composed algorithms, statistically -----------------------------------------------


def test_isd_modified_fraction_and_determinism():
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.1, (8, 20000)).astype(np.float32))
    y = rb.isd_additive_noise(_gen(0), x, CFG)
    changed = (y != x).float().mean(-1)
    assert torch.all(changed <= CFG.P / 100.0)
    assert 0.01 < float(changed.mean()) < 0.10  # beta ~ U(0, P): about P / 200
    assert torch.equal(y, rb.isd_additive_noise(_gen(0), x, CFG))
    assert not torch.equal(y, rb.isd_additive_noise(_gen(1), x, CFG))


def test_ssi_snr_in_configured_range():
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (6, 16000)).astype(np.float32))
    y = rb.ssi_additive_noise(_gen(0), x, CFG, FS)
    snr = 20 * torch.log10(x.norm(dim=-1) / (y - x).norm(dim=-1))
    assert torch.all((snr >= CFG.SNRmin - 1e-3) & (snr <= CFG.SNRmax + 1e-3)), snr
    assert float(snr.max() - snr.min()) > 1.0  # each row its own SNR


def test_lnl_output_properties():
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 0.1, (3, 8000)).astype(np.float32))
    y = rb.lnl_convolutive_noise(_gen(0), x, CFG, FS)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert float(y.mean(-1).abs().max()) < 1e-4  # mean removed
    assert float(y.abs().max()) <= 1.0 + 1e-5  # peak-bounded
    assert float(y.std()) > 1e-4 and not torch.allclose(y, x)


@pytest.mark.parametrize("algo", range(10))
def test_every_algorithm_runs_on_a_batch(algo):
    cfg = dataclasses.replace(CFG, algo=algo)
    wavs = np.random.default_rng(5).normal(0, 0.1, (4, 4000)).astype(np.float32)
    out = rb.rawboost_batch(_gen(0), wavs, cfg, device="cpu")
    assert out.shape == wavs.shape and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    if algo in (0, 9):  # 0 or any other value: no augmentation
        assert torch.equal(out, torch.from_numpy(wavs))
        return
    assert not torch.equal(out, torch.from_numpy(wavs))
    assert torch.equal(out, rb.rawboost_batch(_gen(0), wavs, cfg, device="cpu"))
    # the same audio in every row is augmented differently in each
    same = np.repeat(wavs[:1], 4, axis=0)
    out2 = rb.rawboost_batch(_gen(1), same, cfg, device="cpu")
    assert not torch.allclose(out2[0], out2[1])


def test_rawboost_batch_runs_on_the_card_unless_asked():
    wavs = np.zeros((2, 1000), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rb.rawboost_batch(_gen(), wavs, CFG)
    assert rb.rawboost_batch(_gen(), wavs, CFG, device="cpu").device.type == "cpu"
