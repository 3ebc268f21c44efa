"""The port's sequence-parallel scoring against the JAX package and against
its own single-process program, on shared weights.

One job of four gloo ranks on the CPU (``parallel/launch.py``, spawned
once for the whole file) runs every sequence-parallel case: the tiny
Detector on ``sp4`` and ``dp2 x sp2`` meshes, unwindowed scoring with
``sp_mesh``, the window SAE variants and int8 serving under SP, the
kernel-7 gate, and ``sp_flash_attention_long`` on its own.  The JAX side
runs single-device and on the 8-device CPU mesh of ``tests/conftest.py``;
its Pallas kernel runs in interpret mode.  On the CPU the port's kernel-7
wrapper takes its plain version, whose calls the ranks count.

The JAX side is imported inside fixtures, so that on a machine with cards
and no JAX the CUDA tests still run:
``python -m pytest --noconftest -m cuda tests/test_torch_sequence_parallel.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as tcfg
from sls_tpu_torch.evaluation.overlap import length_buckets
from sls_tpu_torch.kernels import attention as ta
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.parallel import sequence as tseq
from sls_tpu_torch.parallel import workers
from sls_tpu_torch.parallel.launch import launch
from sls_tpu_torch.parallel.mesh import make_mesh

WAV_LEN = 1000  # 49 frames with the tiny conv stack: ragged over four ranks
TOL = 2e-5      # the reference's own sequence-parallel tolerance (fp32, sums reordered)
RANKS = 4
MESHES = [(4, 1), (2, 2)]  # (n_seq, n_data): sp4 and dp2 x sp2
ATTN = dict(B=2, T=512, H=4, C=256)
ATTN_BF16_REL_TOL = 1e-2  # of max|ref|: p rounded to bf16 on either side of a near-tie


def _port_config(**enc):
    return tcfg.ModelConfig(encoder=tcfg.tiny_xlsr_config(**enc),
                            sae=tcfg.SAEConfig(activation_dim=64, dict_size=256, k=32),
                            classifier_hidden=32)


def _with_sae(cfg, **sae):
    return dataclasses.replace(cfg, sae=dataclasses.replace(cfg.sae, **sae))


# the port's configurations, by the name the jobs use
CONFIGS = {
    "base": _port_config(),
    "flash256": _port_config(flash_long_t=256),
    "window_overlap": _with_sae(_port_config(), variant="window_overlap", window_size=4),
    "window_hard": _with_sae(_port_config(), variant="window_hard", window_size=4),
    "int8": _port_config(int8_serving=True),
}
MODEL_INDEX = {name: i for i, name in enumerate(CONFIGS)}


def _samples(t_frames):
    return length_buckets(tcfg.tiny_xlsr_config(), t_targets=(t_frames,))[t_frames]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    wav = rng.normal(size=(2, WAV_LEN)).astype(np.float32)
    clip_rng = np.random.default_rng(5)  # the clips of tests/test_sequence_parallel.py
    clips = [("short", clip_rng.normal(0, 0.1, 800).astype(np.float32)),
             ("long", clip_rng.normal(0, 0.1, 7000).astype(np.float32))]
    long_rng = np.random.default_rng(2)
    qkv = np.random.default_rng(7).normal(
        0, 0.5, (3, ATTN["B"], ATTN["T"], ATTN["C"])).astype(np.float32)
    return {"wav": wav, "clips": clips, "qkv": qkv,
            "wav512": long_rng.normal(0, 0.1, (3, _samples(512))).astype(np.float32),
            "wav384": long_rng.normal(0, 0.1, (2, _samples(384))).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_side(inputs):
    """The JAX tiny Detector's params (perturbed so that no bias or norm
    is trivial), its single-device and sp4 scores, its scores through
    kernel 7 (``flash_long_t=256`` at T 512) on both meshes, and its state
    dict for the port."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from sls_tpu.evaluation.overlap import score_utterances_unwindowed
    from sls_tpu.kernels.flash_attention import sp_flash_attention_long
    from sls_tpu.models.detector import Detector as JaxDetector
    from sls_tpu.parallel.sequence import sp_mesh, sp_model_config, sp_scoring_fn
    from sls_tpu_torch.convert import detector_state_from_flax
    from tests.test_detector_train import tiny_model_config

    cfg = tiny_model_config()
    wav = jnp.asarray(inputs["wav"])
    model = JaxDetector(cfg)
    params = model.init(jax.random.PRNGKey(0), wav[:1], train=False)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape).astype(np.float32), params)
    single = model.apply({"params": params}, wav, train=False)
    mesh = sp_mesh(RANKS, jax.devices()[:RANKS])
    sp4 = sp_scoring_fn(JaxDetector(sp_model_config(cfg)), mesh)(params, wav)
    unwindowed = list(score_utterances_unwindowed(
        model, params, iter(inputs["clips"]), cfg.encoder, t_targets=(64, 128)))
    # the kernel-7 route of the whole detector: T 512 >= flash_long_t, strips
    # of 128 on sp4 and of 256 (one row a data coordinate) on dp2 x sp2
    flash = JaxDetector(sp_model_config(dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, flash_long_t=256))))
    wav512 = jnp.asarray(inputs["wav512"][:2])
    flash256 = [np.asarray(sp_scoring_fn(flash, m)(params, wav512)) for m in (
        mesh, sp_mesh(2, jax.devices()[:RANKS], n_data=2))]
    attn = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v = (jnp.asarray(x, getattr(jnp, dtype)) for x in inputs["qkv"])
        with jax.sharding.set_mesh(mesh):
            attn[dtype] = np.asarray(sp_flash_attention_long(
                q, k, v, num_heads=ATTN["H"], seq_axis="seq", interpret=True), np.float32)
    return {"state": {k: v.numpy().copy() for k, v in
                      detector_state_from_flax(params).items()},
            "single": np.asarray(single["score"]), "sae_loss": float(single["sae_loss"]),
            "sp4": np.asarray(sp4), "unwindowed": unwindowed, "attention": attn,
            "flash256": flash256}


JOBS = {  # name -> job; "model" is a key of CONFIGS, "mesh" an index into MESHES
    "sp4": dict(kind="forward", model="base", mesh=0, wav="wav"),
    "dp2xsp2": dict(kind="forward", model="base", mesh=1, wav="wav"),
    "unwindowed": dict(kind="unwindowed", model="base", mesh=0, clips="clips",
                       t_targets=(64, 128)),
    # T 512 over four ranks: strips of 128, the kernel route
    "gate_kernel": dict(kind="forward", model="flash256", mesh=0, wav="wav512", rows=2),
    # T 384 over four ranks: strips of 96, no q-block of 128 divides them
    "gate_ragged": dict(kind="forward", model="flash256", mesh=0, wav="wav384", rows=2),
    # dp2 x sp2: two rows divide the data axis (strips of 256), three do not
    "gate_rows_divide": dict(kind="forward", model="flash256", mesh=1, wav="wav512", rows=2),
    "gate_rows_ragged": dict(kind="forward", model="flash256", mesh=1, wav="wav512", rows=3),
    "window_overlap": dict(kind="forward", model="window_overlap", mesh=0, wav="wav"),
    "window_hard": dict(kind="forward", model="window_hard", mesh=1, wav="wav"),
    "int8": dict(kind="forward", model="int8", mesh=0, wav="wav"),
    "attention_float32": dict(kind="attention", mesh=0, dtype="float32"),
    "attention_bfloat16": dict(kind="attention", mesh=0, dtype="bfloat16"),
}


def _resolve(job, inputs):
    job = dict(job, model=MODEL_INDEX[job.get("model", "base")])
    if job["kind"] == "forward":
        job["wav"] = inputs[job["wav"]][:job.pop("rows", None)]
    elif job["kind"] == "unwindowed":
        job["clips"] = inputs[job["clips"]]
    else:
        job.update(zip("qkv", inputs["qkv"]), num_heads=ATTN["H"])
    return job


@pytest.fixture(scope="module")
def sp_run(inputs, jax_side):
    """Every job of ``JOBS`` on four ranks: {name: [one result a rank]}."""
    models = [(tseq.sp_model_config(cfg), {"state": jax_side["state"]})
              for cfg in CONFIGS.values()]
    jobs = [_resolve(job, inputs) for job in JOBS.values()]
    ranks = launch(workers.sp_score_rank, RANKS, (models, "cpu", MESHES, jobs),
                   device_type="cpu", timeout_s=240)
    return {name: [rank[i] for rank in ranks] for i, name in enumerate(JOBS)}


def _single_process(name, state, wav):
    """The port's single-process forward of ``CONFIGS[name]``."""
    model = Detector(CONFIGS[name], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(wav))


def _scores(result):
    return np.exp(result["log_probs"][:, 1])


@pytest.mark.parametrize("job", ["sp4", "dp2xsp2"])
def test_sp_scores_match_jax(job, sp_run, jax_side):
    """The port's sequence-parallel scores on every rank against the JAX
    single-device program and the JAX sp_mesh(4) program."""
    for rank in sp_run[job]:
        np.testing.assert_allclose(_scores(rank), jax_side["single"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_scores(rank), jax_side["sp4"], rtol=TOL, atol=TOL)
        assert rank["log_probs"].shape == (2, 2)
        assert rank["sae_loss"] == pytest.approx(jax_side["sae_loss"], rel=1e-4)
        assert rank["sp_calls"] == 0  # T 49 is below flash_long_t


def test_every_rank_returns_the_same_log_probs(sp_run):
    for name, ranks in sp_run.items():
        if "log_probs" in ranks[0]:
            for rank in ranks[1:]:
                np.testing.assert_array_equal(rank["log_probs"], ranks[0]["log_probs"], name)


def test_unwindowed_scoring_with_sp_mesh_matches_jax(sp_run, jax_side):
    ref = jax_side["unwindowed"]
    for rank in sp_run["unwindowed"]:
        got = rank["scores"]
        assert [(u, t) for u, _, t in got] == [(u, t) for u, _, t in ref] == [
            ("short", 64), ("long", 128)]
        for (_, s_got, _), (_, s_ref, _) in zip(got, ref):
            assert s_got == pytest.approx(s_ref, abs=TOL)


@pytest.mark.parametrize("job, calls", [("gate_kernel", 2), ("gate_ragged", 0),
                                        ("gate_rows_divide", 2), ("gate_rows_ragged", 0)])
def test_kernel_7_gate(job, calls, sp_run, jax_side, inputs):
    """At T >= flash_long_t the sharded attention takes kernel 7 (on the
    CPU its plain version, counted: once a layer) exactly where the
    reference's gate holds, else the einsum route; either way the scores
    are the single-process ones, and on the kernel route also those of
    the JAX program through its kernel 7 on the same mesh."""
    spec = JOBS[job]
    ref = _single_process("flash256", jax_side["state"], inputs[spec["wav"]][:spec["rows"]])
    for rank in sp_run[job]:
        assert rank["sp_calls"] == calls
        if calls:
            np.testing.assert_allclose(_scores(rank), jax_side["flash256"][spec["mesh"]],
                                       rtol=TOL, atol=TOL)
        assert rank["launches"]["sp_flash_attention_long"] == 0  # no card here
        np.testing.assert_allclose(rank["log_probs"], ref["log_probs"].numpy(),
                                   rtol=TOL, atol=TOL)
        assert rank["sae_loss"] == pytest.approx(float(ref["sae_loss"]), rel=1e-4)


@pytest.mark.parametrize("job", ["window_overlap", "window_hard", "int8"])
def test_sp_composes_with_sae_variants_and_int8(job, sp_run, jax_side, inputs):
    """The window rules reduce over frames (the port gathers them first)
    and int8 quantises per frame: under SP both must give the port's
    single-process scores."""
    ref = _single_process(job, jax_side["state"], inputs["wav"])
    for rank in sp_run[job]:
        np.testing.assert_allclose(_scores(rank), ref["score"].numpy(), rtol=TOL, atol=TOL)
        assert rank["sae_loss"] == pytest.approx(float(ref["sae_loss"]), rel=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_flash_attention_long_plain_matches_pallas(dtype, sp_run, jax_side):
    """Four ranks' strips through the port's wrapper (plain version, k and
    v gathered over the group) against the JAX wrapper on its four-device
    mesh with the Pallas kernel in interpret mode."""
    out, ref = sp_run[f"attention_{dtype}"][0]["out"], jax_side["attention"][dtype]
    assert out.shape == ref.shape == (ATTN["B"], ATTN["T"], ATTN["C"])
    if dtype == "float32":  # the reference's own tolerance: fp32 sums in another order
        np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)
    else:
        assert np.abs(out - ref).max() <= ATTN_BF16_REL_TOL * np.abs(ref).max()
    assert all(rank["sp_calls"] == 1 for rank in sp_run[f"attention_{dtype}"])


# -- single process: configs, errors, the one-rank mesh -----------------------


def test_sp_model_config_matches_reference_fields():
    cfg = _with_sae(_port_config(fused_frontend=True, fused_attention=True), use_pallas=True)
    sp = tseq.sp_model_config(cfg)
    assert sp.encoder.seq_axis == "seq"
    assert not sp.encoder.fused_frontend and not sp.sae.use_pallas
    assert sp.encoder.fused_attention  # left as is: the encoder ignores it under seq_axis
    assert tseq.sp_model_config(sp) is sp


def test_sp_requires_matching_axis():
    mesh = tseq.sp_mesh(1)  # the one-rank mesh needs no process group
    with pytest.raises(ValueError, match="seq_axis"):
        tseq.sp_scoring_fn(Detector(CONFIGS["base"], device="cpu"), mesh)
    other = Detector(tseq.sp_model_config(CONFIGS["base"], axis="frames"), device="cpu")
    with pytest.raises(ValueError, match="seq_axis='frames'"):
        tseq.sp_scoring_fn(other, mesh)
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        tseq.sp_mesh(2, n_data=2)


def test_seq_axis_needs_a_mesh_and_a_mesh_needs_seq_axis():
    wav = torch.zeros(1, WAV_LEN)
    sp_model = Detector(tseq.sp_model_config(CONFIGS["base"]), device="cpu")
    with torch.inference_mode():
        with pytest.raises(ValueError, match="needs the mesh"):
            sp_model.score(wav)
        with pytest.raises(ValueError, match="not an axis of mesh"):
            Detector(CONFIGS["base"], device="cpu").score(wav, mesh=tseq.sp_mesh(1))
        with pytest.raises(ValueError, match="not an axis of mesh"):
            sp_model.score(wav, mesh=make_mesh(("data",)))


def test_one_rank_mesh_equals_the_unsharded_program():
    wav = torch.from_numpy(np.random.default_rng(3).normal(0, 0.1, (2, WAV_LEN))
                           .astype(np.float32))
    model = Detector(CONFIGS["window_overlap"], device="cpu")
    sp_model = Detector(tseq.sp_model_config(CONFIGS["window_overlap"]), device="cpu")
    sp_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        ref, out = model(wav), sp_model(wav, mesh=tseq.sp_mesh(1))
    assert torch.equal(out["log_probs"], ref["log_probs"])
    assert float(out["sae_loss"]) == pytest.approx(float(ref["sae_loss"]), rel=1e-6)


def test_ranks_with_different_weights_are_refused(monkeypatch):
    model = Detector(tseq.sp_model_config(CONFIGS["base"]), device="cpu")
    own = tseq.weights_checksum(model)
    monkeypatch.setattr(tseq, "allgather_rows", lambda x: np.stack([own, own + [1e-3, 0.0]]))
    with pytest.raises(ValueError, match="different weights"):
        tseq.sp_scoring_fn(model, tseq.sp_mesh(1))


def test_sp_flash_ragged_shard_clear_error():
    q = torch.zeros(2, 72, 64)  # no q-block >= 128 divides 72
    with pytest.raises(ValueError, match="no q-block"):
        ta.sp_flash_attention_long(q, q, q, 4)
    assert ta.sp_flash_attention_long(torch.zeros(1, 128, 256), torch.zeros(1, 512, 256),
                                      torch.zeros(1, 512, 256), 4).shape == (1, 128, 256)


def test_k_and_v_travel_in_one_gather(monkeypatch):
    """The wrapper stacks k and v, so a layer costs one collective; the
    stand-in group of two holds the same shards twice."""
    gathers = []

    def two_equal_ranks(x, group, dim):
        gathers.append((tuple(x.shape), dim))
        return torch.cat([x, x], dim=dim)

    monkeypatch.setattr(ta, "all_gather_cat", two_equal_ranks)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 128, 256, generator=g) for _ in range(3))
    out = ta.sp_flash_attention_long(q, k, v, 4, group="two ranks")
    assert gathers == [((2, 2, 128, 256), 2)]
    ref = ta.flash_attention_long_plain(q, torch.cat([k, k], 1), torch.cat([v, v], 1), 4)
    assert torch.equal(out, ref)


def test_a_failing_rank_ends_the_job():
    """A rank that raises must not leave the others waiting: the launcher
    kills them and raises with the rank's traceback."""
    with pytest.raises(RuntimeError, match="unknown job kind"):
        launch(workers.sp_score_rank, 2,
               ([(tseq.sp_model_config(CONFIGS["base"]), {"seed": 0})], "cpu", [(2, 1)],
                [dict(kind="no such job")]), device_type="cpu", timeout_s=120)


# -- on cards: kernel 7 against its plain version, and the ranks' program ------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1280, 5120, 16), (1, 640, 2560, 16), (2, 2560, 5120, 16),
                                   (2, 128, 512, 4)],
                         ids=["strip1280", "strip640", "dp2xsp2_strip", "small"])
def test_sp_flash_attention_long_kernel_matches_plain(cuda, shape):
    """One rank's strip through the kernel (a group of one: k and v given
    whole) at the main path's strip shapes."""
    b, tq, tkv, h = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [(torch.randn(b, t, h * 64, device=cuda, generator=g) * 0.5).to(torch.bfloat16)
               for t in (tq, tkv, tkv)]
    before = ta.sp_flash_attention_long.launches
    out = ta.sp_flash_attention_long(q, k, v, h)
    torch.cuda.synchronize()
    assert ta.sp_flash_attention_long.launches == before + 1
    ref = ta.sp_flash_attention_long_plain(q, k, v, h)
    assert (out.float() - ref.float()).abs().max() <= ATTN_BF16_REL_TOL * ref.float().abs().max()
    # a strip is bit-equal to its rows of the whole-sequence kernel's output
    whole = ta.flash_attention_long(torch.cat([q, q], dim=1)[:, :tkv].contiguous(), k, v, h,
                                    block_q=128)
    assert torch.equal(out, whole[:, :tq])


@pytest.mark.cuda
def test_sp_scoring_on_cards_matches_single_process(cuda):
    """Four ranks on the cards present (NCCL with a card a rank, gloo when
    they share one) against the single-process program on one card: a
    bf16 encoder of 256 channels at T 1024, kernel 7 on strips of 256."""
    enc = tcfg.tiny_xlsr_config(dtype=torch.bfloat16, embed_dim=256, num_heads=4,
                                flash_long_t=512)
    cfg = tcfg.ModelConfig(encoder=enc, classifier_hidden=32,
                           sae=tcfg.SAEConfig(activation_dim=256, dict_size=512, k=32))
    wav = np.random.default_rng(0).normal(0, 0.1, (2, _samples(1024))).astype(np.float32)
    model = Detector(cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.inference_mode():
        ref = model.score(torch.from_numpy(wav).to(cuda)).cpu().numpy()
    jobs = [dict(kind="forward", mesh=0, wav=wav), dict(kind="forward", mesh=1, wav=wav)]
    ranks = launch(workers.sp_score_rank, RANKS,
                   ([(tseq.sp_model_config(cfg), {"seed": 0})], "cuda", MESHES, jobs),
                   device_type="cuda", timeout_s=300)
    for rank in ranks:
        for job, res in enumerate(rank):
            # two bf16 layouts of one two-layer encoder: well inside the
            # long-T routes' bound on log-probs
            assert np.abs(res["log_probs"] - ref).max() <= 2e-2
            assert res["sp_calls"] == res["launches"]["sp_flash_attention_long"] == 2
            np.testing.assert_array_equal(res["log_probs"], ranks[0][job]["log_probs"])
