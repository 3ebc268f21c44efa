"""The deployment artifact (``sls_tpu_torch/serve/export.py``,
``cli/export.py``) and the serving kernels as ``torch.library`` custom
ops (``kernels/ops.py``), on the CPU at a tiny size.

- The layout and the manifest (the JAX manifest's keys, with
  ``torch_version``, ``device`` and ``export_schema_version`` in place of
  ``jax_version``, ``platforms`` and ``calling_convention_version``).
- The reloaded program against the live scorer (``load_serving_model``)
  on the same wire batch: equal bit for bit (the same ATen operators and
  plain versions on the same inputs, in the same order).
- Another shape or dtype, an unknown wire and another format version
  are refused.
- The int16 wire through ``BatchingEngine``, served equal to the
  program's offline scores; the SLS family; ``cli.export --verify``.
- A ``use_pallas`` run's graph holds the custom ops (rows 1-2; 3, 5 and
  2 for the window-overlap SAE; 8 and 9 for the fused front-end and
  attention routes), not their plain bodies.
- ``torch.library.opcheck`` on each op at tiny shapes: the schema, the
  fake implementation against the CPU one, and the dispatch.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as C
from sls_tpu_torch.ckpt.checkpoint import save_checkpoint
from sls_tpu_torch.cli import export as export_cli
from sls_tpu_torch.data.pipeline import to_wire
from sls_tpu_torch.kernels import ops
from sls_tpu_torch.kernels.frontend import tail_lengths
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.models.sls import SLSDetector
from sls_tpu_torch.scores.writer import log_probs_to_scores
from sls_tpu_torch.serve import export as E
from sls_tpu_torch.serve.engine import BatchingEngine
from sls_tpu_torch.serve.scorer import load_serving_model

CUT, BATCH, D, M, K = 1000, 4, 64, 256, 32
ROUTES_CUT = 4005  # the fused front-end's gate holds at the tiny size here (not at 4000)
SERVE_TOL = 1e-6  # the same program on the same batch shape; float64 exp of the same log-probs
JAX_MANIFEST_KEYS = {"format_version", "family", "n_args", "batch_size", "cut", "wire_dtype",
                     "int8_serving", "config"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exp(cut=CUT, **sae):
    return C.ExperimentConfig(
        model=C.ModelConfig(encoder=C.tiny_xlsr_config(),
                            sae=C.SAEConfig(activation_dim=D, dict_size=M, k=K, **sae)),
        train=C.TrainConfig(cut_length=cut))


def _run_dir(path, exp, sls=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if sls:
        exp = dataclasses.replace(exp, model=dataclasses.replace(exp.model, use_sae=False))
        model = SLSDetector(exp.model, device="cpu", generator=gen, cut_length=exp.train.cut_length)
    else:
        model = Detector(exp.model, device="cpu", generator=gen)
    save_checkpoint(path / "last.ckpt", {"model": model.state_dict()}, epoch=3,
                    config_json=C.config_to_json(exp))
    return path


RUNS = {
    "flagship": lambda: _exp(use_pallas=True),
    "window_overlap": lambda: _exp(use_pallas=True, variant="window_overlap", window_size=8),
    "routes": lambda: dataclasses.replace(_exp(ROUTES_CUT, use_pallas=True), model=dataclasses.replace(
        _exp(ROUTES_CUT, use_pallas=True).model, encoder=C.tiny_xlsr_config(
            fused_attention=True, fused_frontend=True))),
    "plain_sae": lambda: _exp(),
}
GRAPH_OPS = {
    "flagship": ["sls_tpu_torch::sae_decode", "sls_tpu_torch::sae_encode_topk"],
    "window_overlap": ["sls_tpu_torch::sae_decode", "sls_tpu_torch::sae_encode",
                       "sls_tpu_torch::window_vote"],
    "routes": ["sls_tpu_torch::frontend_tail", "sls_tpu_torch::fused_attention",
               "sls_tpu_torch::sae_decode", "sls_tpu_torch::sae_encode_topk"],
    "plain_sae": [],
}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """{name: (run_dir, artifact dir, manifest)} for every run, on the
    int16 wire."""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for name, make in RUNS.items():
        run = _run_dir(root / f"run_{name}", make())
        art = root / f"art_{name}"
        out[name] = (run, art, E.export_serving(run, art, batch_size=BATCH, wire_dtype="int16",
                                                device="cpu"))
    return out


def _wire(n, cut, seed=0):
    rng = np.random.default_rng(seed)
    return to_wire(rng.normal(0, 0.1, size=(n, cut)).astype(np.float32), "int16")


def test_layout_and_manifest(exported):
    run, art, manifest = exported["flagship"]
    assert sorted(p.name for p in art.iterdir()) == sorted([E.MANIFEST_NAME, E.PROGRAM_NAME])
    on_disk = json.loads((art / E.MANIFEST_NAME).read_text())
    assert on_disk == manifest
    assert JAX_MANIFEST_KEYS <= set(manifest)
    assert {"torch_version", "device", "export_schema_version", "ops"} <= set(manifest)
    assert manifest["format_version"] == E.FORMAT_VERSION
    assert (manifest["family"], manifest["batch_size"], manifest["cut"], manifest["wire_dtype"],
            manifest["device"], manifest["n_args"]) == ("detector", BATCH, CUT, "int16", "cpu", 1)
    assert manifest["torch_version"] == torch.__version__
    assert manifest["config"]["model"]["sae"]["use_pallas"] is True


@pytest.mark.parametrize("name", sorted(RUNS))
def test_graph_holds_the_custom_ops(exported, name):
    _, art, manifest = exported[name]
    assert manifest["ops"] == GRAPH_OPS[name]
    program = torch.export.load(str(art / E.PROGRAM_NAME))
    assert E.program_ops(program) == GRAPH_OPS[name]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_reloaded_equals_live_scorer(exported, name):
    run, art, manifest = exported[name]
    _, forward = E.load_exported(art)
    _, live = load_serving_model(run, device="cpu")
    wire = _wire(BATCH, manifest["cut"], seed=1)
    got, want = forward(wire), live(wire)
    assert got.shape == (BATCH, 2) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_sls_family(tmp_path):
    run = _run_dir(tmp_path / "run", _exp(), sls=True)
    manifest = E.export_serving(run, tmp_path / "art", batch_size=BATCH, device="cpu")
    assert manifest["family"] == "sls" and manifest["ops"] == []
    assert manifest["wire_dtype"] == "float32"
    _, forward = E.load_exported(tmp_path / "art")
    _, live = load_serving_model(run, device="cpu")
    wav = np.random.default_rng(2).normal(0, 0.1, size=(BATCH, CUT)).astype(np.float32)
    assert torch.equal(forward(wav), live(wav))


def test_drift_and_unknown_wire_rejected(exported, tmp_path):
    run, art, _ = exported["flagship"]
    _, forward = E.load_exported(art)
    with pytest.raises(ValueError, match=r"fixed at wav\[4, 1000\] int16"):
        forward(_wire(BATCH + 1, CUT))
    with pytest.raises(ValueError, match="got \\[4, 1000\\] float32"):
        forward(np.zeros((BATCH, CUT), np.float32))
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        E.export_serving(run, tmp_path / "bad", wire_dtype="int4", device="cpu")


def test_format_version_gate(exported, tmp_path):
    _, art, manifest = exported["flagship"]
    bad = tmp_path / "art"
    bad.mkdir()
    (bad / E.PROGRAM_NAME).write_bytes((art / E.PROGRAM_NAME).read_bytes())
    (bad / E.MANIFEST_NAME).write_text(json.dumps({**manifest, "format_version": 99}))
    with pytest.raises(ValueError, match="format_version 99"):
        E.load_exported(bad)


def test_int16_wire_through_engine(exported):
    _, art, manifest = exported["flagship"]
    man, forward, cut = E.build_scorer_from_export(art)
    assert cut == CUT and man == manifest
    rng = np.random.default_rng(3)
    clips = [rng.normal(0, 0.1, size=int(rng.integers(300, 1500))).astype(np.float32)
             for _ in range(BATCH + 2)]
    with BatchingEngine(forward, BATCH, cut=CUT, wire_dtype="int16", max_wait_ms=500) as eng:
        got = np.array([f.result(timeout=60) for f in [eng.submit(c) for c in clips]])
    from sls_tpu_torch.data.audio import pad_or_tile

    rows = np.stack([pad_or_tile(c, CUT) for c in clips])
    want = []
    for lo in range(0, len(rows), BATCH):
        part = rows[lo:lo + BATCH]
        full = np.concatenate([part, np.repeat(part[:1], BATCH - len(part), 0)])
        want.append(log_probs_to_scores(forward(to_wire(full, "int16")))[:len(part)])
    np.testing.assert_allclose(got, np.concatenate(want), rtol=0, atol=SERVE_TOL)


def test_cli_export_verify(exported, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")
    run, _, _ = exported["window_overlap"]
    assert export_cli.main([str(run), "--out", str(tmp_path / "art"), "--batch", str(BATCH),
                            "--wire", "int16", "--verify"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["verify_max_abs_diff"] <= export_cli.VERIFY_TOL
    manifest = json.loads((tmp_path / "art" / E.MANIFEST_NAME).read_text())
    assert manifest["ops"] == GRAPH_OPS["window_overlap"]


# -- the ops themselves --------------------------------------------------------------


def _op_args(name):
    rng = np.random.default_rng(4)

    def t(*shape, positive=False):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return x.abs() if positive else x

    if name in ("sae_encode_topk", "sae_encode"):
        args = (t(6, D), t(D, M), t(M), t(D))
        return args + (K,) if name == "sae_encode_topk" else args
    if name == "window_vote":
        return (t(2, 20, M, positive=True), K, 8)
    if name == "sae_decode":
        return (t(6, M, positive=True), t(M, D), t(D))
    if name == "fused_attention":
        return (t(2, 9, 4, 16), t(2, 9, 4, 16), t(2, 9, 4, 16))
    if name == "layer_norm":
        return (t(2, 9, 16).to(torch.bfloat16), t(16), t(16), 1e-5)
    specs = ((3, 2), (2, 2))
    c = 8
    return (t(2, 40, c), [t(k, c, c) for k, _ in specs], t(2, c), t(3, c), t(3, c),
            [v for sp in specs for v in sp], True, 1e-5)


@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_opcheck(name):
    assert set(ops.register_all()) == {f"sls_tpu_torch::{n}" for n in ops.OPS}
    op = getattr(torch.ops.sls_tpu_torch, name)
    args = _op_args(name)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    if name == "frontend_tail":
        assert op(*args).shape == (2, tail_lengths(40, ((3, 2), (2, 2)))[-1], 8)
