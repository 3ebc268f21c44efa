"""The port's train / eval command line (``sls_tpu_torch/cli/main.py``)
against the JAX package's (``sls_tpu/cli/main.py``).

- The parsers agree action by action (option strings, dest, default,
  choices, nargs, type, const, required; not the help text, which names
  each package's kernels) and in their mutual exclusions.
- ``config_from_args`` gives the JAX function's config field for field
  (``config_to_json`` of both), and ``model_tag`` the same string.
- The rc-2 refusals.
- On a miniature WAV corpus and a run directory written by the JAX
  package (``Trainer`` init + save, no training step), both CLIs'
  ``--is_eval --tiny --pallas_sae`` score files for the fixed crop,
  ``--full_utterance`` and ``--full_utterance --unwindowed`` agree per
  utterance within ``SCORE_ATOL`` (the JAX side runs its Pallas SAE
  kernels in interpret mode; the tolerance of
  ``tests/test_torch_offline_eval.py``).  The streamed set fills whole
  batches: the JAX streamed scorer drops a last partial one (ROADMAP §3).
- ``--seq_parallel 2`` on two CPU ranks gives ``--unwindowed``'s file
  within ``SP_TOL`` (fp32, sums reordered: the reference's own
  sequence-parallel tolerance).
- The port CLI trains (``--quick_test``, ``--profile_steps``), resumes
  and evaluates; ``--model_type sls`` trains and evaluates.
"""

import json
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import sls_tpu.kernels.sae_kernels as jax_sk
from sls_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from sls_tpu.cli import main as jax_cli
from sls_tpu.config import config_to_json as jax_config_to_json
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch.cli import main as cli
from sls_tpu_torch.config import config_to_json
from sls_tpu_torch.scores.writer import read_score_file

SCORE_ATOL = 1e-4  # tests/test_torch_offline_eval.py
SP_TOL = 2e-5      # tests/test_torch_sequence_parallel.py
N_EVAL, EVAL_LEN, LONG_LEN = 12, 800, 2200  # 12 one-window clips + one of 4 windows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def interpret_kernels():
    """Route the JAX package's SAE kernels through Pallas interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("sae_encode_topk_fused", "sae_decode_fused"):
            fn = getattr(jax_sk, name)
            mp.setattr(jax_sk, name,
                       lambda *a, _fn=fn, **kw: _fn(*a, **{**kw, "interpret": True}))
        yield


# -- parser and config ----------------------------------------------------------

ACTION_FIELDS = ("option_strings", "dest", "default", "choices", "nargs", "type", "const",
                 "required")


def test_parser_matches_jax_action_by_action():
    port, ref = cli.build_parser(), jax_cli.build_parser()
    assert len(port._actions) == len(ref._actions)
    for a, b in zip(port._actions, ref._actions):
        for f in ACTION_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.dest, f)
        assert type(a) is type(b), a.dest

    def groups(p):
        return [[a.dest for a in g._group_actions] for g in p._mutually_exclusive_groups]

    assert groups(port) == groups(ref) == [["wire_int16", "wire_mulaw"]]


ARGVS = {
    "per_timestep": [],
    "window_overlap": ["--use_window_topk", "--overlap_windows", "--sae_window_size", "4"],
    "window_hard": ["--use_window_topk", "--comment", "hard"],
    "cpc": ["--use_cpc", "--cpc_weight", "0.25", "--cpc_prediction_steps", "1", "3"],
    "sls": ["--model_type", "sls", "--lr", "0.0001", "--batch_size", "5"],
    "tiny": ["--tiny", "--sae_dict_size", "256", "--sae_k", "32", "--pallas_sae"],
    "int8_training": ["--int8", "--int8_scope", "all"],
    "int8_eval": ["--int8", "--is_eval", "--track", "DF"],
    "fp32_remat": ["--no_bf16", "--remat", "--no_sae", "--use_reconstructed_features",
                   "--algo", "5", "--SNRmax", "30", "--seed", "7"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_config_and_tag_match_jax(name, capsys):
    argv = ARGVS[name]
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    jax_note = capsys.readouterr().out
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert capsys.readouterr().out == jax_note  # the --int8 note, or nothing
    assert json.loads(config_to_json(got)) == json.loads(jax_config_to_json(want))
    assert got.model_tag() == want.model_tag()
    if name == "sls":
        assert not got.model.use_sae and got.model_tag().startswith("sls_LA_e100_bs5_lr0.0001")
    if name == "int8_training":
        assert "serving-only" in jax_note and not got.model.encoder.int8_serving


REFUSALS = [
    ["--resume", "--fresh_start"],
    ["--tiny", "--unwindowed"],
    ["--tiny", "--is_eval", "--unwindowed"],
    ["--tiny", "--seq_parallel", "2"],
    ["--tiny", "--is_eval", "--seq_parallel", "2"],
    ["--tiny", "--is_eval", "--full_utterance", "--seq_parallel", "2"],
    ["--tiny", "--cp_path", "/nonexistent.pt"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a[1:] if a[0] == "--tiny"
                                                                  else a))
def test_refusals_exit_2(argv, tmp_path):
    argv = argv + ["--model_dir", str(tmp_path)]
    assert cli.main(argv) == 2
    assert not any(tmp_path.iterdir())  # refused before any run directory
    if "--cp_path" not in argv:  # the JAX CLI refuses that one after its Trainer's init
        assert jax_cli.main(argv) == 2


def test_platform_device(monkeypatch):
    assert cli.platform_device() == torch.device("cpu")
    monkeypatch.setenv("SLS_TPU_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="cuda"):
        cli.platform_device()
    monkeypatch.delenv("SLS_TPU_PLATFORM")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.platform_device()


# -- a miniature corpus -----------------------------------------------------------


def _write_wav(path: Path, samples: np.ndarray):
    path.parent.mkdir(parents=True, exist_ok=True)
    pcm = np.clip(samples * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The 2019 LA train / dev layout (16 / 8 WAVs with protocols) and a
    2021 LA eval list: ``N_EVAL`` clips of ``EVAL_LEN`` samples and one of
    ``LONG_LEN`` (4 windows at the tiny cut of 1000)."""
    root = tmp_path_factory.mktemp("cli_corpus")
    db, proto = root / "data", root / "protocols"
    proto.mkdir()
    rng = np.random.default_rng(0)
    tone = np.sin(2 * np.pi * 440 * np.arange(EVAL_LEN) / 16000.0).astype(np.float32)

    def split(split_dir, protocol, n, prefix):
        rows = []
        for i in range(n):
            label = "bonafide" if i % 2 == 0 else "spoof"
            utt = f"{prefix}_{i:04d}"
            wav = rng.normal(0, 0.05, EVAL_LEN).astype(np.float32)
            if label == "bonafide":
                wav += 0.3 * tone
            _write_wav(db / split_dir / "flac" / f"{utt}.wav", wav)
            rows.append(f"SPK_{i % 3} {utt} - - {label}")
        (proto / protocol).write_text("\n".join(rows) + "\n")

    split("ASVspoof2019_LA_train", "ASVspoof2019.LA.cm.train.trn.txt", 16, "T")
    split("ASVspoof2019_LA_dev", "ASVspoof2019.LA.cm.dev.trl.txt", 8, "D")
    ids = [f"E_{i:04d}" for i in range(N_EVAL + 1)]
    (proto / "ASVspoof2021.LA.cm.eval.trl.txt").write_text("\n".join(ids) + "\n")
    for i, utt in enumerate(ids):
        n = LONG_LEN if i == 5 else EVAL_LEN
        _write_wav(db / "ASVspoof2021_LA_eval" / "flac" / f"{utt}.wav",
                   rng.normal(0, 0.05, n).astype(np.float32))
    return root, ids


def _args(root, model_dir, *extra):
    return ["--tiny", "--audio_ext", "wav", "--database_path", str(root / "data"),
            "--protocols_path", str(root / "protocols"), "--model_dir", str(model_dir),
            "--batch_size", "8", "--num_epochs", "1", "--lr", "1e-3",
            "--sae_dict_size", "256", "--sae_k", "32", "--algo", "0", *extra]


@pytest.fixture(scope="module")
def jax_run(corpus, tmp_path_factory):
    """A run directory written by the JAX package: its Trainer's init
    state saved as ``last.ckpt`` under the tag both CLIs give."""
    root, _ = corpus
    model_dir = tmp_path_factory.mktemp("jax_models")
    cfg = jax_cli.config_from_args(jax_cli.build_parser().parse_args(
        _args(root, model_dir, "--pallas_sae")))
    run_dir = model_dir / cfg.model_tag()
    jt = JaxTrainer(cfg, run_dir, tensorboard=False)
    jt.init_state(np.zeros((2, cfg.train.cut_length), np.float32))
    jax_save_checkpoint(run_dir / "last.ckpt", jt._state_tree(), epoch=0,
                        config_json=jax_config_to_json(cfg))
    return model_dir


MODES = {"fixed_crop": [], "full_utterance": ["--full_utterance"],
         "unwindowed": ["--full_utterance", "--unwindowed"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_score_files_match_jax(corpus, jax_run, interpret_kernels, mode, tmp_path):
    root, ids = corpus
    files = {}
    for name, run in (("jax", jax_cli.main), ("port", cli.main)):
        files[name] = tmp_path / f"{name}.txt"
        assert run(_args(root, jax_run, "--pallas_sae", "--is_eval", *MODES[mode],
                         "--eval_output", str(files[name]))) == 0
    got_ids, got = read_score_file(files["port"])
    want_ids, want = read_score_file(files["jax"])
    assert got_ids == want_ids == ids
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert np.all((got >= 0) & (got <= 1))


def test_seq_parallel_ranks_equal_unwindowed(corpus, jax_run, tmp_path):
    """Without ``--pallas_sae``: under sequence parallelism the SAE takes
    its plain fp32 route (``sp_model_config`` clears ``use_pallas``), and
    the single process must take the same route for ``SP_TOL`` to hold
    (the kernel's bf16 operands lie ~1e-2 away on these random weights)."""
    root, ids = corpus
    model_dir = tmp_path / "models"
    # the same JAX weights under the tag of a run without --pallas_sae
    cfg = cli.config_from_args(cli.build_parser().parse_args(_args(root, model_dir)))
    src = next(Path(jax_run).iterdir()) / "last.ckpt"
    (model_dir / cfg.model_tag()).mkdir(parents=True)
    (model_dir / cfg.model_tag() / "last.ckpt").write_bytes(src.read_bytes())
    single, sp = tmp_path / "single.txt", tmp_path / "sp.txt"
    base = _args(root, model_dir, "--is_eval", "--full_utterance", "--unwindowed")
    assert cli.main(base + ["--eval_output", str(single)]) == 0
    assert cli.main(base + ["--seq_parallel", "2", "--eval_output", str(sp)]) == 0
    sp_ids, got = read_score_file(sp)
    single_ids, want = read_score_file(single)
    assert sp_ids == single_ids == ids
    np.testing.assert_allclose(got, want, rtol=SP_TOL, atol=SP_TOL)
    assert not list(tmp_path.glob("*.part*"))


# -- training through the CLI ------------------------------------------------------


def test_train_profile_resume_then_eval(corpus, tmp_path, capsys):
    root, ids = corpus
    model_dir = tmp_path / "models"
    assert cli.main(_args(root, model_dir, "--pallas_sae", "--quick_test",
                          "--profile_steps", "1")) == 0
    out = capsys.readouterr().out
    assert "RANDOMLY INITIALIZED" in out
    (run_dir,) = model_dir.iterdir()
    cfg = cli.config_from_args(cli.build_parser().parse_args(_args(root, model_dir,
                                                                   "--pallas_sae")))
    assert run_dir.name == cfg.model_tag()
    assert (run_dir / "last.ckpt").exists() and (run_dir / "best.ckpt").exists()
    assert (run_dir / "profile" / "trace.json").stat().st_size > 0
    from sls_tpu_torch.cli.monitor import read_log

    rows = read_log(run_dir)
    assert [r["epoch"] for r in rows] == ["0"]
    # --resume finds last.ckpt: nothing left to train
    assert cli.main(_args(root, model_dir, "--pallas_sae", "--resume")) == 0
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert [r["epoch"] for r in read_log(run_dir)] == ["0"]
    # a second epoch from it, into the tag of a two-epoch run
    assert cli.main(_args(root, model_dir, "--pallas_sae", "--num_epochs", "2",
                          "--model_path", str(run_dir / "last.ckpt"))) == 0
    assert "resumed at epoch 1" in capsys.readouterr().out
    assert [r["epoch"] for r in read_log(model_dir / run_dir.name.replace("_e1_", "_e2_"))
            ] == ["1"]
    scores = tmp_path / "scores.txt"
    assert cli.main(_args(root, model_dir, "--pallas_sae", "--is_eval", "--eval_output",
                          str(scores))) == 0
    got_ids, got = read_score_file(scores)
    assert got_ids == ids and np.all(np.isfinite(got))


def test_sls_trains_and_evaluates(corpus, tmp_path):
    root, ids = corpus
    model_dir = tmp_path / "models"
    argv = _args(root, model_dir, "--model_type", "sls", "--quick_test")
    assert cli.main(argv) == 0
    (run_dir,) = model_dir.iterdir()
    assert run_dir.name.startswith("sls_LA_e1_bs8_lr0.001")
    scores = tmp_path / "scores.txt"
    assert cli.main(argv + ["--is_eval", "--eval_output", str(scores)]) == 0
    got_ids, got = read_score_file(scores)
    assert got_ids == ids and np.all((got >= 0) & (got <= 1))
