"""The port's HTTP server (``sls_tpu_torch/serve/server.py``) and
``cli/serve.py``, on the CPU.

- Every endpoint, body form and bad request as ``tests/test_serve.py``'s
  ``TestHTTP`` checks the JAX server, over a stub scorer whose log-probs
  encode each row's mean (request -> row -> response alignment).
- A tiny detector served from a port run directory: ``/score`` (PCM16),
  ``/score_batch`` and ``/score_long`` equal the offline score file
  (``produce_scores`` at the same batch shape) and
  ``score_full_utterance`` within ``SERVE_TOL``.
- One JAX server and one port server over the same JAX-written run
  directory answer ``/score`` within ``SCORE_ATOL`` (fp32 encoders on the
  CPU, sums in another order: ``tests/test_torch_offline_eval.py``'s
  tolerance).
- 64 clients at once, more than the stdlib listen backlog of 5 holds, are
  all answered.
- ``cli.serve`` as a subprocess answers ``/healthz`` and ``/score``; its
  refusals (``--dp``, ``--buckets`` with ``--from_export``) exit 2.
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sls_tpu.ckpt.checkpoint import save_checkpoint as jax_save_checkpoint
from sls_tpu.config import ExperimentConfig as JaxExperimentConfig
from sls_tpu.config import ModelConfig as JaxModelConfig
from sls_tpu.config import SAEConfig as JaxSAEConfig
from sls_tpu.config import TrainConfig as JaxTrainConfig
from sls_tpu.config import config_to_json as jax_config_to_json
from sls_tpu.config import tiny_xlsr_config as jax_tiny_xlsr_config
from sls_tpu.serve.engine import BatchingEngine as JaxBatchingEngine
from sls_tpu.serve.scorer import build_scorer as jax_build_scorer
from sls_tpu.serve.server import make_server as jax_make_server
from sls_tpu.train.loop import Trainer as JaxTrainer
from sls_tpu_torch import config as C
from sls_tpu_torch.ckpt.checkpoint import save_checkpoint
from sls_tpu_torch.cli import serve as serve_cli
from sls_tpu_torch.data.pipeline import ArrayLoader, to_wire
from sls_tpu_torch.evaluation.overlap import score_full_utterance
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.scores.writer import log_probs_to_scores, read_score_file
from sls_tpu_torch.serve.engine import BatchingEngine
from sls_tpu_torch.serve.scorer import build_scorer
from sls_tpu_torch.serve.server import make_server
from sls_tpu_torch.train.loop import produce_scores
from sls_tpu_torch.train.steps import make_eval_step

ROOT = Path(__file__).resolve().parents[1]
CUT, BATCH, D, M, K = 1000, 4, 64, 256, 32
SERVE_TOL = 1e-6   # the same forward at the same batch shape (float64 exp of equal log-probs)
SCORE_ATOL = 1e-4  # tests/test_torch_offline_eval.py: port against JAX on shared weights


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers do not oversubscribe the
    cores (no result here depends on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stub_score_fn(wav):
    """Per-row log-probs that encode the row mean (tests/test_serve.py)."""
    wav = np.asarray(wav, np.float32)
    p1 = np.clip(1.0 / (1.0 + np.exp(-wav.mean(axis=1) * 10.0)), 1e-6, 1 - 1e-6)
    return torch.from_numpy(np.log(np.stack([1 - p1, p1], axis=1)))


def expected_score(row_value: float) -> float:
    return float(log_probs_to_scores(stub_score_fn(np.full((1, CUT), row_value, np.float32)))[0])


def _post(url, data, headers):
    req = urllib.request.Request(url, data=data, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:  # 4xx / 5xx carry a JSON body too
        return e.code, json.loads(e.read())


def _pcm(wav):
    return np.clip(np.rint(np.asarray(wav) * 32768), -32768, 32767).astype("<i2").tobytes()


OCTET = {"Content-Type": "application/octet-stream"}
JSON = {"Content-Type": "application/json"}


class _Served:
    """An engine over ``score_fn`` behind a server on an ephemeral port."""

    def __init__(self, engine, make):
        self.engine = engine.start()
        self.httpd = make(self.engine, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.stop()


@pytest.fixture()
def stub_server():
    served = _Served(BatchingEngine(stub_score_fn, 4, cut=CUT, max_wait_ms=1), make_server)
    yield served.url
    served.close()


class TestHTTP:
    def test_healthz_and_stats(self, stub_server):
        with urllib.request.urlopen(stub_server + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
        _post(stub_server + "/score", _pcm(np.full(CUT, 0.05, np.float32)), OCTET)
        with urllib.request.urlopen(stub_server + "/stats", timeout=10) as r:
            st = json.loads(r.read())
        assert set(st) == {"requests", "batches", "mean_fill", "p50_ms", "p95_ms", "p99_ms"}
        assert st["requests"] == 1 and st["batches"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(stub_server + "/nope", timeout=10)
        assert e.value.code == 404

    def test_score_pcm16(self, stub_server):
        status, out = _post(stub_server + "/score", _pcm(np.full(CUT, 0.05, np.float32)),
                            {**OCTET, "X-Sample-Rate": "16000"})
        assert status == 200
        assert out["score"] == pytest.approx(expected_score(0.05), abs=1e-3)
        assert out["latency_ms"] >= 0

    def test_score_json_with_resample(self, stub_server):
        body = json.dumps({"wav": [0.07] * (2 * CUT), "sample_rate": 32000}).encode()
        status, out = _post(stub_server + "/score", body, JSON)
        assert status == 200
        assert out["score"] == pytest.approx(expected_score(0.07), abs=1e-2)

    def test_score_batch(self, stub_server):
        body = json.dumps({"wavs": [[0.05] * CUT, [-0.05] * CUT]}).encode()
        status, out = _post(stub_server + "/score_batch", body, JSON)
        assert status == 200
        assert out["scores"][0] == pytest.approx(expected_score(0.05), abs=1e-9)
        assert out["scores"][1] == pytest.approx(expected_score(-0.05), abs=1e-9)

    def test_score_long_endpoint(self, stub_server):
        wav = np.random.default_rng(5).normal(0, 0.03, size=int(2.2 * CUT)).astype(np.float32)
        status, out = _post(stub_server + "/score_long", _pcm(wav),
                            {**OCTET, "X-Aggregate": "min"})
        assert status == 200
        assert out["n_windows"] >= 4 and out["aggregate"] == "min"
        assert 0.0 <= out["score"] <= 1.0 and out["latency_ms"] >= 0
        status, out = _post(stub_server + "/score_long", _pcm(wav),
                            {**OCTET, "X-Aggregate": "median"})
        assert status == 400 and "aggregate" in out["error"]

    def test_bad_requests(self, stub_server):
        status, out = _post(stub_server + "/score", b"\x00\x01\x02", OCTET)
        assert status == 400 and "odd byte count" in out["error"]
        status, out = _post(stub_server + "/score", b"", OCTET)
        assert status == 400 and "empty" in out["error"]
        status, out = _post(stub_server + "/score", b"{not json", JSON)
        assert status == 400
        status, out = _post(stub_server + "/score", json.dumps({"sample_rate": 16000}).encode(),
                            JSON)
        assert status == 400  # no "wav"
        status, out = _post(stub_server + "/nope", b"{}", JSON)
        assert status == 404

    def test_many_concurrent_clients(self, stub_server):
        """More clients at once than the stdlib's listen backlog of 5 (the
        reference server's), every one answered."""
        from sls_tpu_torch.serve import server

        assert server.LISTEN_BACKLOG >= 64
        answers = []

        def client(v):
            answers.append(_post(stub_server + "/score", _pcm(np.full(CUT, v, np.float32)),
                                 OCTET))

        threads = [threading.Thread(target=client, args=(v,))
                   for v in np.linspace(-0.05, 0.05, 64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(answers) == 64 and all(status == 200 for status, _ in answers)

    def test_body_cap(self, stub_server, monkeypatch):
        from sls_tpu_torch.serve import server

        monkeypatch.setattr(server, "_MAX_BODY", 64)
        status, out = _post(stub_server + "/score", _pcm(np.zeros(CUT, np.float32)), OCTET)
        assert status == 400 and "too large" in out["error"]

    def test_engine_failure_is_a_500(self):
        def broken(wav):
            raise RuntimeError("device lost")

        served = _Served(BatchingEngine(broken, 2, cut=CUT, max_wait_ms=1), make_server)
        try:
            status, out = _post(served.url + "/score", _pcm(np.zeros(CUT, np.float32)), OCTET)
        finally:
            served.close()
        assert status == 500 and "device lost" in out["error"]


# -- a real detector ----------------------------------------------------------------


def _port_exp(**sae):
    return C.ExperimentConfig(
        model=C.ModelConfig(encoder=C.tiny_xlsr_config(), classifier_dropout=0.0,
                            sae=C.SAEConfig(activation_dim=D, dict_size=M, k=K, **sae)),
        train=C.TrainConfig(cut_length=CUT))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("port_run")
    exp = _port_exp(use_pallas=True)
    model = Detector(exp.model, device="cpu", generator=torch.Generator().manual_seed(1))
    save_checkpoint(run / "last.ckpt", {"model": model.state_dict()}, epoch=0,
                    config_json=C.config_to_json(exp))
    return run, model


def test_served_scores_equal_the_offline_file(port_run, tmp_path):
    run, model = port_run
    rng = np.random.default_rng(6)
    wavs = rng.normal(0, 0.1, size=(BATCH, CUT)).astype(np.float32)
    wire = to_wire(wavs, "int16")
    produce_scores(make_eval_step(model, device="cpu"),
                   ArrayLoader(wire, None, batch_size=BATCH), tmp_path / "scores.txt")
    _, offline = read_score_file(tmp_path / "scores.txt")
    _, score_fn, cut = build_scorer(run, wire_dtype="int16", batch_size=BATCH, device="cpu")
    served = _Served(BatchingEngine(score_fn, BATCH, cut=cut, wire_dtype="int16",
                                    max_wait_ms=2000), make_server)
    long_wav = rng.normal(0, 0.1, size=int(2.6 * CUT)).astype(np.float32)
    try:
        results = {}

        def one(i):
            results[i] = _post(served.url + "/score", wire[i].astype("<i2").tobytes(), OCTET)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        got = np.array([results[i][1]["score"] for i in range(BATCH)])
        status, batch_out = _post(served.url + "/score_batch", json.dumps(
            {"wavs": (wire.astype(np.float32) / 32768.0).tolist()}).encode(), JSON)
        status_long, long_out = _post(served.url + "/score_long", _pcm(long_wav), OCTET)
        with urllib.request.urlopen(served.url + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
    finally:
        served.close()
    assert all(results[i][0] == 200 for i in range(BATCH)) and status == 200
    np.testing.assert_allclose(got, offline, rtol=0, atol=SERVE_TOL)
    np.testing.assert_allclose(batch_out["scores"], offline, rtol=0, atol=SERVE_TOL)
    want_long = score_full_utterance(model, to_wire(long_wav[None], "int16")[0] / 32768.0,
                                     window=CUT, batch_size=BATCH, device="cpu")
    assert status_long == 200 and long_out["n_windows"] == want_long["n_windows"]
    assert long_out["score"] == pytest.approx(want_long["score"], abs=SERVE_TOL)
    assert stats["requests"] == 2 * BATCH + long_out["n_windows"]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A run directory written by the JAX package: its Trainer's init
    state (fp32 tiny encoder, plain SAE)."""
    run = tmp_path_factory.mktemp("jax_run")
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(encoder=jax_tiny_xlsr_config(), classifier_dropout=0.0,
                             sae=JaxSAEConfig(activation_dim=D, dict_size=M, k=K)),
        train=JaxTrainConfig(batch_size=BATCH, cut_length=CUT))
    jt = JaxTrainer(cfg, run, tensorboard=False)
    jt.init_state(np.zeros((2, CUT), np.float32))
    jax_save_checkpoint(run / "last.ckpt", jt._state_tree(), epoch=0,
                        config_json=jax_config_to_json(cfg))
    return run


def test_jax_and_port_servers_agree(jax_run):
    rng = np.random.default_rng(7)
    wavs = [rng.normal(0, 0.1, size=int(n)).astype(np.float32) for n in (CUT, 700, 1600)]
    answers = {}
    _, jax_fn, _ = jax_build_scorer(str(jax_run), batch_size=BATCH)
    _, port_fn, _ = build_scorer(jax_run, batch_size=BATCH, device="cpu")
    for name, engine, make in (
            ("jax", JaxBatchingEngine(jax_fn, BATCH, cut=CUT, max_wait_ms=1), jax_make_server),
            ("port", BatchingEngine(port_fn, BATCH, cut=CUT, max_wait_ms=1), make_server)):
        served = _Served(engine, make)
        try:
            answers[name] = [_post(served.url + "/score", _pcm(w), OCTET) for w in wavs]
        finally:
            served.close()
    for (js, jo), (ps, po) in zip(answers["jax"], answers["port"]):
        assert js == ps == 200
        assert set(po) == set(jo) == {"score", "latency_ms"}
        assert po["score"] == pytest.approx(jo["score"], abs=SCORE_ATOL)


# -- cli.serve ---------------------------------------------------------------------------


def test_cli_refusals(capsys, monkeypatch):
    assert serve_cli.main(["--from_export", "x", "--dp", "2"]) == 2
    assert serve_cli.main(["--from_export", "x", "--buckets", "2,4"]) == 2
    # --dp beyond the visible cards (on the card's platform)
    monkeypatch.delenv("SLS_TPU_PLATFORM", raising=False)
    beyond = torch.cuda.device_count() + 1
    assert serve_cli.main(["--run_dir", "x", "--dp", str(beyond)]) == 2
    assert f"--dp {beyond} needs {beyond} cards" in capsys.readouterr().out


def test_cli_dp_devices(monkeypatch):
    monkeypatch.setenv("SLS_TPU_PLATFORM", "cpu")
    assert serve_cli.dp_devices(2) == [torch.device("cpu")] * 2
    monkeypatch.delenv("SLS_TPU_PLATFORM")
    n = torch.cuda.device_count()
    if n:
        assert serve_cli.dp_devices(n) == [torch.device("cuda", i) for i in range(n)]
    assert isinstance(serve_cli.dp_devices(n + 1), str)


def test_dp_scorer_matches_the_jax_mesh_scorer(jax_run):
    """Two replicas, each scoring its half of every batch, against the JAX
    scorer whose batch is sharded over a 2-device data mesh."""
    import jax

    from sls_tpu.parallel.mesh import make_mesh

    wire = np.random.default_rng(8).normal(0, 0.1, size=(2 * BATCH, CUT)).astype(np.float32)
    _, jax_fn, _ = jax_build_scorer(str(jax_run), batch_size=BATCH,
                                    mesh=make_mesh(jax.devices()[:2]), bucket_sizes=(2,))
    _, port_fn, _ = build_scorer(jax_run, batch_size=BATCH, devices=["cpu", "cpu"],
                                 bucket_sizes=(2,))
    one_cfg, one_fn, _ = build_scorer(jax_run, batch_size=BATCH, device="cpu")
    for rows in (wire[:BATCH], wire[BATCH:], wire[:2]):
        got = port_fn(rows)
        assert got.shape == (len(rows), 2)
        want = np.array(jax_fn(rows))
        np.testing.assert_allclose(log_probs_to_scores(got), log_probs_to_scores(
            torch.from_numpy(want)), atol=SCORE_ATOL, rtol=0)
        # each replica scores its half as one replica scores it alone
        halves = torch.cat([one_fn(h) for h in np.split(rows, 2)])
        assert torch.equal(got, halves)


def test_dp_scorer_refuses_a_batch_that_does_not_divide(jax_run):
    import jax

    from sls_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="divisible"):
        jax_build_scorer(str(jax_run), batch_size=3, mesh=make_mesh(jax.devices()[:2]))
    with pytest.raises(ValueError, match="divisible"):
        build_scorer(jax_run, batch_size=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="divisible"):
        build_scorer(jax_run, batch_size=4, bucket_sizes=(3,), devices=["cpu", "cpu"])
    _, port_fn, _ = build_scorer(jax_run, batch_size=BATCH, devices=["cpu", "cpu"],
                                 warmup=False)
    with pytest.raises(ValueError, match="divisible"):
        port_fn(np.zeros((3, CUT), np.float32))


def test_cli_serve_subprocess(port_run):
    run, model = port_run
    env = {**os.environ, "SLS_TPU_PLATFORM": "cpu", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sls_tpu_torch.cli.serve", "--run_dir", str(run), "--port", "0",
         "--batch", str(BATCH), "--wire", "int16", "--max_wait_ms", "1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        for line in proc.stdout:
            m = re.search(r"on (http://127\.0\.0\.1:\d+)", line)
            if m:
                url = m.group(1)
                break
        assert url, "the server did not come up"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        wav = np.random.default_rng(8).normal(0, 0.1, size=CUT).astype(np.float32)
        status, out = _post(url + "/score", _pcm(wav), OCTET)
        assert status == 200
        row = np.repeat(to_wire(wav[None], "int16"), BATCH, 0)
        with torch.inference_mode():
            want = log_probs_to_scores(model.score(torch.from_numpy(row).float() / 32768.0))[0]
        assert out["score"] == pytest.approx(float(want), abs=SERVE_TOL)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
