"""The program's spans and counters (``sls_tpu_torch/train/profiling.py``).

- Off (the default): ``span`` and ``keyed`` return the shared
  ``NO_SPAN``, nothing is recorded, and a span allocates nothing.
- On: nesting sets the parent, the key is inherited, the stack is per
  thread; a span still open when recording stops is dropped; the sync
  counter counts torch's sync notes by the innermost span, shows other
  warnings, and puts the sync debug mode and the warning filters back.
- ``produce_scores`` and ``score_utterances_unwindowed`` on a tiny
  detector record the named spans once a batch or clip, in order, keyed
  by the first utterance of a batch or by the clip; their outputs are
  the same with recording on and off.
- ``Trace`` (``--profile_steps``) writes the spans into its chrome
  trace, on the trace's own time base, where ``op_histogram`` and
  ``cli.profile_diff`` read them.
- On a card (marked ``cuda``): a span and the profiler's interval of a
  kernel run inside it share one clock; a pageable upload and a fetch
  each count one sync.  Run there without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -s
"""

import json
import threading
import tracemalloc
import warnings

import numpy as np
import pytest
import torch

from sls_tpu_torch import config as C
from sls_tpu_torch.cli import profile_diff
from sls_tpu_torch.data.pipeline import ArrayLoader
from sls_tpu_torch.evaluation.overlap import score_utterances_unwindowed
from sls_tpu_torch.models.detector import Detector
from sls_tpu_torch.train import profiling
from sls_tpu_torch.train.loop import Trainer, produce_scores
from sls_tpu_torch.train.steps import make_eval_step

BATCH = 4
WAV_LEN = 1000  # 49 frames with the tiny conv stack
# a batch's spans in the order they close (the loader's first)
BATCH_SPANS = ["sls.load", "sls.upload", "sls.frontend", "sls.layers", "sls.sae",
               "sls.head", "sls.dispatch", "sls.fetch", "sls.write"]
CLIP_SPANS = ["sls.tile", "sls.upload", "sls.frontend", "sls.layers", "sls.sae",
              "sls.head", "sls.dispatch", "sls.fetch"]
CLOCK_SLACK_NS = 50_000
SLEEP_MIN_NS = 200_000


@pytest.fixture(autouse=True)
def recording_off():
    """Every test starts and ends with recording off."""
    assert not profiling.recording_on()
    yield
    if profiling.recording_on():
        profiling.stop_recording()
        pytest.fail("the test left recording on")


@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    cfg = C.ModelConfig(encoder=C.tiny_xlsr_config(),
                        sae=C.SAEConfig(activation_dim=64, dict_size=256, k=32, use_pallas=True),
                        classifier_hidden=32)
    return Detector(cfg, device="cpu")


def _wavs(n, length=WAV_LEN, seed=0):
    return np.random.default_rng(seed).standard_normal((n, length)).astype(np.float32) * 0.1


# -- off ----------------------------------------------------------------------

def test_off_returns_the_shared_no_op_and_records_nothing():
    assert profiling.span("sls.x") is profiling.NO_SPAN
    assert profiling.span("sls.y", key="u1") is profiling.NO_SPAN
    assert profiling.keyed("u1") is profiling.NO_SPAN
    with profiling.span("sls.x") as inside:
        profiling.count("sls.n", 3)
    assert inside is None
    rec = profiling.start_recording()
    assert profiling.stop_recording() is rec
    assert rec.spans == [] and rec.counts == {}  # nothing of the calls above
    assert not hasattr(profiling.NO_SPAN, "__dict__")  # no state: nothing to lock


def test_off_span_allocates_nothing():
    def spin():
        for _ in range(2000):
            with profiling.span("sls.x", "u"):
                with profiling.keyed("u"):
                    profiling.count("sls.n")

    spin()  # warm
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spin()
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    only = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(only).compare_to(before.filter_traces(only), "lineno")
    assert sum(s.count_diff for s in grown) == 0
    assert sum(s.size_diff for s in grown) == 0


# -- on -----------------------------------------------------------------------

def test_nesting_sets_parent_and_key_is_inherited():
    with profiling.recording() as rec:
        with profiling.span("sls.outer", key="b0"):
            with profiling.span("sls.inner"):
                pass
            with profiling.keyed("c7"):
                with profiling.span("sls.keyed"):
                    pass
            with profiling.span("sls.own", key="c9"):
                pass
        with profiling.span("sls.alone"):
            pass
        profiling.count("sls.n", 2)
        profiling.count("sls.n")
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["sls.inner", "sls.keyed", "sls.own",
                                           "sls.outer", "sls.alone"]
    assert (by["sls.inner"].parent, by["sls.inner"].key) == ("sls.outer", "b0")
    # a keyed frame is no span: the parent is the span around it
    assert (by["sls.keyed"].parent, by["sls.keyed"].key) == ("sls.outer", "c7")
    assert (by["sls.own"].parent, by["sls.own"].key) == ("sls.outer", "c9")
    assert (by["sls.outer"].parent, by["sls.outer"].key) == (None, "b0")
    assert (by["sls.alone"].parent, by["sls.alone"].key) == (None, None)
    outer, inner = by["sls.outer"], by["sls.inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert {s.thread for s in rec.spans} == {threading.get_ident()}
    assert rec.counts == {"sls.n": 3}
    assert profiling.span("sls.x") is profiling.NO_SPAN  # off again


def test_stack_is_per_thread():
    gate = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"sls.{tag}", key=tag):
            gate.wait()  # both outer spans open at once
            with profiling.span("sls.child"):
                pass
            gate.wait()

    with profiling.recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    children = [s for s in rec.spans if s.name == "sls.child"]
    assert sorted((s.parent, s.key) for s in children) == [("sls.a", "a"), ("sls.b", "b")]
    owner = {s.name: s.thread for s in rec.spans if s.name != "sls.child"}
    for s in children:
        assert s.thread == owner[s.parent]
    assert owner["sls.a"] != owner["sls.b"]


def test_start_and_stop_guard_and_open_span_is_dropped():
    rec = profiling.start_recording()
    with pytest.raises(RuntimeError, match="already"):
        profiling.start_recording()
    with profiling.span("sls.closed"):
        pass
    with profiling.span("sls.straddles"):
        assert profiling.stop_recording() is rec
    with pytest.raises(RuntimeError, match="not being recorded"):
        profiling.stop_recording()
    assert [s.name for s in rec.spans] == ["sls.closed"]


def test_sync_notes_are_counted_by_span_and_settings_restored(monkeypatch):
    """The counter's own path, on a stand-in for the card: torch's note
    is counted, not shown; another warning is still shown; the mode, the
    filters and ``showwarning`` are put back."""
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now={"warn": 1}.get(m, m)))
    filters, shown = list(warnings.filters), warnings.showwarning
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        with profiling.recording() as rec:
            assert mode["now"] == 1
            for _ in range(2):  # "always": a repeat at one line counts again
                warnings.warn(profiling.SYNC_MESSAGE)
            with profiling.span("sls.fetch"):
                warnings.warn(profiling.SYNC_MESSAGE)
                with profiling.keyed("u3"):
                    warnings.warn(profiling.SYNC_MESSAGE)
            warnings.warn("something else")
    assert mode["now"] == 0
    assert rec.counts == {"sls.sync": 4, "sls.sync.sls.fetch": 2}
    assert [str(w.message) for w in seen] == ["something else"]
    assert warnings.filters == filters and warnings.showwarning is shown


# -- the scoring paths ----------------------------------------------------------

def _score_file(model, wavs, ids, path):
    loader = ArrayLoader(wavs, None, utt_ids=ids, batch_size=BATCH)
    n = produce_scores(make_eval_step(model, device="cpu"), loader, path)
    return n, path.read_bytes()


def test_produce_scores_records_each_span_once_a_batch(tiny_model, tmp_path):
    n_rows = 3 * BATCH + 2  # a short tail batch too
    wavs, ids = _wavs(n_rows), [f"utt{i:02d}" for i in range(n_rows)]
    n_off, off = _score_file(tiny_model, wavs, ids, tmp_path / "off.txt")
    with profiling.recording() as rec:
        n_on, on = _score_file(tiny_model, wavs, ids, tmp_path / "on.txt")
    assert n_on == n_off == n_rows and on == off
    keys = ids[::BATCH]
    for name in BATCH_SPANS:
        assert [s.key for s in rec.spans if s.name == name] == keys, name
    for key in keys:
        assert [s.name for s in rec.spans if s.key == key] == BATCH_SPANS
    by = {(s.name, s.key): s for s in rec.spans}
    parents = {name: by[(name, keys[0])].parent for name in BATCH_SPANS}
    assert parents == {"sls.load": None, "sls.upload": None, "sls.frontend": "sls.dispatch",
                       "sls.layers": "sls.dispatch", "sls.sae": "sls.dispatch",
                       "sls.head": "sls.dispatch", "sls.dispatch": None,
                       "sls.fetch": None, "sls.write": None}
    # depth-2 pipeline: batch 0 is fetched after batch 2's dispatch
    assert by[("sls.dispatch", keys[2])].end_ns <= by[("sls.fetch", keys[0])].start_ns
    assert by[("sls.upload", keys[1])].end_ns <= by[("sls.frontend", keys[1])].start_ns


def test_unwindowed_scoring_records_each_span_once_a_clip(tiny_model):
    enc = tiny_model.config.encoder
    targets = (64, 128)
    lengths = (700, 1800, 3000, 5200)  # both buckets, and one past the largest
    clips = [(f"clip{i}", _wavs(1, n, seed=i)[0]) for i, n in enumerate(lengths)]

    def run():
        return list(score_utterances_unwindowed(tiny_model, iter(clips), enc, targets,
                                                device="cpu"))

    off = run()
    with profiling.recording() as rec:
        on = run()
    assert on == off
    ids = [c for c, _ in clips]
    for name in CLIP_SPANS:
        assert [s.key for s in rec.spans if s.name == name] == ids, name
    for key in ids:
        assert [s.name for s in rec.spans if s.key == key] == CLIP_SPANS
    inner = [s for s in rec.spans if s.name in ("sls.frontend", "sls.layers", "sls.sae",
                                                "sls.head")]
    assert {s.parent for s in inner} == {"sls.dispatch"}
    assert {s.parent for s in rec.spans if s not in inner} == {None}


def test_detector_forward_spans(tiny_model):
    wav = torch.from_numpy(_wavs(2))
    with profiling.recording() as rec, torch.inference_mode():
        with profiling.span("sls.dispatch", key="fwd"):
            out = tiny_model(wav)
    assert [s.name for s in rec.spans] == ["sls.frontend", "sls.layers", "sls.sae",
                                           "sls.head", "sls.dispatch"]
    assert {s.key for s in rec.spans} == {"fwd"}
    with torch.inference_mode():
        assert torch.equal(out["log_probs"], tiny_model(wav)["log_probs"])


# -- the profiler's capture -------------------------------------------------------

def test_trace_writes_spans_on_its_own_time_base(tiny_model, tmp_path):
    wav = torch.from_numpy(_wavs(2))
    with profiling.trace(tmp_path) as t, torch.inference_mode():
        assert profiling.recording_on()
        with profiling.span("sls.dispatch", key="b0"):
            tiny_model.score(wav)
    assert not profiling.recording_on()
    events = json.loads(t.path.read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("cat") == profiling.SPAN_CATEGORY}
    assert set(spans) == {"sls.frontend", "sls.layers", "sls.sae", "sls.head", "sls.dispatch"}
    assert spans["sls.sae"]["args"] == {"parent": "sls.dispatch", "key": "b0"}
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in spans.values())
    # the custom op of kernel row 1 runs inside sls.sae, on the trace's clock
    (op,) = [e for e in events
             if e.get("cat") == "cpu_op" and e["name"] == "sls_tpu_torch::sae_encode_topk"]
    sae = spans["sls.sae"]
    assert sae["ts"] <= op["ts"] and op["ts"] + op["dur"] <= sae["ts"] + sae["dur"]
    hist = profiling.op_histogram(tmp_path, lane_filter=profiling.SPAN_CATEGORY, group=False)
    assert {k: v["count"] for k, v in hist.items()} == {k: 1 for k in spans}
    assert hist["sls.dispatch"]["ms"] >= hist["sls.layers"]["ms"]


def test_trace_leaves_a_recording_it_did_not_start(tmp_path):
    with profiling.recording() as rec:
        with profiling.trace(tmp_path) as t:
            with profiling.span("sls.mine"):
                torch.zeros(4).sum()
        assert profiling.recording_on()
    assert [s.name for s in rec.spans] == ["sls.mine"]
    events = json.loads(t.path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]


def test_profile_diff_reads_the_span_lane(tiny_model, tmp_path, capsys):
    wav = torch.from_numpy(_wavs(2))
    for name, calls in (("a", 1), ("b", 3)):
        with profiling.trace(tmp_path / name), torch.inference_mode():
            for _ in range(calls):
                tiny_model.score(wav)
    assert profile_diff.main([str(tmp_path / "a"), str(tmp_path / "b"), "--lane",
                              profiling.SPAN_CATEGORY, "--json", "--min_ms", "0"]) == 0
    rows = {r["op"]: r for r in json.loads(capsys.readouterr().out)}
    assert {n: (r["a_count"], r["b_count"]) for n, r in rows.items()} == {
        n: (1, 3) for n in ("sls.frontend", "sls.layers", "sls.sae", "sls.head")}


def test_profile_steps_capture_holds_the_training_forward_spans(tmp_path):
    exp = C.ExperimentConfig(
        model=C.ModelConfig(encoder=C.tiny_xlsr_config(), classifier_hidden=32,
                            sae=C.SAEConfig(activation_dim=64, dict_size=256, k=32)),
        train=C.TrainConfig(batch_size=BATCH, cut_length=WAV_LEN,
                            rawboost=C.RawBoostConfig(algo=0)))
    trainer = Trainer(exp, tmp_path, tensorboard=False, profile_steps=2, device="cpu")
    trainer.init_state()
    labels = np.arange(3 * BATCH) % 2
    trainer.train_epoch(ArrayLoader(_wavs(3 * BATCH), labels, batch_size=BATCH), 0)
    assert trainer._profiled and not profiling.recording_on()
    hist = profiling.op_histogram(tmp_path / "profile", lane_filter=profiling.SPAN_CATEGORY)
    # the two profiled steps' forwards (the loader's batches are built
    # ahead, so their sls.load may fall outside the capture)
    assert {k: v["count"] for k, v in hist.items() if k != "sls.load"} == {
        name: 2 for name in ("sls.frontend", "sls.layers", "sls.sae", "sls.head")}


# -- on the card ----------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_span_and_device_trace_share_one_clock():
    """A kernel run between two synchronizes inside a span lies inside
    the span on the profiler's device lane, within 50 us at each end.
    (``torch.cuda.synchronize`` itself is not one of the waits that the
    sync debug mode reports.)"""
    _cuda_or_skip()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)  # the sleep kernel loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            for _ in range(5):
                with profiling.span("sls.clock"):
                    torch.cuda.synchronize()
                    torch.cuda._sleep(2_000_000)  # ~1 ms at the card's clock
                    torch.cuda.synchronize()
    # the sleep kernels: the only device operations of a millisecond or so
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and e.duration_ns() > SLEEP_MIN_NS)
    spans = sorted((s.start_ns, s.end_ns) for s in rec.spans)
    assert len(kernels) == len(spans) == 5
    offsets = [(k0 - s0, s1 - k1) for (k0, k1), (s0, s1) in zip(kernels, spans)]
    print(f"\nspan start to kernel start, kernel end to span end (ns): {offsets}")
    assert all(a >= -CLOCK_SLACK_NS and b >= -CLOCK_SLACK_NS for a, b in offsets)


@pytest.mark.cuda
def test_pageable_upload_and_fetch_each_count_one_sync():
    _cuda_or_skip()
    host = np.ones((36, 64600), np.int16)
    torch.from_numpy(host).to("cuda").float().sum().item()  # warm
    with profiling.recording() as rec:
        with profiling.span("sls.upload"):
            w = torch.from_numpy(host).to("cuda")
        with profiling.span("sls.dispatch"):
            y = w.float().sum(dim=1)
        with profiling.span("sls.fetch"):
            y.cpu()
        with profiling.span("sls.pinned"):
            torch.from_numpy(host).pin_memory().to("cuda", non_blocking=True)
    print(f"\ncounts: {rec.counts}")
    assert rec.counts["sls.sync.sls.upload"] == 1
    assert rec.counts["sls.sync.sls.fetch"] == 1
    assert "sls.sync.sls.dispatch" not in rec.counts
