"""The port's file-backed data path against the JAX package's: the native
FLAC binding (``data/flac.py``), WAV reading and ``load_audio``
(``data/audio.py``), the protocol parsers (``data/protocols.py``) and
``DatasetIndex`` / ``BatchLoader`` (``data/pipeline.py``).

FLAC files come from ``tests/flac_encoder.py``: verbatim, constant and
fixed / rice subframes, several frames, stereo, 8 and 44.1 kHz, a file
cut mid-frame (the decoder salvages its prefix), one cut in its header
(it fails: a zero row), and missing files.  Every decoded array and
every batch must equal the JAX package's bit for bit.
"""

import os
import threading
import time
import wave

import numpy as np
import pytest

from sls_tpu.data import audio as jaudio
from sls_tpu.data import flac as jflac
from sls_tpu.data import protocols as jproto
from sls_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from sls_tpu.data.pipeline import DatasetIndex as JaxDatasetIndex
from sls_tpu_torch.data import audio as paudio
from sls_tpu_torch.data import flac as pflac
from sls_tpu_torch.data import protocols as pproto
from sls_tpu_torch.data.pipeline import BatchLoader, DatasetIndex
from tests.flac_encoder import encode_flac

CUT = 1500


def _tone(n, sr=16000, freq=440.0, amp=0.4):
    t = np.arange(n) / sr
    return np.round(amp * 32767 * np.sin(2 * np.pi * freq * t)).astype(np.int64)


def _noise(n, seed, scale=3000):
    return np.random.default_rng(seed).integers(-scale, scale, size=n).astype(np.int64)


def _flac_blobs():
    """name -> FLAC bytes, every subframe kind and rate the decoder sees."""
    walk = np.clip(np.cumsum(np.random.default_rng(3).integers(-40, 41, 2500)), -30000, 30000)
    full = encode_flac([_tone(3000)], block_size=512)
    return {
        "verbatim": encode_flac([_noise(1200, 0)]),
        "constant": encode_flac([np.full(900, -1234, np.int64)], mode="constant"),
        "fixed_o1_r3": encode_flac([walk], mode="fixed", fixed_order=1, rice=3),
        "fixed_o2_r7": encode_flac([walk], mode="fixed", fixed_order=2, rice=7),
        "fixed_o0_r0": encode_flac([_noise(700, 1, 4)], mode="fixed", fixed_order=0, rice=0),
        "multi_frame": encode_flac([_tone(5000)], block_size=1024),
        "long": encode_flac([_noise(4000, 2)], block_size=4096),
        "stereo": encode_flac([_tone(2000, freq=440), _tone(2000, freq=880)]),
        "rate_8k": encode_flac([_tone(1000, sr=8000)], sample_rate=8000),
        "rate_44k": encode_flac([_tone(4410, sr=44100)], sample_rate=44100),
        "cut_mid_frame": full[: len(full) // 2],
        "cut_in_header": full[:20],
    }


@pytest.fixture(scope="module")
def flac_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("db")
    (base / "flac").mkdir()
    names = []
    for name, blob in _flac_blobs().items():
        (base / "flac" / f"{name}.flac").write_bytes(blob)
        names.append(name)
    return base, names


def _write_wav(path, samples: np.ndarray, width: int, channels: int = 1, rate: int = 16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())


def _wav_samples(n, width, channels, seed):
    rng = np.random.default_rng(seed)
    if width == 1:
        return rng.integers(0, 256, size=n * channels, dtype=np.uint8)
    if width == 3:
        return rng.integers(0, 256, size=n * channels * 3, dtype=np.uint8)
    dt = {2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dt))
    return rng.integers(info.min, info.max, size=n * channels, dtype=np.int64).astype(dt)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("wild")
    ids = []
    for i, (width, channels, rate) in enumerate(
            [(2, 1, 16000), (1, 1, 16000), (3, 1, 16000), (4, 1, 16000), (2, 2, 16000),
             (2, 1, 8000), (2, 1, 16000)]):
        name = f"{i}.wav"
        _write_wav(base / name, _wav_samples(600 + 200 * i, width, channels, i), width,
                   channels, rate)
        ids.append(name)
    (base / "corrupt.wav").write_bytes(b"RIFF\x00\x00")
    ids.append("corrupt.wav")
    return base, ids


def test_library_is_built_into_build_dir():
    path = pflac.build()
    assert path == pflac.lib_path() and path.exists()
    assert path.parent.parent.name == "sls_tpu_torch" and path.parent.parent.parent.name == "build"
    assert path.parent.parent.parent.parent == pflac.SOURCE.parents[2]
    text = pflac.SOURCE.read_bytes()
    assert pflac.lib_path(text) == path
    assert pflac.lib_path(text + b"\n// edited\n") != path


@pytest.mark.parametrize("name", list(_flac_blobs()))
def test_read_flac_rate_matches_jax(flac_dir, name):
    base, _ = flac_dir
    path = base / "flac" / f"{name}.flac"
    try:
        want = jflac.read_flac_rate(path)
    except ValueError:
        with pytest.raises(ValueError):
            pflac.read_flac_rate(path)
        return
    got = pflac.read_flac_rate(path)
    assert got[1] == want[1] and got[0].dtype == want[0].dtype
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(pflac.read_flac(path), jflac.read_flac(path))


def test_cut_files_decode_as_documented(flac_dir):
    base, _ = flac_dir
    wav, rate = pflac.read_flac_rate(base / "flac" / "cut_mid_frame.flac")
    assert rate == 16000 and 0 < wav.size < 3000
    with pytest.raises(ValueError):
        pflac.read_flac_rate(base / "flac" / "cut_in_header.flac")


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("target_sr", [16000, 0])
def test_decode_batch_matches_jax(flac_dir, dtype, target_sr):
    base, names = flac_dir
    paths = [base / "flac" / f"{n}.flac" for n in names]
    want = jflac.decode_batch(paths, CUT, n_threads=3, target_sr=target_sr, dtype=dtype)
    got = pflac.decode_batch(paths, CUT, n_threads=3, target_sr=target_sr, dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape == (len(paths), CUT)
    assert np.array_equal(got, want)
    assert not got[names.index("cut_in_header")].any()


def test_missing_files_raise_in_both(flac_dir, tmp_path):
    base, names = flac_dir
    paths = [base / "flac" / f"{names[0]}.flac", tmp_path / "nope.flac"]
    for mod in (jflac, pflac):
        with pytest.raises(FileNotFoundError, match="1 of 2 batch files"):
            mod.decode_batch(paths, CUT)
        with pytest.raises(FileNotFoundError):
            mod.read_flac_rate(tmp_path / "nope.flac")
    with pytest.raises(FileNotFoundError):
        paudio.load_audio(tmp_path / "nope.flac")
    with pytest.raises(ValueError, match="unsupported"):
        paudio.load_audio(tmp_path / "x.mp3")
    with pytest.raises(ValueError, match="unknown decode dtype"):
        pflac.decode_batch(paths[:1], CUT, dtype="uint8")


def test_load_audio_matches_jax(flac_dir, wav_dir):
    fbase, names = flac_dir
    wbase, ids = wav_dir
    paths = [fbase / "flac" / f"{n}.flac" for n in names] + [wbase / i for i in ids]
    for p in paths:
        got, want = paudio.load_audio(p), jaudio.load_audio(p)
        assert got.dtype == want.dtype and np.array_equal(got, want), p
    assert paudio.load_audio(wbase / "corrupt.wav").size == 0
    assert paudio.load_audio(fbase / "flac" / "cut_in_header.flac").size == 0


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_read_wav_rate_matches_jax(wav_dir, width, tmp_path):
    path = tmp_path / f"w{width}.wav"
    _write_wav(path, _wav_samples(500, width, 2, width), width, channels=2, rate=22050)
    got, want = paudio.read_wav_rate(path), jaudio.read_wav_rate(path)
    assert got[1] == want[1] == 22050 and np.array_equal(got[0], want[0])
    assert np.array_equal(paudio.read_wav(path), jaudio.read_wav(path))


@pytest.mark.parametrize("sr", [8000, 22050, 44100, 16000])
def test_resample_matches_jax(sr):
    x = np.random.default_rng(sr).normal(size=777).astype(np.float32)
    assert np.array_equal(paudio.resample_to_16k(x, sr), jaudio.resample_to_16k(x, sr))
    assert np.array_equal(paudio.resample(x, sr, 8000), jaudio.resample(x, sr, 8000))


_PROTOCOLS = {
    "good": "LA_0079 LA_T_1 - - bonafide\n\nLA_0080 LA_T_2 - A01 spoof\n  LA_0081 LA_T_3 - A02 spoof  \n",
    "capital": "LA_0079 LA_T_1 - - Bonafide\n",
    "genuine": "LA_0079 LA_T_1 - - genuine\n",
    "header": "speaker utt x system label\nLA_0079 LA_T_1 - - bonafide\n",
    "columns": "LA_0079 LA_T_1 - bonafide\n",
}


def _outcome(fn, path):
    try:
        return ("ok", fn(path))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", list(_PROTOCOLS))
def test_protocol_parsers_match_jax(case, tmp_path):
    path = tmp_path / f"{case}.txt"
    path.write_text(_PROTOCOLS[case])
    assert _outcome(pproto.parse_train_protocol, path) == _outcome(
        jproto.parse_train_protocol, path)
    got, want = (_outcome(pproto.parse_train_protocol_full, path),
                 _outcome(jproto.parse_train_protocol_full, path))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert [vars(e) for e in got[1]] == [vars(e) for e in want[1]]
    else:
        assert got[1] == want[1]
    assert pproto.parse_eval_list(path) == jproto.parse_eval_list(path)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.utt_ids == w.utt_ids
        assert g.wav.dtype == w.wav.dtype and np.array_equal(g.wav, w.wav)
        assert np.array_equal(g.valid, w.valid)
        assert (g.labels is None) == (w.labels is None)
        if w.labels is not None:
            assert np.array_equal(g.labels, w.labels)


def _flac_indexes(flac_dir, labelled):
    base, names = flac_dir
    if labelled:
        labels = {n: i % 2 for i, n in enumerate(names)}
        return (DatasetIndex.for_train(names, labels, base),
                JaxDatasetIndex.for_train(names, labels, base))
    return DatasetIndex.for_eval(names, base), JaxDatasetIndex.for_eval(names, base)


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch", [5, 4])  # a short tail of 2; 12 files: no tail
def test_flac_batches_match_jax(flac_dir, wire, shuffle, batch):
    p_idx, j_idx = _flac_indexes(flac_dir, labelled=shuffle)
    kw = dict(cut=CUT, shuffle=shuffle, seed=7, num_threads=3, wire_dtype=wire)
    for epoch in (0, 1):
        _same_batches(list(BatchLoader(p_idx, batch, **kw).epoch(epoch)),
                      list(JaxBatchLoader(j_idx, batch, **kw).epoch(epoch)))


@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw"])
def test_wav_batches_match_jax(wav_dir, wire):
    base, ids = wav_dir
    kw = dict(cut=CUT, shuffle=True, num_threads=2, wire_dtype=wire)
    for epoch in (0, 1):
        _same_batches(
            list(BatchLoader(DatasetIndex.for_in_the_wild(ids, base), 3, **kw).epoch(epoch)),
            list(JaxBatchLoader(JaxDatasetIndex.for_in_the_wild(ids, base), 3,
                                **kw).epoch(epoch)))


@pytest.mark.parametrize("limit", [1, 2, 10])
def test_limit_batches_matches_jax(flac_dir, limit):
    p_idx, j_idx = _flac_indexes(flac_dir, labelled=True)
    p = BatchLoader(p_idx, 5, cut=CUT, shuffle=True, limit_batches=limit)
    j = JaxBatchLoader(j_idx, 5, cut=CUT, shuffle=True, limit_batches=limit)
    assert p.num_batches() == j.num_batches() == min(limit, 3)
    _same_batches(list(p.epoch(1)), list(j.epoch(1)))


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_host_shard_matches_jax(flac_dir, drop, rank):
    p_idx, j_idx = _flac_indexes(flac_dir, labelled=True)
    p, j = p_idx.host_shard(rank, 5, drop_remainder=drop), j_idx.host_shard(
        rank, 5, drop_remainder=drop)
    assert p.utt_ids == j.utt_ids and p.paths == j.paths and np.array_equal(p.labels, j.labels)
    assert len(p) == (2 if drop else len(range(rank, 12, 5)))
    _same_batches(list(BatchLoader(p, 2, cut=CUT).epoch(0)),
                  list(JaxBatchLoader(j, 2, cut=CUT).epoch(0)))


def test_decode_threads_spread_over_producers(flac_dir):
    p_idx, _ = _flac_indexes(flac_dir, labelled=False)
    loader = BatchLoader(p_idx, 2, cut=CUT, num_threads=4)
    assert loader.producers_and_decode_threads() == (4, max(1, (os.cpu_count() or 1) // 4))
    assert BatchLoader(p_idx, 2, num_threads=4, decode_threads=3
                       ).producers_and_decode_threads() == (4, 3)


def test_a_consumer_that_breaks_stops_the_producers(flac_dir):
    p_idx, _ = _flac_indexes(flac_dir, labelled=False)
    before = set(threading.enumerate())
    loader = BatchLoader(p_idx, 1, cut=CUT, num_threads=4, prefetch=1)
    done = threading.Event()

    def consume():
        for _ in loader.epoch(0):
            break
        done.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert done.is_set() and not t.is_alive()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [x for x in set(threading.enumerate()) - before
                if x.name.startswith("batch-loader") and x.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left


def test_decode_error_reaches_the_consumer(flac_dir, tmp_path):
    base, names = flac_dir
    index = DatasetIndex.for_eval(names[:2] + ["absent"], base)
    with pytest.raises(FileNotFoundError):
        list(BatchLoader(index, 2, cut=CUT, num_threads=2).epoch(0))
    with pytest.raises(ValueError, match="wire_dtype"):
        BatchLoader(index, 2, wire_dtype="int8")
