"""ctypes binding to the native FLAC decoder (``native/flac/flac_decoder.cc``),
counterpart of ``sls_tpu/data/flac.py``.

The library is built at first use with ``g++`` (the flags of
``native/flac/Makefile``) into ``build/sls_tpu_torch/<hash>/libslsaudio.so``,
where ``<hash>`` covers the source text and the flags, so an edit
rebuilds and an unchanged tree reuses the build.  A library that another
build left in ``native/flac/`` is never loaded.  A failed build raises:
there is no pure-Python decoder behind it.

- ``read_flac_rate(path)`` / ``read_flac(path)``: one file, float32 mono
  at its own rate;
- ``decode_batch(paths, cut)``: a batch decoded by native threads, each
  row cropped or repeat-tiled to ``cut`` samples, float32 or the int16
  wire (converted inside the workers); a file that fails to decode is a
  zero row, a missing file raises ``FileNotFoundError``, and a row at
  another rate is decoded again whole and resampled on the host.

Nothing here builds or loads at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "flac" / "flac_decoder.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sls_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
LIB_NAME = "libslsaudio.so"

# 10 minutes at 16 kHz: longer than any clip of the supported corpora
MAX_SAMPLES = 16000 * 600

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path(source: Optional[bytes] = None) -> Path:
    """Where the library built from ``source`` (default: the checkout's
    ``flac_decoder.cc``) lives."""
    text = SOURCE.read_bytes() if source is None else source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(text)
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the decoder unless its library exists; returns its path.
    Raises with the compiler's output on failure."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # a per-process name, then a rename: a concurrent build never loads a
    # half-written library
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c_char_pp, c_float_p = ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.slsaudio_decode_flac_file.restype = ctypes.c_long
        lib.slsaudio_decode_flac_file.argtypes = [ctypes.c_char_p, c_float_p, ctypes.c_long,
                                                  c_int_p]
        lib.slsaudio_decode_batch_rates.restype = ctypes.c_int
        lib.slsaudio_decode_batch_rates.argtypes = [c_char_pp, ctypes.c_int, ctypes.c_long,
                                                    c_float_p, c_int_p, ctypes.c_int]
        lib.slsaudio_decode_batch_rates_i16.restype = ctypes.c_int
        lib.slsaudio_decode_batch_rates_i16.argtypes = [
            c_char_pp, ctypes.c_int, ctypes.c_long, ctypes.POINTER(ctypes.c_int16), c_int_p,
            ctypes.c_int]
        _lib = lib
        return lib


def read_flac_rate(path: PathLike, max_samples: int = MAX_SAMPLES) -> Tuple[np.ndarray, int]:
    """(float32 mono in [-1, 1], sample rate) of one FLAC file.  Raises
    ``FileNotFoundError`` for a missing file and ``ValueError`` for one
    that does not decode."""
    lib = _load()
    buf = np.empty(max_samples, np.float32)
    rate = ctypes.c_int(0)
    n = lib.slsaudio_decode_flac_file(str(path).encode(),
                                      buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                      max_samples, ctypes.byref(rate))
    if n < 0:
        # a missing file is a fault of the setup (a wrong database path),
        # which load_audio re-raises; a present file that fails is corrupt
        if not os.path.exists(path):
            raise FileNotFoundError(f"no such audio file: {path}")
        raise ValueError(f"failed to decode FLAC: {path}")
    return buf[:n].copy(), int(rate.value)


def read_flac(path: PathLike, max_samples: int = MAX_SAMPLES) -> np.ndarray:
    """One FLAC file as float32 mono in [-1, 1]."""
    return read_flac_rate(path, max_samples)[0]


def decode_batch(paths: Sequence[PathLike], cut: int, n_threads: int = 0,
                 target_sr: int = 16000, dtype: str = "float32") -> np.ndarray:
    """[N, cut] rows of ``dtype`` (float32, or the int16 wire) from one
    native call: each file decoded, cropped or repeat-tiled to ``cut``.

    The native workers decode only the first ``cut`` samples of a file.
    A row whose rate is not ``target_sr`` is decoded again whole, resampled
    to 16 kHz and tiled on the host (``target_sr=0`` skips the check).  A
    file that fails to decode (rate 0) is a zero row; a missing one raises
    ``FileNotFoundError``."""
    from sls_tpu_torch.data.audio import pad_or_tile, resample_to_16k
    from sls_tpu_torch.data.pipeline import to_wire

    lib = _load()
    n = len(paths)
    rates = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    rates_p = rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    if dtype == "int16":
        out = np.zeros((n, cut), np.int16)
        lib.slsaudio_decode_batch_rates_i16(
            arr, n, cut, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), rates_p, n_threads)
    elif dtype == "float32":
        out = np.zeros((n, cut), np.float32)
        lib.slsaudio_decode_batch_rates(
            arr, n, cut, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rates_p, n_threads)
    else:
        raise ValueError(f"unknown decode dtype: {dtype!r}")
    failed = np.nonzero(rates == 0)[0]
    if failed.size:
        # stat only the failed rows: a missing one means a wrong path, not
        # a corrupt file, and must not score as silence
        missing = [str(paths[i]) for i in failed if not os.path.exists(paths[i])]
        if missing:
            raise FileNotFoundError(
                f"{len(missing)} of {n} batch files do not exist "
                f"(first: {', '.join(missing[:3])}) — check the database path")
    if target_sr:
        for i in np.nonzero((rates != 0) & (rates != target_sr))[0]:
            wav, sr = read_flac_rate(paths[i])
            row = pad_or_tile(resample_to_16k(wav, sr), cut)
            out[i] = to_wire(row, "int16") if dtype == "int16" else row
    return out
