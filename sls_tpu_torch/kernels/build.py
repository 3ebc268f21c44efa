"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own into ``build/sls_tpu_torch/<hash>/lib<name>.so`` at first use, where
``<hash>`` is taken over every source and shared header (``csrc/*.cuh``,
which the sources include) and the compiler flags, so an edit rebuilds
and an unchanged tree reuses the build.  All
sources compile in parallel (one ``nvcc`` each).  The libraries are
loaded with ``ctypes``; wrappers declare every pointer and the stream
as ``c_void_p`` and raise when an entry returns a nonzero
``cudaError_t``.

Nothing here runs at import: the CPU-only test machines import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "sls_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# the loaded libraries: a process loads each one once
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    """The sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    """The headers the sources share."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, in parallel;
    returns the build directory.  Raises with nvcc's output on failure."""
    out_dir = build_dir()
    todo = [s for s in sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        # build under a per-process name, then rename: concurrent
        # builders (test workers) never see a half-written library
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{src.stem}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: serving replicas
    launch from host threads of their own (``serve/scorer.py``)."""
    with _count_lock:
        wrapper.launches += 1
