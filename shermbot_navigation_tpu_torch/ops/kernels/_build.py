"""Build and load the package's hand-written CUDA kernels.

The sources are ``csrc/*.cu`` of this package, each with a plain C entry
point. They are compiled together, at first use and without network, by
``nvcc`` for ``sm_90a`` into one shared library under the package's
``_build/`` directory (listed in ``.gitignore``), keyed by a hash of the
sources and flags, and loaded with ``ctypes``. Nothing is built when the
package is imported, so the CPU tests import every module without ``nvcc``.

Every pointer and the stream travel as ``ctypes.c_void_p``; each C entry
returns ``cudaGetLastError()`` after its launch and :func:`check` raises on
a nonzero code. Kernels launch on ``torch.cuda.current_stream()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points: name -> argtypes (restype is int).
SIGNATURES = {
    "grid_update": [_P] * 7 + [_I] * 3 + [_P],
    "seq_scan_known": [_P] * 24 + [_I] * 4 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is not None and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile (if this source hash is not built yet) and load the kernel
    library. Returns ``{"lib", "path", "seconds", "ptxas"}``; ``seconds``
    is 0 and ``ptxas`` empty when the library was already on disk."""
    sources = _sources()
    path = BUILD_DIR / f"libshermbot_kernels_{_key(sources)}.so"
    seconds, ptxas = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        ptxas = proc.stderr
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return {"lib": lib, "path": str(path), "seconds": seconds,
            "ptxas": ptxas}


def library():
    return build()["lib"]


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
