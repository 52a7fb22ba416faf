"""Build and load the package's hand-written CUDA kernels.

The sources are ``csrc/*.cu`` of this package, each with a plain C entry
point. At first use, without network, each source is compiled by its own
``nvcc`` for ``sm_90a`` into a shared library under the package's
``_build/`` directory (listed in ``.gitignore``), keyed by a hash of the
source and the flags; the ``nvcc`` processes run together, so the build
takes as long as the slowest source. The libraries are loaded with
``ctypes``. Nothing is built when the package is imported, so the CPU tests
import every module without ``nvcc``.

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
import types
from pathlib import Path

import torch

from ...utils import tracing

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry points: name -> (source stem in csrc/, argtypes); restype is int.
SIGNATURES = {
    "grid_update": ("grid_update", [_P] * 7 + [_I] * 5 + [_P]),
    "seq_scan": ("seq_scan",
                 [_P] * 24 + [_I] * 6 + [_F] * 2 + [_I] * 5 + [_P] * 2),
    "seq_scan_max_clusters": ("seq_scan", [_I] * 6),
    "seq_scan_probe": ("seq_scan", [_I] * 4 + [_P, _I, _P]),
    "cov_update": ("cov_update", [_P] * 8 + [_I] * 2 + [_P]),
    "circle_moments": ("circle_fit", [_P] * 5 + [_I] * 2 + [_P]),
    "circle_fit": ("circle_fit", [_P] * 9 + [_I] * 2 + [_P]),
    "circle_fit_tail": ("circle_fit", [_P, _I, _I] + [_P] * 8 + [_I, _P]),
    "circle_fit_trace": ("circle_fit", [_P, _I, _P, _P]),
    "circle_fit_probe": ("circle_fit", [_P, _P, _I, _P]),
    "ekf_tick": ("ekf_tick", [_P] * 15 + [_I] * 6 + [_F] * 2 + [_P]),
    "segment_fit_inputs": ("perception",
                           [_P] * 3 + [_F] * 4 + [_P] * 8 + [_I] * 6 + [_P]),
    "sim_tick": ("sim_tick", [_P] * 2 + [_I] * 8 + [_D] * 2 + [_P]),
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


def _key(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile the sources not built yet (one ``nvcc`` each, all at once)
    and load every kernel library. Returns ``{"lib", "paths", "seconds",
    "ptxas"}``: ``lib`` has one attribute per C entry point, ``seconds``
    is the wall time of the parallel build (0 and empty ``ptxas`` when all
    were on disk). Adds the seconds of the whole call, build and load, to
    the counter ``kernels.load_s`` (``utils/tracing.counters()``)."""
    t_call = time.perf_counter()
    stems = sorted({stem for stem, _ in SIGNATURES.values()})
    paths = {s: BUILD_DIR / f"lib{s}_{_key(CSRC / f'{s}.cu')}.so"
             for s in stems}
    todo = [s for s in stems if not paths[s].exists()]
    seconds, ptxas = 0.0, []
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for s in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{s}.cu")]
            procs[s] = (tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        failed = []
        for s, (tmp, cmd, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}\n{err}")
                continue
            ptxas.append(err)
            os.replace(tmp, paths[s])
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("\n".join(failed))
    libs = {s: ctypes.CDLL(str(p)) for s, p in paths.items()}
    entries = {}
    for name, (stem, argtypes) in SIGNATURES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries[name] = fn
    tracing.count("kernels.load_s", time.perf_counter() - t_call)
    return {"lib": types.SimpleNamespace(**entries),
            "paths": [str(p) for p in paths.values()], "seconds": seconds,
            "ptxas": "".join(ptxas)}


def library():
    return build()["lib"]


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")
