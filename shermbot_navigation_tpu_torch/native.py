"""ctypes bindings to the shared C++ host engine (``native/baseline`` at
the repository root), the part the port's CLI uses: one in-process world
of the reference pipeline (tube-world sim, odometry, perception, dense
EKF-SLAM), tick by tick.

The port's own copy of what it needs of ``shermbot_navigation_tpu.native``
(that package is the reference and is not imported here); both load the
same library, built on demand by ``make`` (g++, no other dependency).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native" / "baseline"
ABI_VERSION = 3

_D = ctypes.c_double
_DP = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int
_P = ctypes.c_void_p


@functools.cache
def library() -> ctypes.CDLL:
    """Run ``make`` (incremental) and load ``libshermbot_host.so``."""
    try:
        subprocess.run(["make", "libshermbot_host.so"], cwd=NATIVE_DIR,
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"building libshermbot_host failed:\n{e.stderr}") from e
    lib = ctypes.CDLL(str(NATIVE_DIR / "libshermbot_host.so"))
    sigs = {
        "sb_engine_create_custom": (_P, [_DP, _DP, _I, _I, _I, _I, _I, _D,
                                         _D, _D, _D, _D, _D, _D, _I, _I,
                                         ctypes.c_uint64]),
        "sb_engine_destroy": (None, [_P]),
        "sb_engine_tick": (_I, [_P, _D, _D]),
        "sb_engine_poses": (None, [_P, _DP]),
        "sb_engine_seen": (_I, [_P]),
        "sb_engine_ate": (_D, [_P]),
        "sb_engine_ate_odom": (_D, [_P]),
        "sb_abi_version": (_I, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    if lib.sb_abi_version() != ABI_VERSION:
        raise RuntimeError("libshermbot_host ABI mismatch")
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_DP)


class HostEngine:
    """One world of the native pipeline, closed by :meth:`close` (or a
    ``with`` block). Arguments as the reference engine's custom scenario:
    the tubes, the landmark capacity, association, sensor and noise
    settings, the circle command ``cmd = (w, v)`` and the run length."""

    def __init__(self, *, tubes, capacity, known_assoc, use_lidar,
                 max_range, tube_var, twist_noise, slip_min, slip_max,
                 cmd, steps, deterministic=True, seed=12345):
        lib = library()
        tubes = np.ascontiguousarray(tubes, dtype=np.float64)
        tx = np.ascontiguousarray(tubes[:, 0])
        ty = np.ascontiguousarray(tubes[:, 1])
        self._lib = lib
        self._h = lib.sb_engine_create_custom(
            _dptr(tx), _dptr(ty), len(tubes), int(capacity),
            int(known_assoc), int(use_lidar), 0, float(max_range),
            float(tube_var), float(twist_noise), float(slip_min),
            float(slip_max), float(cmd[0]), float(cmd[1]), int(steps),
            int(deterministic), seed)

    def close(self) -> None:
        if self._h:
            self._lib.sb_engine_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tick(self, cmd_w, cmd_v) -> int:
        """One 10 Hz SLAM tick; returns landmarks seen so far."""
        return self._lib.sb_engine_tick(self._h, float(cmd_w), float(cmd_v))

    @property
    def poses(self) -> dict:
        """(th, x, y) of truth / odom / slam."""
        out = np.empty(9)
        self._lib.sb_engine_poses(self._h, _dptr(out))
        return {"truth": tuple(out[0:3]), "odom": tuple(out[3:6]),
                "slam": tuple(out[6:9])}

    @property
    def n_seen(self) -> int:
        return self._lib.sb_engine_seen(self._h)

    @property
    def ate(self) -> float:
        return self._lib.sb_engine_ate(self._h)

    @property
    def ate_odom(self) -> float:
        return self._lib.sb_engine_ate_odom(self._h)
