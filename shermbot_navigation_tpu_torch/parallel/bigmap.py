"""Large synthetic-map workload (BASELINE config 4) at batch 1 (port of
``shermbot_navigation_tpu.parallel.bigmap``).

One robot drives a constant-twist arc over a grid of N landmarks; each tick
it observes M landmarks from a schedule that sweeps the whole map (with
known ids every landmark is initialized in the first ceil(N/M) ticks and
only updated after that). Ground truth is the closed-form arc, and each
tick's measurements are generated on the state's device from it.
:func:`make_runner` associates by id; :func:`make_unknown_runner` drops
the ids and associates by the reference's Mahalanobis first-hit gates.

The kernels route as in ``ops/kernels``: the CUDA kernels for a state on
the card, the plain versions for a state on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.ekf_slam import EKFConfig, cartesian2polar
from ..ops import se2
from . import blocked_ekf


class BigMapWorkload(NamedTuple):
    landmarks: torch.Tensor   # (N, 2) true positions
    cmd: torch.Tensor         # (T, 3) command twists
    schedule: torch.Tensor    # (T, M) landmark ids observed per tick


def make_workload(N: int, T: int, M: int, spacing: float = 2.0,
                  dtype=torch.float32, device="cpu") -> BigMapWorkload:
    """Grid of N landmarks, a looping robot, and a schedule that sweeps the
    ids so every landmark is initialized and revisited (the JAX
    ``make_workload``, whose key draws nothing)."""
    side = math.ceil(math.sqrt(N))
    ii = torch.arange(N, device=device, dtype=torch.float64)
    lms = torch.stack([(torch.remainder(ii, side) - side / 2) * spacing,
                       (torch.div(ii, side, rounding_mode="floor")
                        - side / 2) * spacing], dim=-1).to(dtype)
    w = 2 * math.pi / max(T, 1)
    cmd = torch.tensor([w, 0.1, 0.0], dtype=dtype, device=device
                       ).expand(T, 3).contiguous()
    t_idx = torch.arange(T, device=device)[:, None]
    schedule = (t_idx * M + torch.arange(M, device=device)[None, :]) % N
    return BigMapWorkload(landmarks=lms, cmd=cmd,
                          schedule=schedule.to(torch.int32))


def _true_pose(cmd, t):
    """Closed-form pose ``[th, x, y]`` after ``t`` (a tensor of cmd's
    dtype) constant-twist ticks."""
    w, v = cmd[0, 0], cmd[0, 1]
    th = w * t
    r = v / w
    x = r * torch.sin(th)
    y = r * (1.0 - torch.cos(th))
    return torch.stack([th, x, y])


def measurements(wl: BigMapWorkload, t: int):
    """Tick ``t``'s known-association measurements: ``(zs (M, 2),
    ids (M,) int32, twist (3,))``. The EKF predicts from pose(t) to
    pose(t+1) before updating, so they are taken at pose(t+1)."""
    dtype = wl.cmd.dtype
    tt = torch.tensor(float(t), dtype=dtype, device=wl.cmd.device) + 1.0
    pose = _true_pose(wl.cmd, tt)
    ids = wl.schedule[t % wl.schedule.shape[0]]
    lm = wl.landmarks[ids.long()]
    dx = lm[:, 0] - pose[1]
    dy = lm[:, 1] - pose[2]
    zs = cartesian2polar(dx, dy)
    zs = torch.stack([zs[:, 0], se2.normalize_angle(zs[:, 1] - pose[0])],
                     dim=-1)
    return zs, ids, wl.cmd[t % wl.cmd.shape[0]]


def make_runner(cfg: EKFConfig, M: int, device,
                seq_kernel: bool | None = None,
                grid_kernel: bool | None = None):
    """Build ``run(state, workload, Q, R, t0, ticks) -> state``: the
    deferred tick applied ``ticks`` times at batch 1, measurements made on
    the device each tick. The grid is updated in place."""
    step = blocked_ekf.make_deferred_step(cfg, M, device,
                                          seq_kernel=seq_kernel,
                                          grid_kernel=grid_kernel)
    valid = torch.ones((1, M), dtype=torch.bool, device=device)

    def run(state, wl: BigMapWorkload, Q, R, t0: int, ticks: int):
        for t in range(t0, t0 + ticks):
            zs, ids, tw = measurements(wl, t)
            state = step(state, tw[None], zs[None], valid, ids[None], Q, R)
        return state

    return run


def make_unknown_runner(cfg: EKFConfig, M: int, device,
                        seq_kernel: bool | None = None,
                        grid_kernel: bool | None = None, gate_margins=None):
    """Like :func:`make_runner` with UNKNOWN association: the same
    measurements without their ids, each gated by the first-hit
    Mahalanobis scan of the deferred unknown tick (``gate_margins`` as in
    ``blocked_ekf.make_deferred_step``)."""
    step = blocked_ekf.make_deferred_step(cfg, M, device, known=False,
                                          seq_kernel=seq_kernel,
                                          grid_kernel=grid_kernel,
                                          gate_margins=gate_margins)
    valid = torch.ones((1, M), dtype=torch.bool, device=device)

    def run(state, wl: BigMapWorkload, Q, R, t0: int, ticks: int):
        for t in range(t0, t0 + ticks):
            zs, _, tw = measurements(wl, t)
            state = step(state, tw[None], zs[None], valid, Q, R)
        return state

    return run


def noise(dtype=torch.float32, device="cpu"):
    """``run_bigmap``'s process and measurement noise: Q = diag(1e-4),
    R = diag(1e-3)."""
    Q = torch.diag(torch.tensor([1e-4, 1e-4, 1e-4], dtype=dtype,
                                device=device))
    R = torch.diag(torch.tensor([1e-3, 1e-3], dtype=dtype, device=device))
    return Q, R


def run_bigmap(N: int = 2048, T: int = 32, M: int = 8, batch: int = 1,
               dtype=torch.float32, device="cpu",
               seq_kernel: bool | None = None,
               grid_kernel: bool | None = None):
    """End-to-end config-4 run at batch 1; returns (final BlockedState,
    workload)."""
    if batch != 1:
        raise NotImplementedError(
            "the port runs config 4 at batch 1; batched and map-sharded "
            "runs are ROADMAP queue 1 item 9 / item 12")
    cfg = EKFConfig(num_landmarks=N)
    wl = make_workload(N, T, M, dtype=dtype, device=device)
    runner = make_runner(cfg, M, device, seq_kernel=seq_kernel,
                         grid_kernel=grid_kernel)
    state = blocked_ekf.init(cfg, 1, dtype=dtype, device=device)
    Q, R = noise(dtype, device)
    return runner(state, wl, Q, R, 0, T), wl
