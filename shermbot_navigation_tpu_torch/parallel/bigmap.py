"""Large synthetic-map workload (BASELINE config 4) for B worlds (port of
``shermbot_navigation_tpu.parallel.bigmap`` at map=1).

One robot a world drives a constant-twist arc over a grid of N landmarks;
each tick it observes M landmarks from a schedule that sweeps the whole
map (with known ids every landmark is initialized in the first ceil(N/M)
ticks and only updated after that). Ground truth is the closed-form arc,
and each tick's measurements are generated on the state's device from it
and broadcast to every world, as in the JAX package. :func:`make_runner`
associates by id; :func:`make_unknown_runner` drops the ids and associates
by the reference's Mahalanobis first-hit gates. Either runs the deferred
tick (one grid pass a tick, the default) or the sequential one
(``deferred=False``: one grid pass a measurement), on the global state,
or with ``mesh=`` (``parallel/mesh.py``) on this process's map shards of
it (``blocked_ekf.shard_state``); with a data axis each process's worlds
are its own.

The kernels route as in ``ops/kernels``: the CUDA kernels for a state on
the card, the plain versions for a state on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig, cartesian2polar
from ..ops import se2
from . import blocked_ekf


class BigMapWorkload(NamedTuple):
    landmarks: torch.Tensor   # (N, 2) true positions
    cmd: torch.Tensor         # (T, 3) command twists
    schedule: torch.Tensor    # (T, M) landmark ids observed per tick


def make_workload(N: int, T: int, M: int, spacing: float = 2.0,
                  dtype=torch.float32, device=None) -> BigMapWorkload:
    """Grid of N landmarks, a looping robot, and a schedule that sweeps the
    ids so every landmark is initialized and revisited (the JAX
    ``make_workload``, whose key draws nothing). ``device=None`` is the
    card (``device.resolve``)."""
    device = resolve(device)
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
    # filled on the device: a tensor built from a host number would be a
    # host-to-device copy, which waits for the stream and so serializes
    # the host's launches with the device's work, once a tick
    tt = torch.full((), float(t) + 1.0, dtype=dtype, device=wl.cmd.device)
    pose = _true_pose(wl.cmd, tt)
    ids = wl.schedule[t % wl.schedule.shape[0]]
    lm = wl.landmarks[ids.long()]
    dx = lm[:, 0] - pose[1]
    dy = lm[:, 1] - pose[2]
    zs = cartesian2polar(dx, dy)
    zs = torch.stack([zs[:, 0], se2.normalize_angle(zs[:, 1] - pose[0])],
                     dim=-1)
    return zs, ids, wl.cmd[t % wl.cmd.shape[0]]


def _make_step(cfg, M, device, known, deferred, gate_margins=None,
               mesh=None):
    if deferred:
        return blocked_ekf.make_deferred_step(
            cfg, M, device, known=known, gate_margins=gate_margins, mesh=mesh)
    if gate_margins is not None:
        raise ValueError("the sequential tick has no gate margins")
    return blocked_ekf.make_sequential_step(cfg, M, device, known=known,
                                            mesh=mesh)


def make_runner(cfg: EKFConfig, M: int, device, batch: int = 1,
                deferred: bool = True, mesh=None):
    """Build ``run(state, workload, Q, R, t0, ticks) -> state``: the tick
    applied ``ticks`` times to a state of ``batch`` worlds, the
    measurements made on the device each tick and broadcast to every
    world. ``deferred=True`` is ``blocked_ekf.make_deferred_step`` (the
    kernels, once a tick for all worlds), ``False``
    ``blocked_ekf.make_sequential_step``; the same semantics. With
    ``mesh`` the state is this process's map shards. The grid is updated
    in place."""
    step = _make_step(cfg, M, device, True, deferred, mesh=mesh)
    valid = torch.ones((batch, M), dtype=torch.bool, device=device)

    def run(state, wl: BigMapWorkload, Q, R, t0: int, ticks: int):
        for t in range(t0, t0 + ticks):
            zs, ids, tw = measurements(wl, t)
            state = step(state, tw.expand(batch, 3), zs.expand(batch, M, 2),
                         valid, ids.expand(batch, M), Q, R)
        return state

    return run


def make_unknown_runner(cfg: EKFConfig, M: int, device, batch: int = 1,
                        deferred: bool = True, gate_margins=None,
                        mesh=None):
    """Like :func:`make_runner` with UNKNOWN association: the same
    measurements without their ids, each gated by the reference's
    first-hit Mahalanobis scan (``gate_margins`` as in
    ``blocked_ekf.make_deferred_step``, deferred tick only)."""
    step = _make_step(cfg, M, device, False, deferred, gate_margins, mesh)
    valid = torch.ones((batch, M), dtype=torch.bool, device=device)

    def run(state, wl: BigMapWorkload, Q, R, t0: int, ticks: int):
        for t in range(t0, t0 + ticks):
            zs, _, tw = measurements(wl, t)
            state = step(state, tw.expand(batch, 3), zs.expand(batch, M, 2),
                         valid, Q, R)
        return state

    return run


def noise(dtype=torch.float32, device=None):
    """``run_bigmap``'s process and measurement noise: Q = diag(1e-4),
    R = diag(1e-3). ``device=None`` is the card."""
    device = resolve(device)
    Q = torch.diag(torch.tensor([1e-4, 1e-4, 1e-4], dtype=dtype,
                                device=device))
    R = torch.diag(torch.tensor([1e-3, 1e-3], dtype=dtype, device=device))
    return Q, R


def run_bigmap(N: int = 2048, T: int = 32, M: int = 8, batch: int = 1,
               deferred: bool = True, dtype=torch.float32, device=None,
               mesh=None):
    """End-to-end config-4 run of ``batch`` worlds (the JAX
    ``run_bigmap``): on ``device`` (``None``: the card), or over ``mesh``'s
    map shards (on its device), when the returned state is this process's
    shards (``blocked_ekf.unshard_state`` gathers them); returns (final
    BlockedState, workload). ``deferred`` as in :func:`make_runner`."""
    device = resolve(device) if mesh is None else mesh.device
    cfg = EKFConfig(num_landmarks=N)
    wl = make_workload(N, T, M, dtype=dtype, device=device)
    runner = make_runner(cfg, M, device, batch=batch, deferred=deferred,
                         mesh=mesh)
    state = blocked_ekf.init(cfg, batch, dtype=dtype, device=device)
    if mesh is not None:
        state = blocked_ekf.shard_state(state, mesh)
    Q, R = noise(dtype, device)
    return runner(state, wl, Q, R, 0, T), wl
