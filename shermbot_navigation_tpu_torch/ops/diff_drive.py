"""Differential-drive kinematics (port of
``shermbot_navigation_tpu.ops.diff_drive``; the reference ``DiffDrive``
class, ``rigid2d/src/diff_drive.cpp``). The robot configuration is an
immutable :class:`DiffDriveState` and every op a pure function that
broadcasts over leading batch dimensions.

Conventions (the reference's): wheels ``[left, right]``; twists
``[dth, dx, dy]`` with ``dy == 0`` for diff drive; pose ``[th, x, y]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from . import se2


class DiffDriveParams(NamedTuple):
    """Static geometry (ref ``diff_params.yaml``: wheel_base 0.16,
    wheel_radius 0.033), as 0-dim tensors or floats."""

    wheel_base: torch.Tensor  # distance between wheels [m]
    wheel_rad: torch.Tensor   # wheel radius [m]


class DiffDriveState(NamedTuple):
    """Robot configuration: pose ``[th, x, y]`` + wheel angles
    ``[thL, thR]`` (the private members of the reference ``DiffDrive``)."""

    pose: torch.Tensor    # [..., 3] = [th, x, y]
    wheels: torch.Tensor  # [..., 2] = [thL, thR]


def init_state(th=0.0, x=0.0, y=0.0, thl=0.0, thr=0.0, dtype=torch.float32,
               device=None, batch=()):
    """Fresh configuration (ref ctor ``diff_drive.cpp:21-30``), with
    leading dimensions ``batch``; ``device=None`` is the card."""
    device = resolve(device)
    pose = torch.tensor([th, x, y], dtype=dtype, device=device)
    wheels = torch.tensor([thl, thr], dtype=dtype, device=device)
    return DiffDriveState(pose=pose.expand(*batch, 3).clone(),
                          wheels=wheels.expand(*batch, 2).clone())


def twist_to_wheels(params: DiffDriveParams, twist):
    """Body twist -> wheel velocities ``[uL, uR]`` (ref ``convertTwist``,
    diff_drive.cpp:66-78)::

        uL = -(d/r)*dth + dx/r,   uR = +(d/r)*dth + dx/r,   d = base/2

    ``twist.dy`` is ignored (non-holonomic), as in the reference."""
    d = params.wheel_base / 2.0
    r = params.wheel_rad
    omg, vbx = twist[..., 0], twist[..., 1]
    ul = -(d / r) * omg + vbx / r
    ur = (d / r) * omg + vbx / r
    return torch.stack([ul, ur], dim=-1)


def wheels_to_twist(params: DiffDriveParams, dwheels):
    """Wheel-angle increments ``[dL, dR]`` -> body twist (ref ``getTwist``,
    diff_drive.cpp:80-110)::

        dth = (r/base)*(dR - dL),  dx = (r/2)*(dL + dR),  dy = 0
    """
    dl, dr = dwheels[..., 0], dwheels[..., 1]
    r = params.wheel_rad
    dth = (r / params.wheel_base) * (dr - dl)
    dx = (r / 2.0) * (dl + dr)
    return torch.stack([dth, dx, torch.zeros_like(dx)], dim=-1)


def step(params: DiffDriveParams, state: DiffDriveState, wheels_new
         ) -> DiffDriveState:
    """Advance the configuration to new absolute wheel angles (ref
    ``DiffDrive::operator()``, diff_drive.cpp:111-146): wheel deltas ->
    body twist -> ``integrate_twist`` -> body-frame displacement -> rotated
    into the world frame by the current heading -> accumulated. The heading
    increment is the twist's ``dth`` directly, as in the JAX package."""
    tw = wheels_to_twist(params, wheels_new - state.wheels)
    Tbb = se2.integrate_twist(tw)
    # displacement in the body frame as a "twist" [dth, dx, dy]
    dqb = torch.stack([tw[..., 0], Tbb[..., 2], Tbb[..., 3]], dim=-1)
    # rotate into the world frame: adjoint of pure rotation by the heading
    adj = se2.from_rotation(state.pose[..., 0])
    dq = se2.adjoint_twist(adj, dqb)
    return DiffDriveState(pose=state.pose + dq, wheels=wheels_new)


def nudge(state: DiffDriveState, dx, dy) -> DiffDriveState:
    """Shift the (x, y) location without touching heading or wheels (ref
    ``changeConfig``, diff_drive.cpp:154-159; used for collision slip)."""
    delta = torch.stack([torch.zeros_like(dx), dx, dy], dim=-1)
    return state._replace(pose=state.pose + delta)


def teleport(state: DiffDriveState, th, x, y) -> DiffDriveState:
    """Reset the pose, zeroing the wheel angles (ref ``set_pose`` service
    semantics, odometer.cpp:169-187)."""
    like = state.pose
    pose = torch.stack([torch.as_tensor(v, dtype=like.dtype,
                                        device=like.device)
                        for v in (th, x, y)], dim=-1)
    return DiffDriveState(pose=pose, wheels=torch.zeros_like(state.wheels))
