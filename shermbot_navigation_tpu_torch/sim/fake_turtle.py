"""Minimal kinematic robot simulator -- no noise, no world, no lidar (port
of ``shermbot_navigation_tpu.sim.fake_turtle``).

The reference ``fake_turtle`` node (``rigid2d/src/fake_turtle.cpp``):
commanded twist -> wheel velocities -> integrated wheel angles -> joint
states, with the configuration updated from the same (noiseless) wheel
angles. The node's 1 Hz loop (fake_turtle.cpp:52) becomes an explicit
``dt``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import diff_drive as dd


class FakeTurtleState(NamedTuple):
    drive: dd.DiffDriveState


def init_state(dtype=torch.float32, device=None) -> FakeTurtleState:
    """At the origin; ``device=None`` is the card."""
    return FakeTurtleState(drive=dd.init_state(dtype=dtype, device=device))


def step(params: dd.DiffDriveParams, state: FakeTurtleState, cmd_twist, dt
         ) -> Tuple[FakeTurtleState, torch.Tensor]:
    """One tick: returns (state, joint_states) -- the published wheel
    angles (ref fake_turtle.cpp:95-128)."""
    wheels = state.drive.wheels
    u = dd.twist_to_wheels(params, torch.as_tensor(
        cmd_twist, dtype=wheels.dtype, device=wheels.device))
    wheels = wheels + u * dt
    return FakeTurtleState(drive=dd.step(params, state.drive, wheels)), wheels
