"""Standalone odometry node equivalent (port of
``shermbot_navigation_tpu.pipeline.odometry``; the reference ``odometer``
node, ``rigid2d/src/odometer.cpp``): joint states -> twist -> configuration
update -> odometry message, plus the ``set_pose`` teleport service. The
pipeline driver folds this logic in; this module is for consumers that
only want odometry.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import diff_drive as dd


class OdometryOutput(NamedTuple):
    """The nav_msgs/Odometry payload (odometer.cpp:145-158): pose + the
    body twist that produced this update."""

    pose: torch.Tensor   # (..., 3) [th, x, y]
    twist: torch.Tensor  # (..., 3) [dth, dx, dy] per update interval


def update(params: dd.DiffDriveParams, state: dd.DiffDriveState,
           joint_states) -> Tuple[dd.DiffDriveState, OdometryOutput]:
    """One joint-state callback (odometer.cpp:104-161)."""
    tw = dd.wheels_to_twist(params, joint_states - state.wheels)
    new = dd.step(params, state, joint_states)
    return new, OdometryOutput(pose=new.pose, twist=tw)


def set_pose(state: dd.DiffDriveState, th, x, y) -> dd.DiffDriveState:
    """The set_pose service: rebuild the odometry at the requested pose
    with zeroed wheels (odometer.cpp:169-187)."""
    return dd.teleport(state, th, x, y)
