"""Robot description: the TurtleBot3 burger geometry as typed data (port
of ``shermbot_navigation_tpu.utils.robot``).

The reference ``nuturtle_description`` package (its URDF xacro,
parameterized by ``diff_params.yaml``) defines the geometry every node
reads: wheel_radius 0.033, wheel_base 0.16
(``nuturtle_description/config/diff_params.yaml:2-3``), wheel joints at
+-wheel_base/2. Meshes and visual links reduce to the collision and
kinematic quantities the engine consumes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve
from ..ops.diff_drive import DiffDriveParams


@dataclasses.dataclass(frozen=True)
class RobotDescription:
    name: str
    wheel_radius: float      # m
    wheel_base: float        # m (distance between wheel contact points)
    collision_radius: float  # m (planar collision disc; tube_world robot_radius)
    scanner_height: float    # m (base_scan frame height; for 3D viz only)
    body_length: float       # m footprint (visual only)
    body_width: float        # m

    def diff_drive_params(self, dtype=torch.float32, device=None
                          ) -> DiffDriveParams:
        """The geometry as 0-dim tensors; ``device=None`` is the card."""
        device = resolve(device)
        return DiffDriveParams(
            wheel_base=torch.tensor(self.wheel_base, dtype=dtype,
                                    device=device),
            wheel_rad=torch.tensor(self.wheel_radius, dtype=dtype,
                                   device=device),
        )


TURTLEBOT3_BURGER = RobotDescription(
    name="turtlebot3_burger",
    wheel_radius=0.033,      # diff_params.yaml:2
    wheel_base=0.16,         # diff_params.yaml:3
    collision_radius=0.08,   # tube_world_params.yaml:3 robot_radius
    scanner_height=0.172,
    body_length=0.138,
    body_width=0.178,
)
