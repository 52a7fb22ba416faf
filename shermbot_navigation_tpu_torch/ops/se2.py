"""SE(2) helpers (port of ``shermbot_navigation_tpu.ops.se2``; only what the
serving slice uses so far)."""

from __future__ import annotations

import torch


def normalize_angle(rad: torch.Tensor) -> torch.Tensor:
    """Wrap any angle into (-pi, pi] (ref ``rigid2d.cpp:9-13``): the same
    branchless, exactly periodic ``atan2(sin, cos)`` as the JAX package."""
    return torch.atan2(torch.sin(rad), torch.cos(rad))
