"""Trajectory metrics (port of ``shermbot_navigation_tpu.pipeline.metrics``;
only what the serving slice uses so far)."""

from __future__ import annotations

import torch


def ate(est_xy, true_xy) -> torch.Tensor:
    """Root-mean-square absolute trajectory error over (T, 2) positions."""
    d = torch.as_tensor(est_xy) - torch.as_tensor(true_xy)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))
