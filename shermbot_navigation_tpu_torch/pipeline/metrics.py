"""Trajectory and filter-consistency metrics (port of
``shermbot_navigation_tpu.pipeline.metrics``): absolute trajectory error
(ATE), relative pose error (RPE), NIS and NEES, all pure functions over
stacked rollout outputs.
"""

from __future__ import annotations

import torch

from ..ops import se2
from ..ops.smallalg import solve3


def ate(est_xy, true_xy) -> torch.Tensor:
    """Root-mean-square absolute trajectory error over (T, 2) positions."""
    d = torch.as_tensor(est_xy) - torch.as_tensor(true_xy)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def max_te(est_xy, true_xy) -> torch.Tensor:
    """Maximum translational error."""
    d = torch.as_tensor(est_xy) - torch.as_tensor(true_xy)
    return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))


def heading_rmse(est_th, true_th) -> torch.Tensor:
    """RMS heading error with angle wrapping."""
    e = se2.normalize_angle(torch.as_tensor(est_th) - torch.as_tensor(true_th))
    return torch.sqrt(torch.mean(e * e))


def rpe(est_poses, true_poses, delta: int = 10) -> torch.Tensor:
    """Relative pose error: RMS translational drift over windows of
    ``delta`` ticks. Poses are (T, 3) ``[th, x, y]``."""
    Te = se2.from_pose(torch.as_tensor(est_poses))
    Tt = se2.from_pose(torch.as_tensor(true_poses))
    rel_e = se2.compose(se2.inv(Te[:-delta]), Te[delta:])
    rel_t = se2.compose(se2.inv(Tt[:-delta]), Tt[delta:])
    err = se2.compose(se2.inv(rel_t), rel_e)
    d = err[..., 2:4]
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def nis(dz, psi) -> torch.Tensor:
    """Per-measurement normalized innovation squared ``dz^T psi^{-1} dz``
    (2 dof). ``dz``: (..., 2) innovations; ``psi``: (..., 2, 2) innovation
    covariances (``models.ekf_slam.innovation``)."""
    a, b = psi[..., 0, 0], psi[..., 0, 1]
    c, d = psi[..., 1, 0], psi[..., 1, 1]
    det = a * d - b * c
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    e0, e1 = dz[..., 0], dz[..., 1]
    return (d * e0 * e0 - (b + c) * e0 * e1 + a * e1 * e1) / det


def nees(est_pose, true_pose, cov3) -> torch.Tensor:
    """Per-step NEES of the robot block: ``e^T P^{-1} e`` with the heading
    error wrapped. ``est_pose``/``true_pose``: (..., 3) ``[th, x, y]``;
    ``cov3``: (..., 3, 3) robot-block covariance (closed-form 3x3 solve)."""
    e = est_pose - true_pose
    e = torch.cat([se2.normalize_angle(e[..., :1]), e[..., 1:]], dim=-1)
    return torch.sum(e * solve3(cov3, e), dim=-1)
