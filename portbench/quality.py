"""Trajectory quality of a batch of worlds, frozen here so that the
yardstick does not move with the program.

``ate`` and ``nees`` are copies of ``shermbot_navigation_tpu_torch/
pipeline/metrics.py`` (``ate``, ``nees``, with ``ops/smallalg.solve3``'s
closed-form 3x3 solve); ``world_ate`` of ``shermbot_navigation_tpu_torch/
bench.py`` (``world_ate``).
"""

from __future__ import annotations

import torch


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def ate(est_xy, true_xy) -> torch.Tensor:
    """Root-mean-square absolute trajectory error over (T, 2) positions."""
    d = torch.as_tensor(est_xy) - torch.as_tensor(true_xy)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))


def world_ate(slam_pose, true_pose) -> torch.Tensor:
    """Each world's RMS position error over the run, (B,) f64, from poses
    ``(B, T, 3)`` = ``[theta, x, y]``."""
    d = slam_pose[..., 1:].double() - true_pose[..., 1:].double()
    return torch.sqrt((d * d).sum(-1).mean(-1))


def _solve3(M, v, eps: float = 1e-30):
    """Closed-form 3x3 solve via the adjugate (batched): ``M x = v``."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    x0 = A * v[..., 0] + B * v[..., 1] + C * v[..., 2]
    x1 = D * v[..., 0] + E * v[..., 1] + F * v[..., 2]
    x2 = G * v[..., 0] + H * v[..., 1] + I * v[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def nees(est_pose, true_pose, cov3) -> torch.Tensor:
    """Per-step NEES of the robot block: ``e^T P^{-1} e`` with the heading
    error wrapped; poses ``(..., 3)``, ``cov3 (..., 3, 3)``."""
    e = est_pose - true_pose
    e = torch.cat([_wrap(e[..., :1]), e[..., 1:]], dim=-1)
    return torch.sum(e * _solve3(cov3, e), dim=-1)
