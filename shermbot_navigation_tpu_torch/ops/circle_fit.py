"""Hyperaccurate algebraic circle fit (Al-Sharadqah & Chernov), batched
(port of ``shermbot_navigation_tpu.ops.circle_fit``), batch-first: clusters
carry leading batch dimensions ``(..., C, P, 2)``.

The per-cluster math is the reference ``circleFit``
(``nuslam/src/circle_fit_library.cpp:15-134``) on the 4x4 moment matrix
``M = Z^T Z`` instead of an SVD of the (n x 4) data matrix:

1. centroid shift, ``z_i = x_i^2 + y_i^2``, ``Z = [z, x, y, 1]``;
2. constraint matrix ``H`` / analytic ``H^{-1}`` from ``z_bar``;
3. if the smallest singular value of Z < 1e-12: ``A`` = its right singular
   vector;
4. else ``Y = V S V^T``, ``Q = Y H^{-1} Y``, ``A*`` = eigenvector of the
   smallest *positive* eigenvalue of ``Q``, ``A = Y^{-1} A*``;
5. center ``(a, b) = (-A1, -A2) / (2 A0)`` + centroid,
   ``R^2 = (A1^2 + A2^2 - 4 A0 A3) / (4 A0^2)``.

Degenerate clusters (n < 4) are invalid.

By default the whole fit -- moments and the componentized eigen-chain
(``ops/kernels/circle_fit._fit_tail_c``, op for op the JAX version) -- is
one kernel, ``ops/kernels/circle_fit``: the CUDA kernel for f32 clusters
on the card, its plain version on the CPU. ``componentized=False`` keeps the
tensor-form tail (the A/B oracle) behind the moment-only kernel
``ops/kernels/circle_moments``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .clustering import Clusters
from .kernels import circle_fit as cfk
from .kernels import circle_moments as cm
from .kernels.circle_fit import _circle_from_A
from .smallalg import eigh4_jacobi, solve4


class CircleFits(NamedTuple):
    center: torch.Tensor  # (..., C, 2) fitted centers (the points' frame)
    radius: torch.Tensor  # (..., C) fitted radii
    valid: torch.Tensor   # (..., C) fit is well-defined (>= 4 points, finite)


def _moments_one(pts, count):
    """Masked centroid + 4x4 moment matrix of padded clusters ``pts
    (..., P, 2)``, ``count (...,)`` (ref :19-47), tensor form: the plain
    version of the moments kernel."""
    return cm.reference_circle_moments(pts, count)


def _fit_tail(M, centroid, z_bar, count, valid):
    """The eigen-chain on 4x4 moment matrices ``M (..., 4, 4)`` (ref
    :50-110), tensor form (the A/B oracle of the componentized
    ``ops/kernels/circle_fit._fit_tail_c``)."""
    dt = M.dtype
    dev = M.device
    cx, cy = centroid[..., 0], centroid[..., 1]

    # H^{-1} (ref :55-61)
    Hinv = torch.tensor([[0.0, 0.0, 0.0, 0.5],
                         [0.0, 1.0, 0.0, 0.0],
                         [0.0, 0.0, 1.0, 0.0],
                         [0.5, 0.0, 0.0, 0.0]], dtype=dt, device=dev)
    corner = torch.zeros((4, 4), dtype=dt, device=dev)
    corner[3, 3] = -2.0
    Hinv = Hinv + corner * z_bar[..., None, None]

    # eigendecomposition of M = V s^2 V^T (same V as the SVD of Z)
    lam, V = eigh4_jacobi(M)              # ascending
    s = torch.sqrt(torch.clamp_min(lam, 0.0))
    sigma4 = s[..., 0]
    rank_def = sigma4 < 1e-12

    # branch a: rank-deficient -> null vector (ref :78-80)
    A_null = V[..., :, 0]

    # branch b: Y = V S V^T, Q = Y Hinv Y (ref :81-104)
    Y = torch.matmul(V * s[..., None, :], V.transpose(-1, -2))
    Q = torch.matmul(torch.matmul(Y, Hinv), Y)
    eq, EV = eigh4_jacobi(Q)              # ascending
    pos = eq > 0
    # smallest positive eigenvalue; reference default index 0 if none
    big = torch.where(pos, eq, torch.full_like(eq, float("inf")))
    k = torch.argmin(big, dim=-1)         # first minimum; 0 if all inf
    Astar = torch.gather(EV, -1, k[..., None, None].expand(
        *k.shape, 4, 1))[..., 0]
    # A = solve(Y, Astar); guard the solve for the untaken branch
    Ysafe = Y + rank_def.to(dt)[..., None, None] * torch.eye(
        4, dtype=dt, device=dev)
    A_gen = solve4(Ysafe, Astar)

    A = torch.where(rank_def[..., None], A_null, A_gen)
    a, b, radius = _circle_from_A(A[..., 0], A[..., 1], A[..., 2], A[..., 3])
    center = torch.stack([a + cx, b + cy], dim=-1)
    ok = (valid & (count >= 4) & torch.isfinite(center).all(dim=-1)
          & torch.isfinite(radius))
    return center, radius, ok


def _fit_one(pts, count, valid):
    """Tensor-form fit of padded clusters: pts (..., P, 2), count (...,)."""
    M, centroid, z_bar = _moments_one(pts, count)
    return _fit_tail(M, centroid, z_bar, count, valid)


def fit_circles(clusters: Clusters,
                componentized: bool | None = None) -> CircleFits:
    """Batched circle fit over all cluster slots.

    By default (``componentized=None`` -> True) the fit is one pass of
    ``ops/kernels/circle_fit`` over the point buffer: moments and the
    componentized eigen-chain: the CUDA kernel for clusters on the card,
    the plain version on the CPU (``ops/kernels/__init__.py``). The
    kernels take f32 only; an f64 buffer on the card raises.
    ``componentized=False`` keeps the tensor-form tail (the A/B oracle)
    behind the moment-only kernel ``ops/kernels/circle_moments``."""
    comp = True if componentized is None else componentized
    if comp:
        center, radius, ok, _, _, _ = cfk.circle_fit_raw(
            clusters.points, clusters.counts, clusters.valid)
        return CircleFits(center=center, radius=radius, valid=ok)
    M, cent, zbar = cm.circle_moments(clusters.points, clusters.counts)
    center, radius, ok = _fit_tail(M, cent, zbar, clusters.counts,
                                   clusters.valid)
    return CircleFits(center=center, radius=radius, valid=ok)


def fit_points(points) -> tuple:
    """Convenience: fit a single unpadded (n, 2) point set; returns
    ((cx, cy), radius). Used by the golden-vector tests."""
    n = points.shape[0]
    count = torch.tensor(n, dtype=torch.int32, device=points.device)
    center, radius, _ = _fit_one(points, count, torch.tensor(
        True, device=points.device))
    return center, radius
