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

The data-touching front end (masked centroid + moments) is
``ops/kernels/circle_moments``: the CUDA kernel for f32 clusters on the
card, its plain version on the CPU. The eigen-chain runs componentized by
default (:func:`_fit_tail_c`, op for op the JAX version);
``componentized=False`` keeps the tensor-form tail as the A/B oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .clustering import Clusters
from .kernels import circle_moments as cm
from .smallalg import eigh4_jacobi, eigh4_jacobi_c, solve4, solve4_c


class CircleFits(NamedTuple):
    center: torch.Tensor  # (..., C, 2) fitted centers (the points' frame)
    radius: torch.Tensor  # (..., C) fitted radii
    valid: torch.Tensor   # (..., C) fit is well-defined (>= 4 points, finite)


def _moments_one(pts, count):
    """Masked centroid + 4x4 moment matrix of padded clusters ``pts
    (..., P, 2)``, ``count (...,)`` (ref :19-47), tensor form: the plain
    version of the moments kernel."""
    return cm.reference_circle_moments(pts, count)


def _moments_comps(points, counts):
    """Masked moments as 16 flat components + centroid + z_bar -- the plain
    front end of the componentized tail. points (..., P, 2), counts
    (...,)."""
    return cm._reference_raw(points, counts)


def _circle_from_A(A0_, A1, A2, A3):
    """Circle parameters from the algebraic vector (ref :107-110):
    ``(a, b, radius)`` relative to the centroid."""
    A0 = torch.where(torch.abs(A0_) < 1e-30, torch.full_like(A0_, 1e-30),
                     A0_)
    a = -A1 / (2.0 * A0)
    b = -A2 / (2.0 * A0)
    R2 = (A1 ** 2 + A2 ** 2 - 4.0 * A0_ * A3) / (4.0 * A0 * A0)
    return a, b, torch.sqrt(torch.clamp_min(R2, 0.0))


def _fit_tail(M, centroid, z_bar, count, valid):
    """The eigen-chain on 4x4 moment matrices ``M (..., 4, 4)`` (ref
    :50-110), tensor form (the A/B oracle of :func:`_fit_tail_c`)."""
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


def _fit_tail_c(mc, cx, cy, z_bar, count, valid):
    """Fully-componentized eigen-chain (ref :50-110): ``mc`` is a length-16
    list of batched moment components (row-major); no 4x4 tensor is built.
    Op for op the JAX ``_fit_tail_c``."""
    dt = mc[0].dtype
    lam, V = eigh4_jacobi_c(mc)                   # lists; lam ascending
    lam = [torch.clamp_min(l, 0.0) for l in lam]
    s = [torch.sqrt(l) for l in lam]
    sigma4 = s[0]

    # branch a: rank-deficient -> null vector (ref :78-80)
    A_null = [V[i][0] for i in range(4)]

    # branch b: Y = V S V^T (symmetric -- 10 unique comps, mirrored)
    Y = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Y[i][j] = Y[j][i] = sum(V[i][k] * s[k] * V[j][k]
                                    for k in range(4))
    # Y Hinv with the closed-form Hinv (0.5 anti-diag corners, identity
    # middle, -2 z_bar at [3,3]) -- ref :55-61
    YH = [[0.5 * Y[i][3], Y[i][1], Y[i][2],
           0.5 * Y[i][0] - 2.0 * z_bar * Y[i][3]] for i in range(4)]
    # Q = (Y Hinv) Y, symmetric
    Q = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Q[i][j] = Q[j][i] = sum(YH[i][k] * Y[k][j] for k in range(4))

    eq, EV = eigh4_jacobi_c([Q[i][j] for i in range(4) for j in range(4)])
    # smallest POSITIVE eigenvalue; default column 0 if none positive
    # (ref :81-104) -- running component argmin, strict < keeps the first
    inf = torch.full_like(eq[0], float("inf"))
    big = [torch.where(e > 0, e, inf) for e in eq]
    best = big[0]
    Astar = [EV[i][0] for i in range(4)]
    for k in (1, 2, 3):
        take = big[k] < best
        best = torch.where(take, big[k], best)
        Astar = [torch.where(take, EV[i][k], Astar[i]) for i in range(4)]

    # A = solve(Y, Astar); guard the solve for the untaken branch
    rank_def = sigma4 < 1e-12
    bump = rank_def.to(dt)
    Ysafe = [[Y[i][j] + bump * (1.0 if i == j else 0.0) for j in range(4)]
             for i in range(4)]
    A_gen = solve4_c(Ysafe, Astar)
    A = [torch.where(rank_def, A_null[i], A_gen[i]) for i in range(4)]

    a, b, radius = _circle_from_A(*A)
    ccx = a + cx
    ccy = b + cy
    ok = (valid & (count >= 4) & torch.isfinite(ccx) & torch.isfinite(ccy)
          & torch.isfinite(radius))
    return torch.stack([ccx, ccy], dim=-1), radius, ok


def _fit_one(pts, count, valid):
    """Tensor-form fit of padded clusters: pts (..., P, 2), count (...,)."""
    M, centroid, z_bar = _moments_one(pts, count)
    return _fit_tail(M, centroid, z_bar, count, valid)


def fit_circles(clusters: Clusters, use_kernel: bool | None = None,
                componentized: bool | None = None) -> CircleFits:
    """Batched circle fit over all cluster slots.

    The front end (masked centroid + moment matrices) is one pass of
    ``ops/kernels/circle_moments`` over the point buffer; ``use_kernel``
    follows the package rule (``ops/kernels/__init__.py``): ``None``
    launches the CUDA kernel for clusters on the card and runs the plain
    version on the CPU, ``False`` the plain version anywhere, ``True``
    demands the kernel. The kernel takes f32 only; an f64 buffer on the
    card needs ``use_kernel=False``. The eigen-chain runs componentized by
    default (``componentized=None`` -> True); ``componentized=False`` keeps
    the tensor-form tail (the A/B oracle)."""
    comp = True if componentized is None else componentized
    if comp:
        m16, cent, zbar = cm.circle_moments_raw(
            clusters.points, clusters.counts, use_kernel=use_kernel)
        mc = [m16[..., k] for k in range(16)]
        center, radius, ok = _fit_tail_c(mc, cent[..., 0], cent[..., 1],
                                         zbar, clusters.counts,
                                         clusters.valid)
        return CircleFits(center=center, radius=radius, valid=ok)
    M, cent, zbar = cm.circle_moments(clusters.points, clusters.counts,
                                      use_kernel=use_kernel)
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
