"""SE(2) keyframe pose-graph optimization: loop closure (port of
``shermbot_navigation_tpu.models.pose_graph``).

A pose graph is tensors: poses (T, 3) ``[th, x, y]`` and edges (odometry
and loop closures) as index pairs with measured relative poses and
information matrices. The residual is ``e = log(Z^-1 (X_i^-1 X_j))`` with
the heading wrapped; its Jacobians come from ``torch.func.jacfwd`` under
``torch.func.vmap``, as the JAX package takes them from ``jax.jacfwd``
under ``jax.vmap``. One Gauss-Newton step assembles the normal equations
densely (a Jacobi-equilibrated solve) or matrix-free for conjugate
gradients, where ``H v`` is an edge-wise gather, block product and
scatter-add (``index_add_``, which sums repeated indices as JAX's
``.at[].add`` does). Pose 0 is gauge-anchored with a strong prior and
projected back after every step.

:func:`optimize_host` is the host stage of large-map refinement: dense
Gauss-Newton in numpy float64. It stays on the host: an f32 pose-graph
stage on a device diverges on most seeds at config-5 extent. The CG
iterations read no value back to the host; the dense solve is
``torch.linalg.solve_ex``, without ``linalg.solve``'s host-side check.

Fixed shapes: pad edges and mask them with ``weight=0``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import se2
from ..ops.smallalg import solve3


class PoseGraph(NamedTuple):
    poses: torch.Tensor    # (T, 3) [th, x, y]
    edge_i: torch.Tensor   # (E,) int32 source pose index
    edge_j: torch.Tensor   # (E,) int32 target pose index
    meas: torch.Tensor     # (E, 3) measured relative pose [th, x, y]
    info: torch.Tensor     # (E, 3, 3) information matrix
    weight: torch.Tensor   # (E,) 0/1 mask for padded edges


def edge_residual(xi, xj, zij):
    """``log(Z^-1 (X_i^-1 X_j))`` as ``[dth, dx, dy]`` (heading wrapped)."""
    Ti = se2.from_pose(xi)
    Tj = se2.from_pose(xj)
    Z = se2.from_pose(zij)
    E = se2.compose(se2.inv(Z), se2.compose(se2.inv(Ti), Tj))
    p = se2.to_pose(E)
    return torch.stack([se2.normalize_angle(p[..., 0]), p[..., 1],
                        p[..., 2]], dim=-1)


_res_and_jac = torch.func.vmap(
    lambda xi, xj, z: (
        edge_residual(xi, xj, z),
        torch.func.jacfwd(edge_residual, argnums=0)(xi, xj, z),
        torch.func.jacfwd(edge_residual, argnums=1)(xi, xj, z),
    )
)


def residuals(g: PoseGraph):
    """(E, 3) residuals and per-edge Jacobians (E, 3, 3) wrt xi and xj."""
    return _res_and_jac(g.poses[g.edge_i], g.poses[g.edge_j], g.meas)


def chi2(g: PoseGraph):
    r, _, _ = residuals(g)
    return torch.sum(g.weight * torch.einsum("ei,eij,ej->e", r, g.info, r))


def _scatter(n: int, index, values):
    """``zeros((n,) + values.shape[1:]).at[index].add(values)``."""
    out = values.new_zeros((n,) + values.shape[1:])
    return out.index_add_(0, index, values)


def _assemble_rhs(g: PoseGraph, r, Ji, Jj):
    """b = sum_e J^T Omega r scattered to pose blocks; (T, 3)."""
    T = g.poses.shape[0]
    w = g.weight[:, None]
    Or = torch.einsum("eij,ej->ei", g.info, r)
    bi = torch.einsum("eji,ej->ei", Ji, Or) * w
    bj = torch.einsum("eji,ej->ei", Jj, Or) * w
    return _scatter(T, g.edge_i, bi).index_add_(0, g.edge_j, bj)


def _hv(g: PoseGraph, Ji, Jj, v, anchor_w):
    """Matrix-free ``H v`` for CG: edge-wise gather, product, scatter.

    ``H = sum_e J_e^T Omega J_e + anchor``; v is (T, 3).
    """
    w = g.weight[:, None]
    Jv = (torch.einsum("eij,ej->ei", Ji, v[g.edge_i])
          + torch.einsum("eij,ej->ei", Jj, v[g.edge_j]))
    OJv = torch.einsum("eij,ej->ei", g.info, Jv)
    hi = torch.einsum("eji,ej->ei", Ji, OJv) * w
    hj = torch.einsum("eji,ej->ei", Jj, OJv) * w
    out = _scatter(v.shape[0], g.edge_i, hi).index_add_(0, g.edge_j, hj)
    # gauge anchor on pose 0
    out[0] += anchor_w * v[0]
    return out


def _block_products(g: PoseGraph, Ji, Jj):
    """``Ji^T O Ji``, ``Ji^T O Jj``, ``Jj^T O Ji``, ``Jj^T O Jj`` (E, 3, 3),
    weighted."""
    w = g.weight[:, None, None]
    Oi = torch.einsum("eij,ejk->eik", g.info, Ji)
    Oj = torch.einsum("eij,ejk->eik", g.info, Jj)
    return (torch.einsum("eji,ejk->eik", Ji, Oi) * w,
            torch.einsum("eji,ejk->eik", Ji, Oj) * w,
            torch.einsum("eji,ejk->eik", Jj, Oi) * w,
            torch.einsum("eji,ejk->eik", Jj, Oj) * w)


def _diag_blocks(g: PoseGraph, Ji, Jj, anchor_w, damping):
    """Block-diagonal (T, 3, 3) of H for Jacobi preconditioning."""
    T = g.poses.shape[0]
    eye = torch.eye(3, dtype=g.poses.dtype, device=g.poses.device)
    Hii, _, _, Hjj = _block_products(g, Ji, Jj)
    D = _scatter(T, g.edge_i, Hii).index_add_(0, g.edge_j, Hjj)
    D[0] += anchor_w * eye
    return D + damping * eye


def _cg(matvec, b, iters, precond=None):
    """(Preconditioned) conjugate gradients on the pose-block space, a
    fixed number of iterations with no host sync.

    Chain-structured graphs are ill-conditioned (information propagates one
    edge per iteration); block-Jacobi preconditioning with the 3x3 diagonal
    blocks makes CG usable at long T."""
    Minv = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b)
    r = b
    z = Minv(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rz / torch.sum(p * Ap).clamp_min(1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / rz.clamp_min(1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def _dense_normal(g: PoseGraph, Ji, Jj, anchor_w, damping):
    """The (3T, 3T) normal matrix: ``H[e_a, :, e_b, :] += H_ab`` for the
    four (a, b) pairs of every edge, on the flattened index."""
    T = g.poses.shape[0]
    n = 3 * T
    k = torch.arange(3, device=g.poses.device)
    ei = g.edge_i.long()[:, None, None]
    ej = g.edge_j.long()[:, None, None]
    H = g.poses.new_zeros(n * n)
    for (a, b), blk in zip(((ei, ei), (ei, ej), (ej, ei), (ej, ej)),
                           _block_products(g, Ji, Jj)):
        flat = (3 * a + k[:, None]) * n + 3 * b + k[None, :]
        H.index_add_(0, flat.reshape(-1), blk.reshape(-1))
    H = H.view(n, n)
    eye3 = torch.eye(3, dtype=H.dtype, device=H.device)
    H[:3, :3] += anchor_w * eye3
    return H + damping * torch.eye(n, dtype=H.dtype, device=H.device)


def gauss_newton_step(g: PoseGraph, damping: float = 1e-6,
                      anchor_w: float = 1e6, solve: str = "dense",
                      cg_iters: int = 50) -> PoseGraph:
    """One (Levenberg-damped) Gauss-Newton step. ``solve``: "dense" builds
    the (3T, 3T) normal matrix; "cg" is matrix-free."""
    T = g.poses.shape[0]
    r, Ji, Jj = residuals(g)
    b = _assemble_rhs(g, r, Ji, Jj)

    if solve == "dense":
        Hm = _dense_normal(g, Ji, Jj, anchor_w, damping)
        # Jacobi equilibration: exact in infinite precision, and keeps the
        # f32 solve stable when information scales span decades
        d = torch.sqrt(torch.diagonal(Hm).clamp_min(1e-12))
        Hs = Hm / d[:, None] / d[None, :]
        # solve_ex: a singular system gives non-finite poses, as in JAX,
        # instead of a host sync to check for it
        y, _ = torch.linalg.solve_ex(Hs, -b.reshape(-1) / d)
        dx = (y / d).reshape(T, 3)
    elif solve == "cg":
        D = _diag_blocks(g, Ji, Jj, anchor_w, damping)
        dx = _cg(lambda v: _hv(g, Ji, Jj, v, anchor_w) + damping * v, -b,
                 cg_iters, precond=lambda r: solve3(D, r))
    else:
        raise ValueError(solve)

    poses = g.poses + dx
    poses = torch.cat([se2.normalize_angle(poses[:, :1]), poses[:, 1:]],
                      dim=1)
    return g._replace(poses=gauge_project(poses, g.poses[0]))


def gauge_project(poses, target0, landmarks=None):
    """Apply the rigid motion G with ``G o pose0 == target0`` to all poses
    (and optionally landmarks).

    The gauge anchor enters H only (its residual is zero at every
    linearization point), so the anchor resists motion of pose 0 within a
    step but ratifies wherever it lands; over many GN steps the solution
    drifts along the near-free global-rotation mode. Projecting the gauge
    after each step removes the mode exactly: observation and odometry
    residuals are invariant under G, and the anchor residual becomes
    exactly zero."""
    dth = se2.normalize_angle(target0[0] - poses[0, 0])
    c, s = torch.cos(dth), torch.sin(dth)
    p0 = poses[0, 1:]
    tx = target0[1] - (c * p0[0] - s * p0[1])
    ty = target0[2] - (s * p0[0] + c * p0[1])
    x, y = poses[:, 1], poses[:, 2]
    # wrap headings RELATIVE to the target so pose 0 comes back exactly
    # target0[0] even when the target heading lies outside (-pi, pi]
    th = se2.normalize_angle(poses[:, 0] + dth - target0[0]) + target0[0]
    out = torch.stack([th, c * x - s * y + tx, s * x + c * y + ty], dim=-1)
    if landmarks is None:
        return out
    lx, ly = landmarks[..., 0], landmarks[..., 1]
    lms = torch.stack([c * lx - s * ly + tx, s * lx + c * ly + ty], dim=-1)
    return out, lms


def optimize(g: PoseGraph, iters: int = 10, **kw) -> PoseGraph:
    """``iters`` GN steps."""
    for _ in range(iters):
        g = gauss_newton_step(g, **kw)
    return g


# ---------------------------------------------------------------------------
# Host-side float64 solver
# ---------------------------------------------------------------------------

def optimize_host(g: PoseGraph, iters: int = 10, damping: float = 1e-6,
                  anchor_w: float = 1e6) -> PoseGraph:
    """Dense Gauss-Newton on the HOST in float64 (numpy).

    The pose graph is the small serial stage of large-map refinement (T
    keyframes, a (3T)^2 solve) while its chain conditioning grows with map
    extent: at 50k-landmark scale (loop radius ~112 m) float32 GN sits on
    a stability cliff, so this stage runs on the host in f64 and the device
    takes the big landmark stage (``parallel/schur_dist.py``). ``g`` holds
    numpy arrays (or CPU tensors); the result's poses are numpy in the
    input's dtype. The same numpy code as the JAX package's, so the same
    bits."""
    poses = np.asarray(g.poses, np.float64).copy()
    ei = np.asarray(g.edge_i)
    ej = np.asarray(g.edge_j)
    meas = np.asarray(g.meas, np.float64)
    info = np.asarray(g.info, np.float64)
    w = np.asarray(g.weight, np.float64)
    T = poses.shape[0]
    E = ei.shape[0]

    def wrap(a):
        return np.arctan2(np.sin(a), np.cos(a))

    target0 = poses[0].copy()
    for _ in range(iters):
        thi = poses[ei, 0]
        u = poses[ej, 1:3] - poses[ei, 1:3]
        ci, si = np.cos(thi), np.sin(thi)
        # A = R(-thi); m = A u - z_xy; e = [wrap(dth - zth), R(-zth) m]
        Au = np.stack([ci * u[:, 0] + si * u[:, 1],
                       -si * u[:, 0] + ci * u[:, 1]], -1)
        m = Au - meas[:, 1:3]
        zc, zs = np.cos(meas[:, 0]), np.sin(meas[:, 0])
        Rz = np.stack([np.stack([zc, zs], -1),
                       np.stack([-zs, zc], -1)], -2)      # (E, 2, 2) R(-zth)
        e = np.empty((E, 3))
        e[:, 0] = wrap(poses[ej, 0] - thi - meas[:, 0])
        e[:, 1:] = np.einsum("eij,ej->ei", Rz, m)

        # Jacobians wrt [th, x, y] of pose i and pose j
        dAu = np.stack([-si * u[:, 0] + ci * u[:, 1],
                        -ci * u[:, 0] - si * u[:, 1]], -1)  # dA/dthi @ u
        A = np.stack([np.stack([ci, si], -1),
                      np.stack([-si, ci], -1)], -2)          # (E, 2, 2)
        RzA = np.einsum("eij,ejk->eik", Rz, A)
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0, 0] = -1.0
        Jj[:, 0, 0] = 1.0
        Ji[:, 1:, 0] = np.einsum("eij,ej->ei", Rz, dAu)
        Ji[:, 1:, 1:] = -RzA
        Jj[:, 1:, 1:] = RzA

        Oi = np.einsum("eij,ejk->eik", info, Ji) * w[:, None, None]
        Oj = np.einsum("eij,ejk->eik", info, Jj) * w[:, None, None]
        H = np.zeros((T, 3, T, 3))
        np.add.at(H, (ei, slice(None), ei, slice(None)),
                  np.einsum("eji,ejk->eik", Ji, Oi))
        np.add.at(H, (ei, slice(None), ej, slice(None)),
                  np.einsum("eji,ejk->eik", Ji, Oj))
        np.add.at(H, (ej, slice(None), ei, slice(None)),
                  np.einsum("eji,ejk->eik", Jj, Oi))
        np.add.at(H, (ej, slice(None), ej, slice(None)),
                  np.einsum("eji,ejk->eik", Jj, Oj))
        H[0, :, 0, :] += anchor_w * np.eye(3)
        b = np.zeros((T, 3))
        Or = np.einsum("eij,ej->ei", info, e) * w[:, None]
        np.add.at(b, ei, np.einsum("eji,ej->ei", Ji, Or))
        np.add.at(b, ej, np.einsum("eji,ej->ei", Jj, Or))

        Hm = H.reshape(3 * T, 3 * T) + damping * np.eye(3 * T)
        dx = np.linalg.solve(Hm, -b.reshape(-1)).reshape(T, 3)
        poses += dx
        poses[:, 0] = wrap(poses[:, 0])
        # gauge projection (same rationale + relative wrap as gauge_project)
        dth = wrap(target0[0] - poses[0, 0])
        c, s = np.cos(dth), np.sin(dth)
        tx = target0[1] - (c * poses[0, 1] - s * poses[0, 2])
        ty = target0[2] - (s * poses[0, 1] + c * poses[0, 2])
        x, y = poses[:, 1].copy(), poses[:, 2].copy()
        poses[:, 0] = wrap(poses[:, 0] + dth - target0[0]) + target0[0]
        poses[:, 1] = c * x - s * y + tx
        poses[:, 2] = s * x + c * y + ty

    return g._replace(poses=poses.astype(np.asarray(g.poses).dtype))


# ---------------------------------------------------------------------------
# Graph construction helpers
# ---------------------------------------------------------------------------

def odometry_edges(poses_odom, info):
    """Consecutive-pose edges from an odometry trajectory (T, 3)."""
    T = poses_odom.shape[0]
    i = torch.arange(T - 1, dtype=torch.int32, device=poses_odom.device)
    Ti = se2.from_pose(poses_odom[:-1])
    Tj = se2.from_pose(poses_odom[1:])
    meas = se2.to_pose(se2.compose(se2.inv(Ti), Tj))
    return i, i + 1, meas, info.expand(T - 1, 3, 3)


def build_graph(poses_init, edges):
    """Stack (i, j, meas, info) edge groups into one PoseGraph."""
    ei = torch.cat([e[0] for e in edges])
    return PoseGraph(
        poses=poses_init,
        edge_i=ei.to(torch.int32),
        edge_j=torch.cat([e[1] for e in edges]).to(torch.int32),
        meas=torch.cat([e[2] for e in edges]),
        info=torch.cat([e[3] for e in edges]),
        weight=torch.ones(ei.shape[0], dtype=poses_init.dtype,
                          device=poses_init.device),
    )
