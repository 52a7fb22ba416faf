"""Batch SLAM refinement: poses + landmarks via Schur-complement reduction
(port of ``shermbot_navigation_tpu.models.schur``).

Given an odometry prior trajectory and range-bearing landmark
observations, jointly refine all keyframe poses (T, 3) and landmarks
(N, 2) by Gauss-Newton on the information form::

    [ Hpp  Hpl ] [dp]   [ -bp ]
    [ Hlp  Hll ] [dl] = [ -bl ]

``Hll`` is block-diagonal (2x2 per landmark), so the landmark block
eliminates in closed form::

    S dp = -bp + Hpl Hll^-1 bl          (S = Hpp - Hpl Hll^-1 Hlp)
    dl   = -Hll^-1 (bl + Hlp dp)

``S`` is never materialized: CG consumes ``S v`` as gather, block product
and scatter-add chains over the observation list. This is the single-shard
oracle that ``parallel/schur_dist.py`` is held to. The measurement model
is the EKF's h/H (ref ``slam_library.cpp:150-186``).

Fixed shapes: observations are padded and masked by ``obs_w``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import se2
from ..ops.smallalg import solve3
from .ekf_slam import _inv2x2
from .pose_graph import PoseGraph, _assemble_rhs, _cg, _scatter
from .pose_graph import gauge_project, residuals as pg_residuals


class BundleProblem(NamedTuple):
    poses: torch.Tensor     # (T, 3) current pose estimates [th, x, y]
    landmarks: torch.Tensor # (N, 2) current landmark estimates
    # odometry chain (relative-pose factors between consecutive keyframes)
    odo_meas: torch.Tensor  # (T-1, 3) measured relative poses
    odo_info: torch.Tensor  # (3, 3) information for each odometry factor
    # landmark observations
    obs_t: torch.Tensor     # (M,) int32 pose index
    obs_j: torch.Tensor     # (M,) int32 landmark index
    obs_z: torch.Tensor     # (M, 2) [range, bearing]
    obs_info: torch.Tensor  # (2, 2) information for each observation
    obs_w: torch.Tensor     # (M,) 0/1 mask
    anchor_w: torch.Tensor  # () gauge anchor weight on pose 0


def range_bearing(pose, lm):
    """h(x, l): the EKF measurement model (ref slam_library.cpp:150-160)."""
    dx = lm[0] - pose[1]
    dy = lm[1] - pose[2]
    d = (dx * dx + dy * dy).clamp_min(1e-12)
    return torch.stack([torch.sqrt(d),
                        se2.normalize_angle(torch.atan2(dy, dx) - pose[0])])


def _obs_residual(pose, lm, z):
    r = range_bearing(pose, lm) - z
    return torch.stack([r[0], se2.normalize_angle(r[1])])


_obs_rj = torch.func.vmap(
    lambda p, l, z: (
        _obs_residual(p, l, z),
        torch.func.jacfwd(_obs_residual, argnums=0)(p, l, z),   # (2, 3)
        torch.func.jacfwd(_obs_residual, argnums=1)(p, l, z),   # (2, 2)
    )
)


def _odo_graph(prob: BundleProblem) -> PoseGraph:
    T = prob.poses.shape[0]
    i = torch.arange(T - 1, dtype=torch.int32, device=prob.poses.device)
    return PoseGraph(
        poses=prob.poses, edge_i=i, edge_j=i + 1, meas=prob.odo_meas,
        info=prob.odo_info.expand(T - 1, 3, 3),
        weight=torch.ones(T - 1, dtype=prob.poses.dtype,
                          device=prob.poses.device))


def _terms(prob: BundleProblem):
    """All residuals/Jacobians + the landmark-block inverse."""
    g = _odo_graph(prob)
    r_o, Ji, Jj = pg_residuals(g)

    p = prob.poses[prob.obs_t]
    l = prob.landmarks[prob.obs_j]
    r_z, Jp, Jl = _obs_rj(p, l, prob.obs_z)

    w = prob.obs_w[:, None, None]
    OJp = torch.einsum("ij,ejk->eik", prob.obs_info, Jp) * w
    OJl = torch.einsum("ij,ejk->eik", prob.obs_info, Jl) * w

    # Hll blocks: sum_e Jl^T O Jl per landmark -> (N, 2, 2); the damping
    # keeps never-observed landmarks invertible
    Hll = _scatter(prob.landmarks.shape[0], prob.obs_j,
                   torch.einsum("eji,ejk->eik", Jl, OJl))
    Hll = Hll + 1e-8 * torch.eye(2, dtype=Hll.dtype, device=Hll.device)
    return g, (r_o, Ji, Jj), (r_z, Jp, Jl, OJp, OJl), _inv2x2(Hll)


def _pose_rhs(prob, g, odo_terms, obs_terms):
    """bp (T,3) and bl (N,2)."""
    r_z, Jp, Jl, OJp, OJl = obs_terms
    bp = _assemble_rhs(g, *odo_terms)
    Orz = torch.einsum("ij,ej->ei", prob.obs_info, r_z) * prob.obs_w[:, None]
    bp.index_add_(0, prob.obs_t, torch.einsum("eji,ej->ei", Jp, Orz))
    bl = _scatter(prob.landmarks.shape[0], prob.obs_j,
                  torch.einsum("eji,ej->ei", Jl, Orz))
    return bp, bl


def _hpp_v(prob, g, odo_terms, obs_terms, v):
    """(Hpp v): odometry-chain part + observation part + anchor."""
    r_o, Ji, Jj = odo_terms
    r_z, Jp, Jl, OJp, OJl = obs_terms

    Jv = (torch.einsum("eij,ej->ei", Ji, v[g.edge_i])
          + torch.einsum("eij,ej->ei", Jj, v[g.edge_j]))
    OJv = torch.einsum("eij,ej->ei", g.info, Jv)
    out = _scatter(v.shape[0], g.edge_i, torch.einsum("eji,ej->ei", Ji, OJv))
    out.index_add_(0, g.edge_j, torch.einsum("eji,ej->ei", Jj, OJv))

    Jpv = torch.einsum("eij,ej->ei", Jp, v[prob.obs_t])
    OJpv = torch.einsum("ij,ej->ei", prob.obs_info, Jpv) * prob.obs_w[:, None]
    out.index_add_(0, prob.obs_t, torch.einsum("eji,ej->ei", Jp, OJpv))

    out[0] += prob.anchor_w * v[0]
    return out


def _hlp_v(prob, obs_terms, v):
    """(Hlp v): pose vector (T,3) -> landmark vector (N,2)."""
    r_z, Jp, Jl, OJp, OJl = obs_terms
    Jpv = torch.einsum("eij,ej->ei", Jp, v[prob.obs_t])
    OJpv = torch.einsum("ij,ej->ei", prob.obs_info, Jpv) * prob.obs_w[:, None]
    return _scatter(prob.landmarks.shape[0], prob.obs_j,
                    torch.einsum("eji,ej->ei", Jl, OJpv))


def _hpl_u(prob, obs_terms, u):
    """(Hpl u): landmark vector (N,2) -> pose vector (T,3)."""
    r_z, Jp, Jl, OJp, OJl = obs_terms
    Jlu = torch.einsum("eij,ej->ei", Jl, u[prob.obs_j])
    OJlu = torch.einsum("ij,ej->ei", prob.obs_info, Jlu) * prob.obs_w[:, None]
    return _scatter(prob.poses.shape[0], prob.obs_t,
                    torch.einsum("eji,ej->ei", Jp, OJlu))


def _hpp_diag_blocks(prob, g, odo_terms, obs_terms, damping):
    """(T, 3, 3) diagonal blocks of Hpp for Jacobi preconditioning."""
    r_o, Ji, Jj = odo_terms
    r_z, Jp, Jl, OJp, OJl = obs_terms
    T = prob.poses.shape[0]
    eye = torch.eye(3, dtype=prob.poses.dtype, device=prob.poses.device)
    Oi = torch.einsum("eij,ejk->eik", g.info, Ji)
    Oj = torch.einsum("eij,ejk->eik", g.info, Jj)
    D = _scatter(T, g.edge_i, torch.einsum("eji,ejk->eik", Ji, Oi))
    D.index_add_(0, g.edge_j, torch.einsum("eji,ejk->eik", Jj, Oj))
    D.index_add_(0, prob.obs_t, torch.einsum("eji,ejk->eik", Jp, OJp))
    D[0] += prob.anchor_w * eye
    return D + damping * eye


def gauss_newton_step(prob: BundleProblem, damping: float = 1e-6,
                      cg_iters: int = 64) -> BundleProblem:
    """One GN step with Schur elimination of the landmark block."""
    g, odo_terms, obs_terms, Hll_inv = _terms(prob)
    bp, bl = _pose_rhs(prob, g, odo_terms, obs_terms)

    def Sv(v):
        u = _hlp_v(prob, obs_terms, v)                       # Hlp v
        u = torch.einsum("nij,nj->ni", Hll_inv, u)           # Hll^-1 Hlp v
        return (_hpp_v(prob, g, odo_terms, obs_terms, v)
                - _hpl_u(prob, obs_terms, u) + damping * v)

    rhs = -bp + _hpl_u(prob, obs_terms,
                       torch.einsum("nij,nj->ni", Hll_inv, bl))
    D = _hpp_diag_blocks(prob, g, odo_terms, obs_terms, damping)
    dp = _cg(Sv, rhs, cg_iters, precond=lambda r: solve3(D, r))

    dl = -torch.einsum("nij,nj->ni", Hll_inv,
                       bl + _hlp_v(prob, obs_terms, dp))

    poses = prob.poses + dp
    poses = torch.cat([se2.normalize_angle(poses[:, :1]), poses[:, 1:]],
                      dim=1)
    # exact gauge fix (see pose_graph.gauge_project): kill the near-free
    # global-rotation mode instead of letting it drift against the anchor
    poses, landmarks = gauge_project(poses, prob.poses[0],
                                     prob.landmarks + dl)
    return prob._replace(poses=poses, landmarks=landmarks)


def optimize(prob: BundleProblem, iters: int = 5, **kw) -> BundleProblem:
    for _ in range(iters):
        prob = gauss_newton_step(prob, **kw)
    return prob


def total_cost(prob: BundleProblem):
    g, (r_o, _, _), (r_z, _, _, _, _), _ = _terms(prob)
    c_o = torch.sum(torch.einsum("ei,ij,ej->e", r_o, prob.odo_info, r_o))
    c_z = torch.sum(prob.obs_w * torch.einsum(
        "ei,ij,ej->e", r_z, prob.obs_info, r_z))
    return c_o + c_z
