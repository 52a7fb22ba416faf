"""Map-sharded Schur-complement refinement (BASELINE config 5) (port of
``shermbot_navigation_tpu.parallel.schur_dist``).

The bundle problem of ``models/schur.py`` is split into S map shards: a
shard owns a block of landmarks together with every observation that
references them (observations are pre-partitioned by landmark id, so the
landmark-side products ``Hll``, ``Hlp v``, ``Hpl u`` are local to the
shard). The JAX package runs the shards on a device mesh under
``shard_map``; here a process holds L of them on a leading local-shard
axis (``parallel/mesh.py``): landmarks ``(L, N/S, 2)``, observations
``(L, M/S)``, pose-space vectors ``(T, 3)`` replicated. Each CG matvec
combines the shards' pose-space partials ``(L, T, 3)`` with one
``mesh.psum`` (the JAX ``psum`` over ``'map'``: a sum over the local
shards, then an all-reduce over the processes of the map group).

The odometry-chain part of ``Hpp`` is O(T) and is computed once (the JAX
package computes it redundantly on every shard: the same values).

Partitioning contract: observation arrays are ordered so shard s owns the
slice ``[s * M_local, (s+1) * M_local)`` and every observation in that slice
references a landmark in ``[s * N_local, (s+1) * N_local)``. Use
:func:`partition_problem` to reorder and pad an arbitrary problem into
this layout (host-side numpy, once).

The step loops (GN steps, CG iterations) run eagerly and never wait for
the device: no value goes back to the host inside them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import schur
from ..models.pose_graph import (PoseGraph, _assemble_rhs, _cg,
                                 _diag_blocks, _hv, _scatter, gauge_project)
from ..models.pose_graph import residuals as pg_residuals
from ..ops import se2
from ..ops.smallalg import solve3
from .mesh import MapMesh


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def partition_problem(prob: schur.BundleProblem, n_shards: int
                      ) -> schur.BundleProblem:
    """Reorder observations by landmark owner and pad each shard's slice to
    a common length (host-side numpy, once). Padded slots reference the
    shard's first landmark with weight 0. Every field of the result is a
    tensor: the observation fields on the CPU, the others where they
    were (a numpy field becomes a CPU tensor)."""
    N = prob.landmarks.shape[0]
    if N % n_shards:
        raise ValueError(f"N={N} not divisible by {n_shards}")
    n_local = N // n_shards
    obs_t = _host(prob.obs_t)
    obs_j = _host(prob.obs_j)
    obs_z = _host(prob.obs_z)
    obs_w = _host(prob.obs_w)
    owner = obs_j // n_local
    counts = [int(((owner == s) & (obs_w > 0)).sum())
              for s in range(n_shards)]
    m_local = max(max(counts) if counts else 1, 1)

    idx_t = np.zeros((n_shards, m_local), np.int32)
    idx_j = np.full((n_shards, m_local), 0, np.int32)
    z = np.zeros((n_shards, m_local, 2), obs_z.dtype)
    w = np.zeros((n_shards, m_local), obs_w.dtype)
    for s in range(n_shards):
        sel = np.where((owner == s) & (obs_w > 0))[0]
        k = len(sel)
        idx_t[s, :k] = obs_t[sel]
        idx_j[s, :k] = obs_j[sel]
        # padded slots must reference a landmark the shard owns
        idx_j[s, k:] = s * n_local
        z[s, :k] = obs_z[sel]
        w[s, :k] = 1.0
    return schur.BundleProblem(
        **{k: torch.as_tensor(v) for k, v in prob._asdict().items()}
    )._replace(
        obs_t=torch.from_numpy(idx_t.reshape(-1)),
        obs_j=torch.from_numpy(idx_j.reshape(-1)),
        obs_z=torch.from_numpy(z.reshape(-1, 2)),
        obs_w=torch.from_numpy(w.reshape(-1)),
    )


def make_sharded_gn(mesh, T: int, N: int, M: int,
                    cg_iters: int = 64, damping: float = 1e-6,
                    gn_steps: int = 1, device=None):
    """Build the map-sharded Gauss-Newton refinement over ``mesh``: a
    ``MapMesh`` (on its device), or a shard count for one process on
    ``device`` (``None``: the card).

    Returns ``step(prob) -> prob`` applying ``gn_steps`` GN iterations to a
    partitioned problem (:func:`partition_problem`, the global one) with
    S = ``mesh.shards`` shards, T poses, N landmarks and M observation
    slots. The process takes its own shards' slice ``[r L, (r + 1) L)`` of
    the (S, N/S) landmarks and (S, M/S) observations to the mesh's
    device; the result is that slice (every shard's, flat as the input's,
    in one process), with the refined poses.
    """
    if not isinstance(mesh, MapMesh):
        mesh = MapMesh(int(mesh), device)
    S, L = mesh.shards, mesh.local_shards
    if N % S or M % S:
        raise ValueError(f"{S} map shards must divide N={N} and M={M}")
    device = mesh.device
    n_local, m_local = N // S, M // S
    lms = slice(mesh.rank * L * n_local, (mesh.rank + 1) * L * n_local)
    obs = slice(mesh.rank * L * m_local, (mesh.rank + 1) * L * m_local)

    def step(prob: schur.BundleProblem) -> schur.BundleProblem:
        if prob.poses.shape[0] != T or prob.landmarks.shape[0] != N \
                or prob.obs_t.shape[0] != M:
            raise ValueError(
                f"problem of T={prob.poses.shape[0]}, "
                f"N={prob.landmarks.shape[0]}, M={prob.obs_t.shape[0]}; "
                f"step built for T={T}, N={N}, M={M}")
        prob = prob._replace(landmarks=prob.landmarks[lms], **{
            k: getattr(prob, k)[obs]
            for k in ("obs_t", "obs_j", "obs_z", "obs_w")})
        prob = schur.BundleProblem(*(x.to(device) for x in prob))
        poses = prob.poses
        landmarks = prob.landmarks.reshape(L, n_local, 2)
        for _ in range(gn_steps):
            poses, landmarks = _gn_once(prob, poses, landmarks)
        return prob._replace(poses=poses,
                             landmarks=landmarks.reshape(L * n_local, 2))

    def _gn_once(prob, cur_poses, cur_landmarks):
        # local views: landmarks (L, Nl, 2); obs (L, Ml) referencing GLOBAL
        # ids, flat index l * Nl + j_loc into the (L * Nl) local rows
        dtype = cur_poses.dtype
        prob = prob._replace(poses=cur_poses)

        # odometry graph (replicated, cheap)
        Tn = prob.poses.shape[0]
        ii = torch.arange(Tn - 1, dtype=torch.int32, device=device)
        g = PoseGraph(
            poses=prob.poses, edge_i=ii, edge_j=ii + 1, meas=prob.odo_meas,
            info=prob.odo_info.expand(Tn - 1, 3, 3),
            weight=torch.ones(Tn - 1, dtype=dtype, device=device))
        r_o, Ji, Jj = pg_residuals(g)

        # ---- per-observation COMPONENT arrays, all (S, Ml) -------------
        # The 9 Jacobian nonzeros (ref slam_library.cpp:162-186) as flat
        # vectors, as the JAX package keeps them.
        t = prob.obs_t.reshape(L, m_local)
        jf = prob.obs_j.reshape(L, m_local) - lms.start   # local flat index
        w = prob.obs_w.reshape(L, m_local)
        z = prob.obs_z.reshape(L, m_local, 2)
        shard_off = (torch.arange(L, device=device, dtype=t.dtype)
                     * Tn)[:, None]
        tf = (t + shard_off).reshape(-1)     # flat index into (L * T) rows
        lflat = cur_landmarks.reshape(L * n_local, 2)
        pth = prob.poses[t, 0]
        dx = lflat[jf, 0] - prob.poses[t, 1]
        dy = lflat[jf, 1] - prob.poses[t, 2]
        d = (dx * dx + dy * dy).clamp_min(1e-12)
        sq = torch.sqrt(d)
        r1 = sq - z[..., 0]
        r2 = se2.normalize_angle(
            se2.normalize_angle(torch.atan2(dy, dx) - pth) - z[..., 1])
        # pose Jacobian rows: range (0, -dx/sq, -dy/sq),
        #                     bearing (-1, dy/d, -dx/d)
        ar_x, ar_y = -dx / sq, -dy / sq
        ab_x, ab_y = dy / d, -dx / d          # theta column is exactly -1
        # landmark Jacobian: range (dx/sq, dy/sq), bearing (-dy/d, dx/d)
        lr_x, lr_y = dx / sq, dy / sq
        lb_x, lb_y = -dy / d, dx / d
        w11 = prob.obs_info[0, 0]
        w12 = prob.obs_info[0, 1]
        w22 = prob.obs_info[1, 1]

        def omega_w(s1, s2):
            """(w * Omega) applied to a measurement-space pair."""
            return (w * (w11 * s1 + w12 * s2), w * (w12 * s1 + w22 * s2))

        def jpT(o1, o2):
            """J_pose^T applied to a measurement-space pair -> 3 comps."""
            return (-o2, ar_x * o1 + ab_x * o2, ar_y * o1 + ab_y * o2)

        def jlT(o1, o2):
            """J_lm^T applied to a measurement-space pair -> 2 comps."""
            return (lr_x * o1 + lb_x * o2, lr_y * o1 + lb_y * o2)

        def jp(v):
            """J_pose applied to pose-space v (T, 3) -> meas pair."""
            vt = v[t]
            return (ar_x * vt[..., 1] + ar_y * vt[..., 2],
                    -vt[..., 0] + ab_x * vt[..., 1] + ab_y * vt[..., 2])

        def jl(u):
            """J_lm applied to landmark-space u (L, Nl, 2) -> meas pair."""
            uj = u.reshape(L * n_local, 2)[jf]
            ux, uy = uj[..., 0], uj[..., 1]
            return (lr_x * ux + lr_y * uy, lb_x * ux + lb_y * uy)

        def scat_t(*comps):
            """Per-shard pose-space partials (L, T, len(comps))."""
            vals = torch.stack(comps, dim=-1)
            return _scatter(L * Tn, tf, vals.reshape(L * m_local, -1)
                            ).view(L, Tn, -1)

        def scat_j(c1, c2):
            """Landmark-space values (L, Nl, 2) of the shards' own blocks."""
            vals = torch.stack([c1, c2], dim=-1).reshape(-1, 2)
            return _scatter(L * n_local, jf.reshape(-1), vals
                            ).view(L, n_local, 2)

        def scat_l(c):
            return _scatter(L * n_local, jf.reshape(-1), c.reshape(-1)
                            ).view(L, n_local)

        # local Hll blocks (symmetric 2x2 per landmark, 3 component arrays)
        o1x, o2x = omega_w(lr_x, lb_x)        # (w Omega) column x
        o1y, o2y = omega_w(lr_y, lb_y)
        q_xx = lr_x * o1x + lb_x * o2x
        q_xy = lr_x * o1y + lb_x * o2y
        q_yy = lr_y * o1y + lb_y * o2y
        Hxx = scat_l(q_xx) + 1e-8
        Hxy = scat_l(q_xy)
        Hyy = scat_l(q_yy) + 1e-8
        det = (Hxx * Hyy - Hxy * Hxy).clamp_min(1e-30)
        ixx, ixy, iyy = Hyy / det, -Hxy / det, Hxx / det

        def hll_inv(u):
            """Hll^-1 applied per landmark to u (L, Nl, 2)."""
            ux, uy = u[..., 0], u[..., 1]
            return torch.stack([ixx * ux + ixy * uy,
                                ixy * ux + iyy * uy], dim=-1)

        # rhs
        bp_odo = _assemble_rhs(g, r_o, Ji, Jj)
        or1, or2 = omega_w(r1, r2)
        bp_obs_local = scat_t(*jpT(or1, or2))
        bl_local = scat_j(*jlT(or1, or2))

        def hlp_v(v):
            o1, o2 = omega_w(*jp(v))
            return scat_j(*jlT(o1, o2))

        def hpl_u_local(u):
            o1, o2 = omega_w(*jl(u))
            return scat_t(*jpT(o1, o2))

        def hpp_obs_v(v):
            o1, o2 = omega_w(*jp(v))
            return scat_t(*jpT(o1, o2))

        def Sv(v):
            # local contributions, then one psum over the map shards
            u = hll_inv(hlp_v(v))
            total = mesh.psum(hpp_obs_v(v) - hpl_u_local(u))
            # odo part (with the gauge anchor) + damping, replicated
            return total + _hv(g, Ji, Jj, v, prob.anchor_w) + damping * v

        bp = bp_odo + mesh.psum(bp_obs_local)
        rhs = -bp + mesh.psum(hpl_u_local(hll_inv(bl_local)))
        # block-Jacobi preconditioner: 3x3 diagonal blocks of Hpp
        # (odometry-chain part with the anchor + the shards' observation
        # parts summed; the damping last, as the JAX package adds it)
        Dodo = _diag_blocks(g, Ji, Jj, prob.anchor_w, 0.0)
        # observation part of diag(Hpp): 6 unique comps of Jp^T (w Omega) Jp
        # with pose columns c_t = (0, -1), c_x = (ar_x, ab_x), c_y = (...)
        p1x, p2x = omega_w(ar_x, ab_x)
        p1y, p2y = omega_w(ar_y, ab_y)
        p_tt = w * w22
        p_tx = -p2x
        p_ty = -p2y
        p_xx = ar_x * p1x + ab_x * p2x
        p_xy = ar_x * p1y + ab_x * p2y
        p_yy = ar_y * p1y + ab_y * p2y
        Dflat = scat_t(p_tt, p_tx, p_ty, p_xx, p_xy, p_yy)
        Dobs = torch.stack([
            torch.stack([Dflat[..., 0], Dflat[..., 1], Dflat[..., 2]], -1),
            torch.stack([Dflat[..., 1], Dflat[..., 3], Dflat[..., 4]], -1),
            torch.stack([Dflat[..., 2], Dflat[..., 4], Dflat[..., 5]], -1),
        ], dim=-2)
        D = Dodo + mesh.psum(Dobs) + damping * torch.eye(
            3, dtype=dtype, device=device)

        # preconditioned CG on the replicated pose space
        dp = _cg(Sv, rhs, cg_iters, precond=lambda r: solve3(D, r))
        dl_local = -hll_inv(bl_local + hlp_v(dp))

        poses = prob.poses + dp
        poses = torch.cat([se2.normalize_angle(poses[:, :1]), poses[:, 1:]],
                          dim=1)
        # exact gauge fix (see models.pose_graph.gauge_project): G comes
        # from the replicated poses, the same rigid motion for every shard
        return gauge_project(poses, prob.poses[0], cur_landmarks + dl_local)

    return step
