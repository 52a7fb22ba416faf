"""Blocked, map-sharded EKF-SLAM state, the sequential tick and the deferred
tick (port of ``shermbot_navigation_tpu.parallel.blocked_ekf``, for B >= 1
worlds and S >= 1 map shards).

The covariance of the (3+2N)-dim SLAM state is kept as blocks:
``cov_rr`` (3, 3), the robot-landmark strip ``cov_rm`` (3, N, 2) and the
landmark grid ``cov_mm`` as four component planes (2, 2, N, N) with
``plane[p, q, n, m] = Sigma[(n, p), (m, q)]``, plus the own-block diagonal
cache ``diag4`` (PARITY D15), each with a leading world axis B. The
layouts are the JAX package's, so the tests compare like with like.

Two ticks with the same semantics (the reference's sequential
per-measurement order, PARITY P5):

- :func:`make_sequential_step` applies each measurement's init or Kalman
  update to the whole state in turn (``_init_landmark_shard``,
  ``_update_shard``, ``_associate_shard``): M full-grid rank-2 passes a
  tick.
- :func:`make_deferred_step` reads and writes the O(N^2) grid once a
  tick: predict touches only strips; the M-measurement scan
  (``ops/kernels/seq_scan``) works on O(N) strips and buffers each op; one
  fused pass (``ops/kernels/grid_update``) then replays the buffered init
  overwrites and subtracts the combined rank-2M term. Each kernel is
  launched once a tick for all B worlds (and all local shards).

Association is known (ids) or unknown (the reference's first-hit
Mahalanobis gates). The worlds are a leading tensor axis throughout, as
the JAX package's outer ``vmap``; nothing loops over them.

Map shards (``mesh=``, a :class:`~.mesh.MapMesh`): the landmark axis of
``mean_m``, ``cov_rm``, ``diag4``, ``seen`` and the grid's ROWS is split
into S blocks of N/S slots, as the JAX ``state_sharding`` splits it over
``'map'``. A process holds L of them on a leading local-shard axis
(:func:`shard_state`): ``mean_m (L, B, N/S, 2)``, ``cov_rm (L, B, 3,
N/S, 2)``, ``cov_mm (L, B, 2, 2, N/S, N)``, ``diag4 (L, B, 4, N/S)``,
``seen (L, B, N/S)``; ``mean_r``, ``cov_rr`` and ``n_seen`` are
replicated, one copy a shard. Each shard function is written once for
every layout: without a mesh there is no local-shard axis and the
collectives are identities; with one, the JAX ``psum`` / ``pmin`` /
``all_gather`` over ``'map'`` are the mesh's. Most psums are owner
broadcasts (every shard but the owner of slot g adds a zero), so the
result does not depend on how the shards are split between processes.
The grid keeps one layout, so kernel 1 takes the ``(L * B)`` fold of
rectangular planes in one launch a tick; kernel 2 (one map shard only)
runs at S = 1, and at S > 1 the scan is the plain one with collectives,
as the JAX package keeps the XLA scan there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig, _inv2x2, _motion_delta
from ..ops import se2
from ..utils.tracing import stage

INT_MAX = torch.iinfo(torch.int32).max


class BlockedState(NamedTuple):
    """Blocked state with a leading batch dim B (1 on the serving path);
    a process's map shards add a leading local-shard axis L to every
    field (:func:`shard_state`)."""

    mean_r: torch.Tensor   # (B, 3)  [theta, x, y]
    mean_m: torch.Tensor   # (B, N, 2)
    cov_rr: torch.Tensor   # (B, 3, 3)
    cov_rm: torch.Tensor   # (B, 3, N, 2)
    cov_mm: torch.Tensor   # (B, 2, 2, N, N) comp planes
    diag4: torch.Tensor    # (B, 4, N) own-block diagonal, [p*2+q][n]
    n_seen: torch.Tensor   # (B,) int32
    seen: torch.Tensor     # (B, N) bool


# The JAX package's ``state_sharding`` specs: for each global dim of each
# field, the mesh axis that splits it (worlds over 'data', landmark rows
# over 'map'; None: whole). Sharded checkpoints index shards by it.
STATE_SHARDING = BlockedState(
    mean_r=("data", None), mean_m=("data", "map", None),
    cov_rr=("data", None, None), cov_rm=("data", None, "map", None),
    cov_mm=("data", None, None, "map", None), diag4=("data", None, "map"),
    n_seen=("data",), seen=("data", "map"))
# the landmark axis each field splits over map shards (the grid's rows)
SHARDED_AXIS = {k: s.index("map") - len(s)
                for k, s in STATE_SHARDING._asdict().items() if "map" in s}
REPLICATED = tuple(k for k in BlockedState._fields if k not in SHARDED_AXIS)


def init(config: EKFConfig, batch: int, robot_pose=None,
         dtype=torch.float32, device=None) -> BlockedState:
    """Block-diagonal prior ``plane[p, q] = eye(N) * init_cov * eye(2)[p, q]``
    (the JAX ``init``, bit for bit). ``device=None`` is the card
    (``device.resolve``). Allocates the state and nothing else: the
    planes are zeros with their two diagonals written in place, so a map
    whose planes fill most of the card (16 N^2 bytes a world) still
    starts."""
    device = resolve(device)
    N = config.num_landmarks
    B = batch
    kw = dict(dtype=dtype, device=device)
    mean_r = torch.zeros((B, 3), **kw)
    if robot_pose is not None:
        mean_r[:] = torch.as_tensor(robot_pose, **kw)
    cov_mm = torch.zeros((B, 2, 2, N, N), **kw)
    diag4 = torch.zeros((B, 4, N), **kw)
    for p in range(2):
        torch.diagonal(cov_mm[:, p, p], dim1=-2, dim2=-1).fill_(
            config.init_cov)
        diag4[:, 3 * p].fill_(config.init_cov)
    return BlockedState(
        mean_r=mean_r,
        mean_m=torch.zeros((B, N, 2), **kw),
        cov_rr=torch.zeros((B, 3, 3), **kw),
        cov_rm=torch.zeros((B, 3, N, 2), **kw),
        cov_mm=cov_mm,
        diag4=diag4,
        n_seen=torch.zeros(B, dtype=torch.int32, device=device),
        seen=torch.zeros((B, N), dtype=torch.bool, device=device),
    )


def shard_state(state: BlockedState, mesh) -> BlockedState:
    """This process's shards of a global state: every field with the
    leading local-shard axis (the replicated ones copied to each)."""
    L, S, r = mesh.local_shards, mesh.shards, mesh.rank
    N = state.seen.shape[-1]
    if N % S:
        raise ValueError(f"N={N} is not divisible by {S} map shards")
    out = {}
    for k, x in state._asdict().items():
        if k in SHARDED_AXIS:
            parts = x.split(N // S, dim=SHARDED_AXIS[k])[r * L:(r + 1) * L]
            out[k] = torch.stack(parts).contiguous()
        else:
            out[k] = x.expand(L, *x.shape).clone()
    return BlockedState(**out)


def unshard_state(sharded: BlockedState, mesh) -> BlockedState:
    """The global state from every process's shards (a collective: every
    process of the map group calls it and gets the whole state)."""
    return BlockedState(**{
        k: (mesh.all_gather(x, SHARDED_AXIS[k]) if k in SHARDED_AXIS
            else x[0]) for k, x in sharded._asdict().items()})


# ---------------------------------------------------------------------------
# Shard helpers: one code path with or without a mesh
# ---------------------------------------------------------------------------

def _bc(c, k: int):
    """``c`` with ``k`` trailing unit dims, to broadcast against a tensor
    with ``k`` dims after c's."""
    return c.reshape(c.shape + (1,) * k)


def lead_index(lead, device) -> tuple:
    """Index tensors, broadcastable to ``lead``, that select every leading
    position: ``x[(*lead_index(lead), ..., i)]`` reads slot ``i[...]`` of
    each (world, shard)."""
    n = len(lead)
    return tuple(torch.arange(s, device=device).reshape(
        (s,) + (1,) * (n - 1 - a)) for a, s in enumerate(lead))


def shard_offset(mesh, n_local: int, device):
    """The global slot of each local shard's first slot: (L, 1) under a
    mesh, 0 without one."""
    if mesh is None:
        return torch.zeros((), dtype=torch.int64, device=device)
    return mesh.offsets(n_local)


def owner_values(mesh, owns, *xs):
    """The values the owner of a slot read (``xs``, each with the leading
    shape of ``owns``, read at the slot's local index on every shard) on
    every shard: the JAX owner broadcast ``psum(w_own * x)``, packed into
    one collective. Without a mesh each x is the owner's already."""
    if mesh is None:
        return xs
    k = owns.dim()
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flat = [x.reshape(*x.shape[:k], -1).to(dtype) for x in xs]
    sizes = [f.shape[-1] for f in flat]
    packed = torch.where(owns[..., None], torch.cat(flat, -1),
                         torch.zeros((), dtype=dtype, device=owns.device))
    outs = mesh.psum(packed).split(sizes, -1)
    return tuple(o.reshape(o.shape[:-1] + x.shape[k:]).to(x.dtype)
                 for o, x in zip(outs, xs))


def _slot(mesh, g, n_local):
    """Global slot ``g`` on each shard: (owns, local index clamped)."""
    gl = g - shard_offset(mesh, n_local, g.device)
    return (gl >= 0) & (gl < n_local), gl.clamp(0, n_local - 1)


def _gather(mesh, x, dim):
    """Every shard's ``x`` along the landmark axis ``dim`` (the JAX tiled
    ``all_gather``); without a mesh, ``x``."""
    return x if mesh is None else mesh.all_gather(x, dim)


def _first_hit(mesh, dist, gate, n_local):
    """The smallest global slot whose ``dist`` (every lane's, inf unseen)
    is below ``gate`` (any_hit, first, 0 if none) and the owner's distance
    there (0 if none; inf and NaN read as 0): the JAX ``pmin`` of the
    first hit and the psum of its distance."""
    dev = dist.device
    off = shard_offset(mesh, n_local, dev)
    grow = off[..., None] + torch.arange(n_local, device=dev)
    first = torch.where(dist < gate, grow, INT_MAX).amin(-1)
    if mesh is not None:
        first = mesh.pmin(first)
    any_hit = first < INT_MAX
    first = torch.where(any_hit, first, 0)
    owns, fl = _slot(mesh, first, n_local)
    ix = lead_index(dist.shape[:-1], dev)
    d = torch.where(any_hit, torch.nan_to_num(dist[(*ix, fl)], nan=0.0,
                                              posinf=0.0),
                    torch.zeros((), dtype=dist.dtype, device=dev))
    d_first, = owner_values(mesh, owns, d)
    return any_hit, first, d_first


def _predict_shard(config: EKFConfig, st: BlockedState, twist, Q
                   ) -> BlockedState:
    """Rank-2 strip predict on B worlds, twist (B, 3): only ``mean_r``,
    ``cov_rr`` and rows 1:3 of the strip change (no communication)."""
    theta = st.mean_r[..., 0]
    dq, b = _motion_delta(theta, twist)          # (B, 3), (B, 2)
    mean_r = st.mean_r + dq

    r0_r = st.cov_rr[..., 0, :]                  # (B, 3)
    r0_m = st.cov_rm[..., 0, :, :]               # (..., Nl, 2)
    s00 = st.cov_rr[..., 0, 0]

    cov_rr = st.cov_rr.clone()
    cov_rr[..., 1:3, :] += b[..., :, None] * r0_r[..., None, :]
    cov_rr[..., :, 1:3] += r0_r[..., :, None] * b[..., None, :]
    cov_rr[..., 1:3, 1:3] += (s00[..., None, None] * b[..., :, None]
                              * b[..., None, :])
    cov_rr = cov_rr + Q

    cov_rm = st.cov_rm.clone()
    cov_rm[..., 1:3, :, :] += b[..., :, None, None] * r0_m[..., None, :, :]
    return st._replace(mean_r=mean_r, cov_rr=cov_rr, cov_rm=cov_rm)


def _h5_coeffs(mean_r, mj):
    """Measurement geometry and the compressed 2x5 Jacobian on the basis
    ``[theta, x, y, mx, my]``: mean_r (..., 3), mj (..., 2) -> ``(H5
    (..., 2, 5), z_hat (..., 2))``."""
    dx = mj[..., 0] - mean_r[..., 1]
    dy = mj[..., 1] - mean_r[..., 2]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)
    z = torch.zeros_like(dx)
    row0 = torch.stack([z, -dx / sq, -dy / sq, dx / sq, dy / sq], dim=-1)
    row1 = torch.stack([-torch.ones_like(dx), dy / d, -dx / d, -dy / d,
                        dx / d], dim=-1)
    H5 = torch.stack([row0, row1], dim=-2)
    z_hat = torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - mean_r[..., 0])],
        dim=-1)
    return H5, z_hat


def _associate_comp(mean_r, mm2, cov_rr, rm6, seen, z, R, diag4, *,
                    new_gate: float, wrap_innovation: bool, mesh=None):
    """First-hit Mahalanobis association on component strips (the JAX
    ``_associate_comp``): psi = H5 S5 H5^T + R per landmark from
    ``cov_rr``, the strip ``rm6`` and the carried own-block diagonal
    ``diag4`` (comps [p*2+q][n]), without a determinant floor, as there.
    Strips (..., k, Nl) and robot values (..., 3) with any leading dims;
    the shards' first hits resolved over the mesh.

    Returns ``(any_hit, first, d_first, dist)``: whether a seen slot scores
    below ``new_gate``, the first such global slot (0 if none), its
    distance (0 if none; inf and NaN read as 0) and every local slot's
    distance (inf unseen).
    """
    Nl = mm2.shape[-1]
    r = lambda t, *i: t[(..., *i, None)]   # a robot value against the lanes
    dx = mm2[..., 0, :] - r(mean_r, 1)
    dy = mm2[..., 1, :] - r(mean_r, 2)
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)
    a = dx / sq
    b = dy / sq
    c = dy / d
    e = -dx / d
    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    w = ((zero, -a, -b, a, b), (-one, c, e, -c, -e))
    psi = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(r(cov_rr, k, 0) * wl[0] + r(cov_rr, k, 1) * wl[1]
                     + r(cov_rr, k, 2) * wl[2]
                     + rm6[..., k * 2 + 0, :] * wl[3]
                     + rm6[..., k * 2 + 1, :] * wl[4])
        for p in range(2):
            u.append(rm6[..., 0 * 2 + p, :] * wl[0]
                     + rm6[..., 1 * 2 + p, :] * wl[1]
                     + rm6[..., 2 * 2 + p, :] * wl[2]
                     + diag4[..., p * 2 + 0, :] * wl[3]
                     + diag4[..., p * 2 + 1, :] * wl[4])
        for p in range(2):
            wp = w[p]
            psi[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                         + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]
    p00, p01, p10, p11 = psi[0][0], psi[0][1], psi[1][0], psi[1][1]
    det = p00 * p11 - p01 * p10

    z_hat1 = se2.normalize_angle(torch.atan2(dy, dx) - r(mean_r, 0))
    dz0 = r(z, 0) - sq
    dz1 = r(z, 1) - z_hat1
    if wrap_innovation:
        dz1 = se2.normalize_angle(dz1)
    dist = (dz0 * (p11 * dz0 - p01 * dz1)
            + dz1 * (-p10 * dz0 + p00 * dz1)) / det
    dist = torch.where(seen, dist, torch.full_like(dist, float("inf")))
    any_hit, first, d_first = _first_hit(mesh, dist, new_gate, Nl)
    return any_hit, first, d_first, dist


# ---------------------------------------------------------------------------
# The sequential tick: each measurement applied to the whole state in turn
# ---------------------------------------------------------------------------

def _update_shard(config: EKFConfig, st: BlockedState, z, j, R, gate,
                  mesh=None) -> BlockedState:
    """Kalman update of world b against global slot ``j[b]`` where
    ``gate[b]`` (the JAX ``_update_shard`` and its caller's
    ``where(do_update, upd, pre)``): z (B, 2), j (B,) in [0, N).
    Communication: one owner broadcast of the slot's mean and strip
    column, one of its ``Sigma H^T`` block, and an ``all_gather`` of the
    ``Sigma H^T`` strip.

    The grid's rank-2 subtraction is one pass over ``st.cov_mm`` IN
    PLACE, with the gain and ``Sigma H^T`` strips of an ungated world
    replaced by zeros (``x - 0`` is ``x``); every other field is new."""
    lead = st.mean_m.shape[:-2]
    Nl = st.mean_m.shape[-2]
    ix = lead_index(lead, j.device)
    owns, js = _slot(mesh, j, Nl)
    mj, rm_j = owner_values(mesh, owns, st.mean_m[(*ix, js)],
                            st.cov_rm[(*ix, slice(None), js)])
    H5, z_hat = _h5_coeffs(st.mean_r, mj)                      # (B,2,5)

    # Sigma H^T, robot rows (B, 3, 2): [cov_rr | cov_rm[:, j]] H5^T
    SHt_r = torch.cat([st.cov_rr, rm_j], dim=-1) @ H5.transpose(-1, -2)
    # Sigma H^T, local map rows (..., Nl, 2, 2): [cov_mr | grid column j]
    cov_mr = st.cov_rm.movedim(-3, -1)                         # (.,Nl,2,3)
    sl = slice(None)
    mm_colj = st.cov_mm[(*ix, sl, sl, sl, j)].movedim(-1, -3)  # (.,Nl,2,2)
    cols5 = torch.cat([cov_mr, mm_colj], dim=-1)               # (.,Nl,2,5)
    SHt_m = torch.einsum("...npk,...qk->...npq", cols5, H5)

    SHt_j, = owner_values(mesh, owns, SHt_m[(*ix, js)])        # (B, 2, 2)
    psi = H5 @ torch.cat([SHt_r, SHt_j], dim=-2) + R
    psi_inv = _inv2x2(psi)
    K_r = SHt_r @ psi_inv                                      # (B, 3, 2)
    K_m = torch.einsum("...npq,...qr->...npr", SHt_m, psi_inv)

    dz = z - z_hat
    if config.wrap_innovation:
        dz = torch.stack([dz[..., 0], se2.normalize_angle(dz[..., 1])],
                         dim=-1)
    mean_r = st.mean_r + (K_r @ dz[..., None])[..., 0]
    mean_r = torch.cat([se2.normalize_angle(mean_r[..., :1]),
                        mean_r[..., 1:]], dim=-1)
    mean_m = st.mean_m + torch.einsum("...npq,...q->...np", K_m, dz)
    cov_rr = st.cov_rr - K_r @ SHt_r.transpose(-1, -2)
    cov_rm = st.cov_rm - torch.einsum("...iq,...npq->...inp", K_r, SHt_m)
    # own-block diagonal cache: the same rank-2 subtraction
    diag4 = st.diag4 - torch.stack(
        [K_m[..., p, 0] * SHt_m[..., r, 0] + K_m[..., p, 1] * SHt_m[..., r, 1]
         for p in range(2) for r in range(2)], dim=-2)
    if config.symmetrize:
        cov_rr = 0.5 * (cov_rr + cov_rr.transpose(-1, -2))

    # plane (p, r) -= K_m[:, p, :] HS_m[:, r, :]^T over every global
    # column, one batched pass
    N = st.cov_mm.shape[-1]
    zero = torch.zeros((), dtype=K_m.dtype, device=K_m.device)
    Kz = torch.where(_bc(gate, 3), K_m, zero)
    Hz = torch.where(_bc(gate, 3), _gather(mesh, SHt_m, -3), zero)
    a = Kz.movedim(-2, -3)[..., :, None, :, :].expand(*lead, 2, 2, Nl, 2)
    b = Hz.movedim(-3, -1)[..., None, :, :, :].expand(*lead, 2, 2, 2, N)
    W = math.prod(lead) * 4
    st.cov_mm.view(W, Nl, N).baddbmm_(a.reshape(W, Nl, 2),
                                      b.reshape(W, 2, N), alpha=-1)

    sel = lambda new, old, k: torch.where(_bc(gate, k), new, old)
    return st._replace(mean_r=sel(mean_r, st.mean_r, 1),
                       mean_m=sel(mean_m, st.mean_m, 2),
                       cov_rr=sel(cov_rr, st.cov_rr, 2),
                       cov_rm=sel(cov_rm, st.cov_rm, 3),
                       diag4=sel(diag4, st.diag4, 2))


def _init_landmark_shard(config: EKFConfig, st: BlockedState, z, j, R, gate,
                         mesh=None) -> BlockedState:
    """Analytic first-observation init of global slot ``j[b]`` in world b
    where ``gate[b]`` (the JAX ``_init_landmark_shard`` with its caller's
    ``where(is_new, s_init, s)``, ``n_seen`` and ``seen``): the mean, the
    robot cross strip, then on the grid the row (owner), the column (every
    shard's rows) and the own 2x2 block (owner), in that order (the later
    write wins where they cross), and ``diag4``. Communication: an
    ``all_gather`` of the cross strip. The grid is written IN PLACE, its
    row and column only; an ungated world's are written back unchanged."""
    lead = st.mean_m.shape[:-2]
    Nl = st.mean_m.shape[-2]
    ix = lead_index(lead, j.device)
    owns, js = _slot(mesh, j, Nl)
    ow = owns & gate
    th, x, y = st.mean_r[..., 0], st.mean_r[..., 1], st.mean_r[..., 2]
    a = z[..., 1] + th
    r = z[..., 0]
    sa, ca = torch.sin(a), torch.cos(a)
    m = torch.stack([x + r * ca, y + r * sa], dim=-1)          # (B, 2)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    Gx = torch.stack([torch.stack([-r * sa, one, zero], dim=-1),
                      torch.stack([r * ca, zero, one], dim=-1)], dim=-2)
    Gz = torch.stack([torch.stack([ca, -r * sa], dim=-1),
                      torch.stack([sa, r * ca], dim=-1)], dim=-2)

    def put(t, idx, new, g):
        old = t[idx]
        t[idx] = torch.where(_bc(g, old.dim() - len(lead)), new, old)

    sl = slice(None)
    mean_m = st.mean_m.clone()
    put(mean_m, (*ix, js), m, ow)
    # cross strip to the robot: cov_rm[:, j] = (Gx Srr)^T
    cov_rm = st.cov_rm.clone()
    put(cov_rm, (*ix, sl, js), (Gx @ st.cov_rr).transpose(-1, -2), ow)
    # cross to the landmarks, Gx Sigma_{r, m}, from the strip before the
    # write above: crossc[p, q, m] (..., 2, 2, Nl), this shard's columns
    crossc = torch.einsum("...pi,...imq->...pqm", Gx, st.cov_rm)
    grid = st.cov_mm
    put(grid, (*ix, sl, sl, js), _gather(mesh, crossc, -1), ow)   # row j
    # column j, by symmetry comp (p, q) of the column is comp (q, p)
    put(grid, (*ix, sl, sl, sl, j), crossc.transpose(-3, -2), gate)
    # own block Gx Srr Gx^T + Gz R Gz^T
    block = ((Gx @ st.cov_rr) @ Gx.transpose(-1, -2)
             + (Gz @ R) @ Gz.transpose(-1, -2))
    put(grid, (*ix, sl, sl, js, j), block, ow)
    diag4 = st.diag4.clone()
    put(diag4, (*ix, sl, js), block.reshape(*block.shape[:-2], 4), ow)
    seen = st.seen.clone()
    seen[(*ix, js)] = seen[(*ix, js)] | ow
    return st._replace(mean_m=mean_m, cov_rm=cov_rm, diag4=diag4,
                       n_seen=st.n_seen + gate.to(st.n_seen.dtype),
                       seen=seen)


def _associate_shard(config: EKFConfig, st: BlockedState, z, R, mesh=None):
    """Blockwise Mahalanobis association with global first-hit resolution
    (the JAX ``_associate_shard``): psi = H5 S5 H5^T + R per local
    landmark from ``cov_rr``, the strip and the carried own-block
    diagonal ``diag4``, the first hit resolved over the shards. Returns
    ``(any_hit, first, d_first)``, each (B,): whether a seen slot scores
    below ``new_gate``, the first such slot (0 if none) and its distance
    (0 if none; inf and NaN read as 0)."""
    lead = st.mean_m.shape[:-2]
    Nl = st.mean_m.shape[-2]
    mr = st.mean_r
    dx = st.mean_m[..., 0] - mr[..., 1:2]                      # (..., Nl)
    dy = st.mean_m[..., 1] - mr[..., 2:3]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)
    zeros = torch.zeros_like(dx)
    H5 = torch.stack([
        torch.stack([zeros, -dx / sq, -dy / sq, dx / sq, dy / sq], dim=-1),
        torch.stack([-torch.ones_like(dx), dy / d, -dx / d, -dy / d, dx / d],
                    dim=-1)], dim=-2)                          # (., Nl, 2, 5)
    Srm = st.cov_rm.movedim(-3, -2)                            # (., Nl, 3, 2)
    Smm = st.diag4.reshape(*lead, 2, 2, Nl).movedim(-1, -3)    # (., Nl, 2, 2)
    top = torch.cat([st.cov_rr[..., None, :, :].expand(*lead, Nl, 3, 3),
                     Srm], dim=-1)
    bot = torch.cat([Srm.transpose(-1, -2), Smm], dim=-1)
    S5 = torch.cat([top, bot], dim=-2)                         # (., Nl, 5, 5)
    psi = torch.einsum("...nij,...njk,...nlk->...nil", H5, S5, H5) + R
    z_hat = torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - mr[..., 0:1])],
        dim=-1)
    dz = z[..., None, :] - z_hat
    if config.wrap_innovation:
        dz = torch.stack([dz[..., 0], se2.normalize_angle(dz[..., 1])],
                         dim=-1)
    dist = torch.einsum("...ni,...nij,...nj->...n", dz, _inv2x2(psi), dz)
    dist = torch.where(st.seen, dist, torch.full_like(dist, float("inf")))
    return _first_hit(mesh, dist, config.new_gate, Nl)


def _replicas_out(state: BlockedState, mesh) -> BlockedState:
    """Inside a tick the replicated fields are kept once: shard 0's."""
    if mesh is None:
        return state
    return state._replace(**{k: getattr(state, k)[0] for k in REPLICATED})


def _replicas_in(st: BlockedState, mesh) -> BlockedState:
    """Back to one copy of the replicated fields a local shard."""
    if mesh is None:
        return st
    L = mesh.local_shards
    return st._replace(**{k: getattr(st, k).expand(L, *getattr(st, k).shape)
                          .clone() for k in REPLICATED})


def _built_for(config: EKFConfig, mesh):
    """The map shards a tick is built for (1 without a mesh)."""
    S = 1 if mesh is None else mesh.shards
    if config.num_landmarks % S:
        raise ValueError(f"num_landmarks {config.num_landmarks} not "
                         f"divisible by map={S}")
    return S


def make_sequential_step(config: EKFConfig, max_meas: int, device,
                         known: bool = True, decisions=None, mesh=None):
    """Build the sequential tick for B worlds, known or unknown
    association: the port of the JAX ``make_sharded_step`` (known) and
    ``make_sharded_unknown_step`` (unknown).

    Returns ``step(state, twist (B, 3), zs (B, M, 2), valid (B, M),
    ids (B, M), Q, R) -> state`` (``known=True``; an id outside [0, N) is
    a full no-op) or ``step(state, twist, zs, valid, Q, R)``
    (``known=False``: match -> update, gray zone -> skip, all-far -> a new
    slot at ``n_seen``; a measurement that finds the map full stops the
    rest of the world's tick) on a :class:`BlockedState` on ``device``:
    the global state, or with ``mesh`` this process's shards of it
    (:func:`shard_state`). Each measurement is applied to the whole state,
    grid included: M full-grid rank-2 passes a tick, no kernel. The grid
    is updated IN PLACE (the returned state shares ``state.cov_mm``'s
    storage). ``decisions`` (a list) receives each tick's ``(kind,
    slot)``, both (B, M) int32: 0 no op (invalid, skipped or stopped), 1
    update, 2 init, and the slot, -1 for no op (the deferred scan's
    ``kindb`` and ``gb``)."""
    device = resolve(device)
    N = config.num_landmarks
    M = max_meas
    _built_for(config, mesh)

    def step(state: BlockedState, twist, zs, valid, *rest) -> BlockedState:
        ids, Q, R = rest if known else (None, *rest)
        _check(state, zs, device, M, mesh)
        st = _predict_shard(config, _replicas_out(state, mesh), twist, Q)
        if not st.cov_mm.is_contiguous():
            st = st._replace(cov_mm=st.cov_mm.contiguous())
        Nl = st.seen.shape[-1]
        ix = lead_index(st.seen.shape[:-1], device)
        stopped = torch.zeros_like(st.n_seen, dtype=torch.bool)
        kinds, slots = [], []
        for k in range(M):
            z, v = zs[:, k], valid[:, k]
            if known:
                g = ids[:, k].long()
                v = v & (g >= 0) & (g < N)
                g = g.clamp(0, N - 1)
                owns, gs = _slot(mesh, g, Nl)
                seen_g, = owner_values(mesh, owns, st.seen[(*ix, gs)])
                is_new, do_update = v & ~seen_g, v & seen_g
            else:
                act = v & ~stopped
                any_hit, first, d_first = _associate_shard(config, st, z, R,
                                                           mesh)
                no_seen = st.n_seen == 0
                want_new = act & (no_seen | ~any_hit)
                cap_full = st.n_seen >= N
                do_update = (act & ~no_seen & any_hit
                             & (d_first < config.match_gate))
                is_new = want_new & ~cap_full
                stopped = stopped | (want_new & cap_full)
                g = torch.where(do_update, first,
                                torch.clamp_max(st.n_seen, N - 1).long())
            st = _init_landmark_shard(config, st, z, g, R, is_new, mesh)
            st = _update_shard(config, st, z, g, R, do_update, mesh)
            if decisions is not None:
                kind = torch.where(do_update, 1, torch.where(is_new, 2, 0))
                kinds.append(kind.to(torch.int32))
                slots.append(torch.where(kind > 0, g, -1).to(torch.int32))
        if decisions is not None:
            decisions.append((torch.stack(kinds, 1), torch.stack(slots, 1)))
        return _replicas_in(st, mesh)

    return step


# ---------------------------------------------------------------------------
# The deferred tick: one grid pass a tick
# ---------------------------------------------------------------------------

def _lead_permute(x, tail):
    """``x.permute`` of its last ``len(tail)`` dims by ``tail``, the
    leading dims kept."""
    k = x.dim() - len(tail)
    return x.permute(*range(k), *(k + t for t in tail))


def grid_operands(Kb, HSb, CRb, gb, kb, mesh=None):
    """The grid pass's operands from the scan's op buffers, for one world
    or with a leading world axis B on every argument and result; with
    ``mesh``, from this process's shards' buffers (L, B, ...) of the
    sharded scan.

    ``rowT[n]`` is the index of the tick's last init of the shard's LOCAL
    row n and ``colT[m]`` that of GLOBAL column m (-1 = none; at one shard
    the same vector). Only updates after a slot's last init are subtracted
    on its row (``Kmask``) and column (``HSmask``); the columns need every
    shard's ``Sigma H^T`` and cross strips, one ``all_gather`` a tick.
    Returns ``(A, Bm, crow, ccol, rowT, colT)`` with A (2, Nl, 2M),
    Bm (2, 2M, N), crow (2, 2, M, N), ccol (2, 2, Nl, M), rowT (Nl,),
    colT (N,); with a mesh, for the ``(L * B)`` fold of plane sets
    ``cov_mm.view(L * B, 2, 2, Nl, N)`` that kernel 1 takes in one launch
    (the replicated operands copied to each local shard).
    """
    *lead, M, _, Nl = Kb.shape
    dev = Kb.device
    if mesh is None:
        HSfull, CRfull = HSb, CRb
    else:
        HSfull, CRfull = mesh.all_gather(torch.cat([HSb, CRb], -2),
                                         -1).split(4, -2)
    N = HSfull.shape[-1]
    iota = torch.arange(M, dtype=torch.int32, device=dev)
    gcol = torch.arange(N, dtype=torch.int32, device=dev)
    init = (kb == 2)[..., None]                                # (.., M, 1)

    def last_init(slots):
        hits = init & (gb[..., None] == slots[..., None, :])
        return torch.where(hits, iota[:, None], -1).amax(dim=-2).to(
            torch.int32)

    colT = last_init(gcol)
    rowT = colT if mesh is None else last_init(
        (mesh.offsets(Nl)[..., None] + gcol[:Nl]).to(torch.int32))
    later = lambda T: (iota[:, None] > T[..., None, :])[..., None, :]
    Kmask = Kb * later(rowT).to(Kb.dtype)                      # (.., M, 4, Nl)
    HSmask = HSfull * later(colT).to(HSb.dtype)                # (.., M, 4, N)
    # comp buffers [i, p*2+c, n] reshape to
    #   A[p][n, 2i+c] = Kmask[i, p*2+c, n]     B[r][2i+c, m] = HSmask[i, r*2+c, m]
    #   crow[p, r, i, m] = CRfull[i, p*2+r, m]  ccol[p, r, n, i] = CRb[i, r*2+p, n]
    comps = lambda x: x.reshape(*x.shape[:-2], 2, 2, x.shape[-1])
    A = _lead_permute(comps(Kmask), (1, 3, 0, 2)).reshape(*lead, 2, Nl,
                                                           2 * M)
    Bm = _lead_permute(comps(HSmask), (1, 0, 2, 3))
    Bm = Bm.reshape(*Bm.shape[:-4], 2, 2 * M, N)
    crow = _lead_permute(comps(CRfull), (1, 2, 0, 3)).contiguous()
    ccol = _lead_permute(comps(CRb), (2, 1, 3, 0)).contiguous()
    ops = (A.contiguous(), Bm.contiguous(), crow, ccol, rowT, colT)
    if mesh is None:
        return ops
    return tuple(x.expand(*lead, *x.shape[-k:]).reshape(-1, *x.shape[-k:])
                 for x, k in zip(ops, (3, 3, 4, 4, 1, 1)))


def _check(state: BlockedState, zs, device, M, mesh=None):
    if resolve(state.cov_mm.device) != device:
        raise ValueError(f"state on {state.cov_mm.device}, step built "
                         f"for {device}")
    B = state.mean_r.shape[-2]
    if tuple(zs.shape) != (B, M, 2):
        raise ValueError(f"zs must be ({B}, {M}, 2) for a state of {B} "
                         f"worlds, got {tuple(zs.shape)}")
    L = 1 if mesh is None else mesh.local_shards
    want = (B, 2, 2) if mesh is None else (L, B, 2, 2)
    if tuple(state.cov_mm.shape[:-2]) != want:
        raise ValueError(f"cov_mm must lead with {want}, got "
                         f"{tuple(state.cov_mm.shape)}")


def make_deferred_step(config: EKFConfig, max_meas: int, device,
                       known: bool = True, gate_margins=None,
                       decisions=None, mesh=None):
    """Build the deferred tick for B worlds, known or unknown association
    (the JAX ``make_sharded_deferred_step`` /
    ``make_sharded_deferred_unknown_step``).

    Returns ``step(state, twist (B, 3), zs (B, M, 2), valid (B, M),
    ids (B, M), Q, R) -> state`` (``known=True``) or ``step(state, twist,
    zs, valid, Q, R)`` (``known=False``: the reference's first-hit gates,
    ``config.match_gate`` / ``new_gate``; slots fill in order; a
    measurement that finds the map full stops the rest of the world's
    tick) on a :class:`BlockedState` of B worlds on ``device`` (with
    ``mesh``, this process's shards: :func:`shard_state`); the same
    semantics as :func:`make_sequential_step`. Kernel 1 (the grid pass)
    is launched once a tick for all B worlds and local shards; kernel 2
    (the scan) once a tick at one map shard, while at S > 1 the scan is
    the plain one with the mesh's collectives. On the CPU both are their
    plain versions (``ops/kernels``). ``gate_margins`` (a list; unknown
    association on the plain scan, one shard) collects each
    measurement's smallest relative margin to a gate
    (``seq_scan.reference_seq_scan``; (B,) a measurement). ``decisions``
    (a list) receives each tick's ``(kind, slot)`` as in
    :func:`make_sequential_step`.

    The grid pass updates ``state.cov_mm``'s storage IN PLACE (the JAX
    version donates the buffer instead); the returned state shares it.
    """
    from ..ops.kernels.grid_update import fused_grid_update
    from ..ops.kernels.seq_scan import deferred_seq_scan, reference_seq_scan

    device = resolve(device)
    M = max_meas
    S = _built_for(config, mesh)
    if S > 1 and gate_margins is not None:
        raise ValueError("gate_margins needs one map shard")
    gates = dict(known=known, match_gate=config.match_gate,
                 new_gate=config.new_gate,
                 wrap_innovation=config.wrap_innovation,
                 symmetrize=config.symmetrize)

    def step(state: BlockedState, twist, zs, valid, *rest) -> BlockedState:
        ids, Q, R = rest if known else (None, *rest)
        _check(state, zs, device, M, mesh)
        st = _predict_shard(config, _replicas_out(state, mesh), twist, Q)
        lead = st.seen.shape[:-1]                        # (B,) or (L, B)
        Nl, N = st.cov_mm.shape[-2:]
        cov_mm0 = st.cov_mm                              # (.., 2, 2, Nl, N)
        sharded = (st.mean_m.transpose(-1, -2).contiguous(),
                   st.cov_rm.transpose(-1, -2).reshape(*lead, 6, Nl),
                   st.diag4, st.seen, cov_mm0.reshape(*lead, 4, Nl, N))
        if S == 1:
            # one map shard: kernel 2 (a mesh's one local shard dropped)
            one = (lambda x: x[0]) if mesh is not None else (lambda x: x)
            mm2, rm6, diag4, seen, mm0p = map(one, sharded)
            outs = list(deferred_seq_scan(
                st.mean_r, mm2, st.cov_rr, rm6, diag4, seen, st.n_seen,
                mm0p, zs, valid, ids, R, gate_margins=gate_margins,
                **gates))
            if mesh is not None:
                for i in (1, 3, 4, 5):
                    outs[i] = outs[i][None]
        else:
            mm2, rm6, diag4, seen, mm0p = sharded
            outs = reference_seq_scan(
                st.mean_r, mm2, st.cov_rr, rm6, diag4, seen, st.n_seen,
                mm0p, zs, valid, ids, R, mesh=mesh, **gates)
        (mr_o, mm2_o, crr_o, rm6_o, diag_o, seen_o, ns_o,
         Kb, HSb, CRb, gb, kb) = outs
        if decisions is not None:
            decisions.append((kb, gb))
        operands = grid_operands(Kb, HSb, CRb, gb, kb,
                                 mesh if S > 1 else None)
        # every local shard's and world's planes: one launch a tick
        with stage("blocked.grid_pass", device):
            cov = fused_grid_update(cov_mm0.view(-1, 2, 2, Nl, N), *operands)
        return _replicas_in(BlockedState(
            mean_r=mr_o,
            mean_m=mm2_o.transpose(-1, -2).contiguous(),
            cov_rr=crr_o,
            cov_rm=rm6_o.reshape(*lead, 3, 2, Nl).transpose(-1, -2)
            .contiguous(),
            cov_mm=cov.view(cov_mm0.shape),
            diag4=diag_o,
            n_seen=ns_o,
            seen=seen_o), mesh)

    return step
