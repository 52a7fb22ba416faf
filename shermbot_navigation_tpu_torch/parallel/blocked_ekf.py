"""Blocked EKF-SLAM state, the sequential tick and the deferred tick (port
of ``shermbot_navigation_tpu.parallel.blocked_ekf`` at map=1, for B >= 1
worlds).

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
  launched once a tick for all B worlds.

Association is known (ids) or unknown (the reference's first-hit
Mahalanobis gates). The worlds are a leading tensor axis throughout, as
the JAX package's outer ``vmap``; nothing loops over them. With one map
shard the JAX version's ``pmin``/``psum``/``all_gather`` over ``'map'``
are identities and are dropped here; map shards (several devices) are
ROADMAP queue 5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig, _inv2x2, _motion_delta
from ..ops import se2

INT_MAX = torch.iinfo(torch.int32).max


class BlockedState(NamedTuple):
    """Blocked state with a leading batch dim B (1 on the serving path)."""

    mean_r: torch.Tensor   # (B, 3)  [theta, x, y]
    mean_m: torch.Tensor   # (B, N, 2)
    cov_rr: torch.Tensor   # (B, 3, 3)
    cov_rm: torch.Tensor   # (B, 3, N, 2)
    cov_mm: torch.Tensor   # (B, 2, 2, N, N) comp planes
    diag4: torch.Tensor    # (B, 4, N) own-block diagonal, [p*2+q][n]
    n_seen: torch.Tensor   # (B,) int32
    seen: torch.Tensor     # (B, N) bool


def init(config: EKFConfig, batch: int, robot_pose=None,
         dtype=torch.float32, device=None) -> BlockedState:
    """Block-diagonal prior ``plane[p, q] = eye(N) * init_cov * eye(2)[p, q]``
    (the JAX ``init``). ``device=None`` is the card (``device.resolve``)."""
    device = resolve(device)
    N = config.num_landmarks
    B = batch
    kw = dict(dtype=dtype, device=device)
    mean_r = torch.zeros((B, 3), **kw)
    if robot_pose is not None:
        mean_r[:] = torch.as_tensor(robot_pose, **kw)
    diag = torch.eye(2, **kw) * config.init_cov
    cov_mm = torch.eye(N, **kw)[None, None] * diag[:, :, None, None]
    return BlockedState(
        mean_r=mean_r,
        mean_m=torch.zeros((B, N, 2), **kw),
        cov_rr=torch.zeros((B, 3, 3), **kw),
        cov_rm=torch.zeros((B, 3, N, 2), **kw),
        cov_mm=cov_mm[None].repeat(B, 1, 1, 1, 1),
        diag4=diag.reshape(4)[None, :, None].repeat(B, 1, N),
        n_seen=torch.zeros(B, dtype=torch.int32, device=device),
        seen=torch.zeros((B, N), dtype=torch.bool, device=device),
    )


def _predict_shard(config: EKFConfig, st: BlockedState, twist, Q
                   ) -> BlockedState:
    """Rank-2 strip predict on B worlds, twist (B, 3): only ``mean_r``,
    ``cov_rr`` and rows 1:3 of the strip change."""
    theta = st.mean_r[:, 0]
    dq, b = _motion_delta(theta, twist)          # (B, 3), (B, 2)
    mean_r = st.mean_r + dq

    r0_r = st.cov_rr[:, 0, :]                    # (B, 3)
    r0_m = st.cov_rm[:, 0]                       # (B, N, 2)
    s00 = st.cov_rr[:, 0, 0]

    cov_rr = st.cov_rr.clone()
    cov_rr[:, 1:3, :] += b[:, :, None] * r0_r[:, None, :]
    cov_rr[:, :, 1:3] += r0_r[:, :, None] * b[:, None, :]
    cov_rr[:, 1:3, 1:3] += s00[:, None, None] * b[:, :, None] * b[:, None, :]
    cov_rr = cov_rr + Q

    cov_rm = st.cov_rm.clone()
    cov_rm[:, 1:3] += b[:, :, None, None] * r0_m[:, None, :, :]
    return st._replace(mean_r=mean_r, cov_rr=cov_rr, cov_rm=cov_rm)


def _h5_coeffs(mean_r, mj):
    """Measurement geometry and the compressed 2x5 Jacobian on the basis
    ``[theta, x, y, mx, my]``; returns ``(H5, z_hat)``."""
    dx = mj[0] - mean_r[1]
    dy = mj[1] - mean_r[2]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)
    z = torch.zeros_like(dx)
    row0 = torch.stack([z, -dx / sq, -dy / sq, dx / sq, dy / sq])
    row1 = torch.stack([-torch.ones_like(dx), dy / d, -dx / d, -dy / d,
                        dx / d])
    H5 = torch.stack([row0, row1])
    z_hat = torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - mean_r[0])])
    return H5, z_hat


def _associate_comp(mean_r, mm2, cov_rr, rm6, seen, z, R, diag4, *,
                    new_gate: float, wrap_innovation: bool):
    """First-hit Mahalanobis association on component strips (the JAX
    ``_associate_comp`` at map=1): psi = H5 S5 H5^T + R per landmark from
    ``cov_rr``, the strip ``rm6`` and the carried own-block diagonal
    ``diag4`` (comps [p*2+q][n]), without a determinant floor, as there.

    Returns ``(any_hit, first, d_first, dist)``: whether a seen slot scores
    below ``new_gate``, the first such slot (0 if none), its distance (0 if
    none; inf and NaN read as 0) and every slot's distance (inf unseen).
    """
    N = mm2.shape[1]
    dx = mm2[0] - mean_r[1]
    dy = mm2[1] - mean_r[2]
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
            u.append(cov_rr[k, 0] * wl[0] + cov_rr[k, 1] * wl[1]
                     + cov_rr[k, 2] * wl[2]
                     + rm6[k * 2 + 0] * wl[3] + rm6[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm6[0 * 2 + p] * wl[0] + rm6[1 * 2 + p] * wl[1]
                     + rm6[2 * 2 + p] * wl[2]
                     + diag4[p * 2 + 0] * wl[3] + diag4[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                         + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]
    p00, p01, p10, p11 = psi[0][0], psi[0][1], psi[1][0], psi[1][1]
    det = p00 * p11 - p01 * p10

    z_hat1 = se2.normalize_angle(torch.atan2(dy, dx) - mean_r[0])
    dz0 = z[0] - sq
    dz1 = z[1] - z_hat1
    if wrap_innovation:
        dz1 = se2.normalize_angle(dz1)
    dist = (dz0 * (p11 * dz0 - p01 * dz1)
            + dz1 * (-p10 * dz0 + p00 * dz1)) / det
    dist = torch.where(seen, dist, torch.full_like(dist, float("inf")))

    lane = torch.arange(N, device=mm2.device)
    first = torch.where(dist < new_gate, lane, N).min()
    any_hit = first < N
    first = torch.where(any_hit, first, 0)
    d_first = torch.where(
        any_hit,
        torch.nan_to_num(dist.index_select(0, first.reshape(1))[0], nan=0.0,
                         posinf=0.0),
        torch.zeros_like(dz0[0]))
    return any_hit, first, d_first, dist


# ---------------------------------------------------------------------------
# The sequential tick: each measurement applied to the whole state in turn
# ---------------------------------------------------------------------------

def _rows(mask, x):
    """``mask`` (B,) shaped to broadcast against ``x`` (B, ...)."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _update_shard(config: EKFConfig, st: BlockedState, z, j, R, gate
                  ) -> BlockedState:
    """Kalman update of world b against slot ``j[b]`` where ``gate[b]``
    (the JAX ``_update_shard`` at map=1, and its caller's
    ``where(do_update, upd, pre)``): z (B, 2), j (B,) in [0, N).

    The grid's rank-2 subtraction is one pass over ``st.cov_mm`` IN
    PLACE, with the gain and ``Sigma H^T`` strips of an ungated world
    replaced by zeros (``x - 0`` is ``x``); every other field is new."""
    B, N = st.mean_m.shape[:2]
    bi = torch.arange(B, device=j.device)
    mj = st.mean_m[bi, j]                                      # (B, 2)
    H5, z_hat = _h5_coeffs(st.mean_r.T, mj.T)
    H5, z_hat = H5.permute(2, 0, 1), z_hat.T                   # (B,2,5), (B,2)

    # Sigma H^T, robot rows (B, 3, 2): [cov_rr | cov_rm[:, j]] H5^T
    rm_j = st.cov_rm[bi, :, j]                                 # (B, 3, 2)
    SHt_r = torch.cat([st.cov_rr, rm_j], dim=2) @ H5.transpose(1, 2)
    # Sigma H^T, map rows (B, N, 2, 2): [cov_mr | grid column j] H5^T
    cov_mr = st.cov_rm.permute(0, 2, 3, 1)                     # (B, N, 2, 3)
    mm_colj = st.cov_mm[bi, :, :, :, j].permute(0, 3, 1, 2)    # (B, N, 2, 2)
    cols5 = torch.cat([cov_mr, mm_colj], dim=-1)               # (B, N, 2, 5)
    SHt_m = torch.einsum("bnpk,bqk->bnpq", cols5, H5)

    SHt_j = SHt_m[bi, j]                                       # (B, 2, 2)
    psi = H5 @ torch.cat([SHt_r, SHt_j], dim=1) + R
    psi_inv = _inv2x2(psi)
    K_r = SHt_r @ psi_inv                                      # (B, 3, 2)
    K_m = torch.einsum("bnpq,bqr->bnpr", SHt_m, psi_inv)       # (B, N, 2, 2)

    dz = z - z_hat
    if config.wrap_innovation:
        dz = torch.stack([dz[:, 0], se2.normalize_angle(dz[:, 1])], dim=1)
    mean_r = st.mean_r + (K_r @ dz[:, :, None])[:, :, 0]
    mean_r = torch.cat([se2.normalize_angle(mean_r[:, :1]), mean_r[:, 1:]],
                       dim=1)
    mean_m = st.mean_m + torch.einsum("bnpq,bq->bnp", K_m, dz)
    cov_rr = st.cov_rr - K_r @ SHt_r.transpose(1, 2)
    cov_rm = st.cov_rm - torch.einsum("biq,bnpq->binp", K_r, SHt_m)
    # own-block diagonal cache: the same rank-2 subtraction
    diag4 = st.diag4 - torch.stack(
        [K_m[:, :, p, 0] * SHt_m[:, :, r, 0]
         + K_m[:, :, p, 1] * SHt_m[:, :, r, 1]
         for p in range(2) for r in range(2)], dim=1)
    if config.symmetrize:
        cov_rr = 0.5 * (cov_rr + cov_rr.transpose(1, 2))

    # plane (p, r) -= K_m[:, p, :] HS_m[:, r, :]^T, one batched pass
    zero = torch.zeros((), dtype=K_m.dtype, device=K_m.device)
    Kz = torch.where(_rows(gate, K_m), K_m, zero)
    Hz = torch.where(_rows(gate, SHt_m), SHt_m, zero)
    a = Kz.permute(0, 2, 1, 3)[:, :, None].expand(B, 2, 2, N, 2)
    b = Hz.permute(0, 2, 3, 1)[:, None].expand(B, 2, 2, 2, N)
    st.cov_mm.view(B * 4, N, N).baddbmm_(a.reshape(B * 4, N, 2),
                                         b.reshape(B * 4, 2, N), alpha=-1)

    sel = lambda new, old: torch.where(_rows(gate, new), new, old)
    return st._replace(mean_r=sel(mean_r, st.mean_r),
                       mean_m=sel(mean_m, st.mean_m),
                       cov_rr=sel(cov_rr, st.cov_rr),
                       cov_rm=sel(cov_rm, st.cov_rm),
                       diag4=sel(diag4, st.diag4))


def _init_landmark_shard(config: EKFConfig, st: BlockedState, z, j, R, gate
                         ) -> BlockedState:
    """Analytic first-observation init of slot ``j[b]`` in world b where
    ``gate[b]`` (the JAX ``_init_landmark_shard`` at map=1 with its
    caller's ``where(is_new, s_init, s)``, ``n_seen`` and ``seen``): the
    mean, the robot cross strip, then on the grid the row, the column and
    the own 2x2 block, in that order (the later write wins where they
    cross), and ``diag4``. The grid is written IN PLACE, its row and
    column only; an ungated world's are written back unchanged."""
    B, N = st.mean_m.shape[:2]
    bi = torch.arange(B, device=j.device)
    th, x, y = st.mean_r[:, 0], st.mean_r[:, 1], st.mean_r[:, 2]
    a = z[:, 1] + th
    r = z[:, 0]
    sa, ca = torch.sin(a), torch.cos(a)
    m = torch.stack([x + r * ca, y + r * sa], dim=1)           # (B, 2)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    Gx = torch.stack([torch.stack([-r * sa, one, zero], dim=1),
                      torch.stack([r * ca, zero, one], dim=1)], dim=1)
    Gz = torch.stack([torch.stack([ca, -r * sa], dim=1),
                      torch.stack([sa, r * ca], dim=1)], dim=1)

    def put(t, idx, new):
        t[idx] = torch.where(_rows(gate, new), new, t[idx])

    mean_m = st.mean_m.clone()
    put(mean_m, (bi, j), m)
    # cross strip to the robot: cov_rm[:, j] = (Gx Srr)^T
    cov_rm = st.cov_rm.clone()
    put(cov_rm, (bi, slice(None), j), (Gx @ st.cov_rr).transpose(1, 2))
    # cross to the landmarks, Gx Sigma_{r, m}, from the strip before the
    # write above: crossc[p, q, m] (B, 2, 2, N)
    crossc = torch.einsum("bpi,bimq->bpqm", Gx, st.cov_rm)
    grid = st.cov_mm
    put(grid, (bi, slice(None), slice(None), j), crossc)       # row j
    # column j, by symmetry comp (p, q) of the column is comp (q, p)
    put(grid, (bi, slice(None), slice(None), slice(None), j),
        crossc.transpose(1, 2))
    # own block Gx Srr Gx^T + Gz R Gz^T
    block = ((Gx @ st.cov_rr) @ Gx.transpose(1, 2)
             + (Gz @ R) @ Gz.transpose(1, 2))
    put(grid, (bi, slice(None), slice(None), j, j), block)
    diag4 = st.diag4.clone()
    put(diag4, (bi, slice(None), j), block.reshape(B, 4))
    seen = st.seen.clone()
    seen[bi, j] = seen[bi, j] | gate
    return st._replace(mean_m=mean_m, cov_rm=cov_rm, diag4=diag4,
                       n_seen=st.n_seen + gate.to(st.n_seen.dtype),
                       seen=seen)


def _associate_shard(config: EKFConfig, st: BlockedState, z, R):
    """Blockwise Mahalanobis association with first-hit resolution (the
    JAX ``_associate_shard`` at map=1): psi = H5 S5 H5^T + R per landmark
    from ``cov_rr``, the strip and the carried own-block diagonal
    ``diag4``. Returns ``(any_hit, first, d_first)``, each (B,): whether
    a seen slot scores below ``new_gate``, the first such slot (0 if
    none) and its distance (0 if none; inf and NaN read as 0)."""
    B, N = st.mean_m.shape[:2]
    mr = st.mean_r
    dx = st.mean_m[..., 0] - mr[:, 1:2]                        # (B, N)
    dy = st.mean_m[..., 1] - mr[:, 2:3]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)
    zeros = torch.zeros_like(dx)
    H5 = torch.stack([
        torch.stack([zeros, -dx / sq, -dy / sq, dx / sq, dy / sq], dim=-1),
        torch.stack([-torch.ones_like(dx), dy / d, -dx / d, -dy / d, dx / d],
                    dim=-1)], dim=-2)                          # (B, N, 2, 5)
    Srm = st.cov_rm.permute(0, 2, 1, 3)                        # (B, N, 3, 2)
    Smm = st.diag4.reshape(B, 2, 2, N).permute(0, 3, 1, 2)     # (B, N, 2, 2)
    top = torch.cat([st.cov_rr[:, None].expand(B, N, 3, 3), Srm], dim=3)
    bot = torch.cat([Srm.transpose(2, 3), Smm], dim=3)
    S5 = torch.cat([top, bot], dim=2)                          # (B, N, 5, 5)
    psi = torch.einsum("bnij,bnjk,bnlk->bnil", H5, S5, H5) + R
    z_hat = torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - mr[:, 0:1])], dim=-1)
    dz = z[:, None, :] - z_hat
    if config.wrap_innovation:
        dz = torch.stack([dz[..., 0], se2.normalize_angle(dz[..., 1])],
                         dim=-1)
    dist = torch.einsum("bni,bnij,bnj->bn", dz, _inv2x2(psi), dz)
    dist = torch.where(st.seen, dist, torch.full_like(dist, float("inf")))

    lane = torch.arange(N, device=dist.device)
    first = torch.where(dist < config.new_gate, lane, INT_MAX).amin(dim=1)
    any_hit = first < INT_MAX
    first = torch.where(any_hit, first, 0)
    bi = torch.arange(B, device=dist.device)
    d_first = torch.where(
        any_hit, torch.nan_to_num(dist[bi, first], nan=0.0, posinf=0.0),
        torch.zeros_like(dist[:, 0]))
    return any_hit, first, d_first


def make_sequential_step(config: EKFConfig, max_meas: int, device,
                         known: bool = True, decisions=None):
    """Build the sequential tick for B worlds, known or unknown
    association: the port of the JAX ``make_sharded_step`` (known) and
    ``make_sharded_unknown_step`` (unknown) at map=1.

    Returns ``step(state, twist (B, 3), zs (B, M, 2), valid (B, M),
    ids (B, M), Q, R) -> state`` (``known=True``; an id outside [0, N) is
    a full no-op) or ``step(state, twist, zs, valid, Q, R)``
    (``known=False``: match -> update, gray zone -> skip, all-far -> a new
    slot at ``n_seen``; a measurement that finds the map full stops the
    rest of the world's tick) on a :class:`BlockedState` on ``device``.
    Each measurement is applied to the whole state, grid included: M
    full-grid rank-2 passes a tick, no kernel. The grid is updated IN
    PLACE (the returned state shares ``state.cov_mm``'s storage).
    ``decisions`` (a list) receives each tick's ``(kind, slot)``, both
    (B, M) int32: 0 no op (invalid, skipped or stopped), 1 update, 2 init,
    and the slot, -1 for no op (the deferred scan's ``kindb`` and
    ``gb``)."""
    device = resolve(device)
    N = config.num_landmarks
    M = max_meas

    def step(state: BlockedState, twist, zs, valid, *rest) -> BlockedState:
        ids, Q, R = rest if known else (None, *rest)
        _check(state, zs, device, M)
        st = _predict_shard(config, state, twist, Q)
        if not st.cov_mm.is_contiguous():
            st = st._replace(cov_mm=st.cov_mm.contiguous())
        stopped = torch.zeros_like(st.seen[:, 0])
        kinds, slots = [], []
        for k in range(M):
            z, v = zs[:, k], valid[:, k]
            if known:
                g = ids[:, k].long()
                v = v & (g >= 0) & (g < N)
                g = g.clamp(0, N - 1)
                seen_g = st.seen.gather(1, g[:, None])[:, 0]
                is_new, do_update = v & ~seen_g, v & seen_g
            else:
                act = v & ~stopped
                any_hit, first, d_first = _associate_shard(config, st, z, R)
                no_seen = st.n_seen == 0
                want_new = act & (no_seen | ~any_hit)
                cap_full = st.n_seen >= N
                do_update = (act & ~no_seen & any_hit
                             & (d_first < config.match_gate))
                is_new = want_new & ~cap_full
                stopped = stopped | (want_new & cap_full)
                g = torch.where(do_update, first,
                                torch.clamp_max(st.n_seen, N - 1).long())
            st = _init_landmark_shard(config, st, z, g, R, is_new)
            st = _update_shard(config, st, z, g, R, do_update)
            if decisions is not None:
                kind = torch.where(do_update, 1, torch.where(is_new, 2, 0))
                kinds.append(kind.to(torch.int32))
                slots.append(torch.where(kind > 0, g, -1).to(torch.int32))
        if decisions is not None:
            decisions.append((torch.stack(kinds, 1), torch.stack(slots, 1)))
        return st

    return step


# ---------------------------------------------------------------------------
# The deferred tick: one grid pass a tick
# ---------------------------------------------------------------------------

def grid_operands(Kb, HSb, CRb, gb, kb):
    """The grid pass's operands from the scan's op buffers (map=1), for
    one world or with a leading world axis B on every argument and result.

    ``rowT[n]`` is the index of the tick's last init of slot n (-1 = none);
    with one shard the column table ``colT`` is the same vector. Only
    updates after a slot's last init are subtracted on its row (``Kmask``)
    and column (``HSmask``). Returns ``(A, Bm, crow, ccol, rowT, colT)``
    with A (2, N, 2M), Bm (2, 2M, N), crow (2, 2, M, N), ccol (2, 2, N, M).
    """
    if Kb.dim() == 3:
        return tuple(x[0] for x in grid_operands(
            Kb[None], HSb[None], CRb[None], gb[None], kb[None]))
    B, M, _, N = Kb.shape
    dev = Kb.device
    iota = torch.arange(M, dtype=torch.int32, device=dev)
    gcol = torch.arange(N, dtype=torch.int32, device=dev)
    hits = (kb == 2)[:, :, None] & (gb[:, :, None] == gcol)
    rowT = torch.where(hits, iota[:, None], -1).amax(dim=1).to(torch.int32)
    colT = rowT
    later = (iota[:, None] > rowT[:, None, :])[:, :, None, :]  # (B, M, 1, N)
    Kmask = Kb * later.to(Kb.dtype)
    HSmask = HSb * later.to(HSb.dtype)
    # comp buffers [i, p*2+c, n] reshape to
    #   A[p][n, 2i+c] = Kmask[i, p*2+c, n]     B[r][2i+c, m] = HSmask[i, r*2+c, m]
    #   crow[p, r, i, m] = CRb[i, p*2+r, m]    ccol[p, r, n, i] = CRb[i, r*2+p, n]
    A = Kmask.reshape(B, M, 2, 2, N).permute(0, 2, 4, 1, 3
                                             ).reshape(B, 2, N, 2 * M)
    Bm = HSmask.reshape(B, M, 2, 2, N).permute(0, 2, 1, 3, 4
                                               ).reshape(B, 2, 2 * M, N)
    cr = CRb.reshape(B, M, 2, 2, N)
    crow = cr.permute(0, 2, 3, 1, 4).contiguous()
    ccol = cr.permute(0, 3, 2, 4, 1).contiguous()
    return A.contiguous(), Bm.contiguous(), crow, ccol, rowT, colT


def _check(state: BlockedState, zs, device, M):
    if resolve(state.cov_mm.device) != device:
        raise ValueError(f"state on {state.cov_mm.device}, step built "
                         f"for {device}")
    B = state.mean_r.shape[0]
    if tuple(zs.shape) != (B, M, 2):
        raise ValueError(f"zs must be ({B}, {M}, 2) for a state of {B} "
                         f"worlds, got {tuple(zs.shape)}")


def make_deferred_step(config: EKFConfig, max_meas: int, device,
                       known: bool = True,
                       seq_kernel: bool | None = None,
                       grid_kernel: bool | None = None, gate_margins=None,
                       decisions=None):
    """Build the deferred tick for B worlds, known or unknown association
    (the JAX ``make_sharded_deferred_step`` /
    ``make_sharded_deferred_unknown_step`` at map=1).

    Returns ``step(state, twist (B, 3), zs (B, M, 2), valid (B, M),
    ids (B, M), Q, R) -> state`` (``known=True``) or ``step(state, twist,
    zs, valid, Q, R)`` (``known=False``: the reference's first-hit gates,
    ``config.match_gate`` / ``new_gate``; slots fill in order; a
    measurement that finds the map full stops the rest of the world's
    tick) on a :class:`BlockedState` of B worlds on ``device``; the same
    semantics as :func:`make_sequential_step`. Kernels 2 (the scan) and 1
    (the grid pass) are launched once a tick for all B worlds.
    ``seq_kernel`` / ``grid_kernel`` route them as in ``ops/kernels``:
    ``None`` runs the CUDA kernel on the card and the plain version on the
    CPU; ``False`` forces the plain version; ``True`` demands the kernel.
    ``gate_margins`` (a list; unknown association on the plain scan)
    collects each measurement's smallest relative margin to a gate
    (``seq_scan.reference_seq_scan``; (B,) a measurement). ``decisions``
    (a list) receives each tick's ``(kind, slot)`` as in
    :func:`make_sequential_step`.

    The grid pass updates ``state.cov_mm``'s storage IN PLACE (the JAX
    version donates the buffer instead); the returned state shares it.
    """
    from ..ops.kernels.grid_update import fused_grid_update
    from ..ops.kernels.seq_scan import deferred_seq_scan

    device = resolve(device)
    N = config.num_landmarks
    M = max_meas

    def step(state: BlockedState, twist, zs, valid, *rest) -> BlockedState:
        ids, Q, R = rest if known else (None, *rest)
        _check(state, zs, device, M)
        B = state.mean_r.shape[0]
        st = _predict_shard(config, state, twist, Q)
        cov_mm0 = st.cov_mm                               # (B, 2, 2, N, N)
        (mr_o, mm2_o, crr_o, rm6_o, diag_o, seen_o, ns_o,
         Kb, HSb, CRb, gb, kb) = deferred_seq_scan(
            st.mean_r, st.mean_m.transpose(1, 2).contiguous(), st.cov_rr,
            st.cov_rm.permute(0, 1, 3, 2).reshape(B, 6, N), st.diag4,
            st.seen, st.n_seen, cov_mm0.reshape(B, 4, N, N), zs, valid,
            ids, R, known=known, match_gate=config.match_gate,
            new_gate=config.new_gate,
            wrap_innovation=config.wrap_innovation,
            symmetrize=config.symmetrize, use_kernel=seq_kernel,
            gate_margins=gate_margins)
        if decisions is not None:
            decisions.append((kb, gb))
        A, Bm, crow, ccol, rowT, colT = grid_operands(Kb, HSb, CRb, gb, kb)
        cov = fused_grid_update(cov_mm0, A, Bm, crow, ccol, rowT, colT,
                                use_kernel=grid_kernel)
        return BlockedState(
            mean_r=mr_o,
            mean_m=mm2_o.transpose(1, 2).contiguous(),
            cov_rr=crr_o,
            cov_rm=rm6_o.reshape(B, 3, 2, N).permute(0, 1, 3, 2)
            .contiguous(),
            cov_mm=cov,
            diag4=diag_o,
            n_seen=ns_o,
            seen=seen_o)

    return step
