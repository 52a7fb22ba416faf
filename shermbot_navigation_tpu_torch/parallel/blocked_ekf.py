"""Blocked EKF-SLAM state and the deferred tick (port of
``shermbot_navigation_tpu.parallel.blocked_ekf`` at map=1, batch=1).

The covariance of the (3+2N)-dim SLAM state is kept as blocks:
``cov_rr`` (3, 3), the robot-landmark strip ``cov_rm`` (3, N, 2) and the
landmark grid ``cov_mm`` as four component planes (2, 2, N, N) with
``plane[p, q, n, m] = Sigma[(n, p), (m, q)]``, plus the own-block diagonal
cache ``diag4`` (PARITY D15). The layouts are the JAX package's, so the
tests compare like with like.

The deferred tick reads and writes the O(N^2) grid once per tick: predict
touches only strips; the M-measurement scan (``ops/kernels/seq_scan``)
works on O(N) strips and buffers each op; one fused pass
(``ops/kernels/grid_update``) then replays the buffered init overwrites
and subtracts the combined rank-2M term. Association is known (ids) or
unknown (first-hit Mahalanobis gates, :func:`_associate_comp`). With one
map shard the JAX version's ``pmin``/``psum``/``all_gather`` are
identities and are dropped here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig, _motion_delta
from ..ops import se2


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
    """Rank-2 strip predict on one robot's state (no batch dim): only
    ``mean_r``, ``cov_rr`` and rows 1:3 of the strip change."""
    theta = st.mean_r[0]
    dq, b = _motion_delta(theta, twist)
    mean_r = st.mean_r + dq

    r0_r = st.cov_rr[0, :]
    r0_m = st.cov_rm[0]                       # (N, 2)
    s00 = st.cov_rr[0, 0]

    cov_rr = st.cov_rr.clone()
    cov_rr[1:3, :] += b[:, None] * r0_r[None, :]
    cov_rr[:, 1:3] += r0_r[:, None] * b[None, :]
    cov_rr[1:3, 1:3] += s00 * b[:, None] * b[None, :]
    cov_rr = cov_rr + Q

    cov_rm = st.cov_rm.clone()
    cov_rm[1:3] += b[:, None, None] * r0_m[None, :, :]
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


class _SeqComp(NamedTuple):
    """The measurement scan's carried state in component layout (strips
    as (k, N) rows, landmark axis minor)."""

    mean_r: torch.Tensor   # (3,)
    mm2: torch.Tensor      # (2, N)  mean_m comps [p][n]
    cov_rr: torch.Tensor   # (3, 3)
    rm6: torch.Tensor      # (6, N)  cov_rm comps [i*2+p][n]
    n_seen: torch.Tensor   # () int32
    seen: torch.Tensor     # (N,) bool


def grid_operands(Kb, HSb, CRb, gb, kb):
    """The grid pass's operands from the scan's op buffers (map=1).

    ``rowT[n]`` is the index of the tick's last init of slot n (-1 = none);
    with one shard the column table ``colT`` is the same vector. Only
    updates after a slot's last init are subtracted on its row (``Kmask``)
    and column (``HSmask``). Returns ``(A, Bm, crow, ccol, rowT, colT)``
    with A (2, N, 2M), Bm (2, 2M, N), crow (2, 2, M, N), ccol (2, 2, N, M).
    """
    M, _, N = Kb.shape
    dev = Kb.device
    iota = torch.arange(M, dtype=torch.int32, device=dev)
    gcol = torch.arange(N, dtype=torch.int32, device=dev)
    hits = (kb == 2)[:, None] & (gb[:, None] == gcol[None, :])
    rowT = torch.where(hits, iota[:, None], -1).amax(dim=0).to(torch.int32)
    colT = rowT
    Kmask = Kb * (iota[:, None] > rowT[None, :])[:, None, :].to(Kb.dtype)
    HSmask = HSb * (iota[:, None] > colT[None, :])[:, None, :].to(HSb.dtype)
    # comp buffers [i, p*2+c, n] reshape to
    #   A[p][n, 2i+c] = Kmask[i, p*2+c, n]     B[r][2i+c, m] = HSmask[i, r*2+c, m]
    #   crow[p, r, i, m] = CRb[i, p*2+r, m]    ccol[p, r, n, i] = CRb[i, r*2+p, n]
    A = Kmask.reshape(M, 2, 2, N).permute(1, 3, 0, 2).reshape(2, N, 2 * M)
    Bm = HSmask.reshape(M, 2, 2, N).permute(1, 0, 2, 3).reshape(2, 2 * M, N)
    cr = CRb.reshape(M, 2, 2, N)
    crow = cr.permute(1, 2, 0, 3).contiguous()
    ccol = cr.permute(2, 1, 3, 0).contiguous()
    return A.contiguous(), Bm.contiguous(), crow, ccol, rowT, colT


def make_deferred_step(config: EKFConfig, max_meas: int, device,
                       known: bool = True,
                       seq_kernel: bool | None = None,
                       grid_kernel: bool | None = None, gate_margins=None):
    """Build the deferred tick for one robot, known or unknown association.

    Returns ``step(state, twist (1, 3), zs (1, M, 2), valid (1, M),
    ids (1, M), Q, R) -> state`` (``known=True``) or ``step(state, twist,
    zs, valid, Q, R)`` (``known=False``: the reference's first-hit gates,
    ``config.match_gate`` / ``new_gate``; slots fill in order; a
    measurement that finds the map full stops the rest of the tick) on a
    batch-1 :class:`BlockedState` that lives on ``device``.
    ``seq_kernel`` / ``grid_kernel`` route the two kernels as in
    ``ops/kernels``: ``None`` runs the CUDA kernel on the card and the
    plain version on the CPU; ``False`` forces the plain version; ``True``
    demands the kernel. ``gate_margins`` (a list; unknown association on
    the plain scan) collects each measurement's smallest relative margin
    to a gate (``seq_scan.reference_seq_scan``).

    The grid pass updates ``state.cov_mm``'s storage IN PLACE (the JAX
    version donates the buffer instead); the returned state shares it.
    """
    from ..ops.kernels.grid_update import fused_grid_update
    from ..ops.kernels.seq_scan import deferred_seq_scan

    device = torch.device(device)
    N = config.num_landmarks
    M = max_meas

    def step(state: BlockedState, twist, zs, valid, *rest) -> BlockedState:
        ids, Q, R = rest if known else (None, *rest)
        if state.mean_r.shape[0] != 1:
            raise ValueError(f"the deferred step runs batch 1, got batch "
                             f"{state.mean_r.shape[0]}")
        if state.cov_mm.device != device:
            raise ValueError(f"state on {state.cov_mm.device}, step built "
                             f"for {device}")
        if tuple(zs.shape) != (1, M, 2):
            raise ValueError(f"zs must be (1, {M}, 2), got {tuple(zs.shape)}")
        st1 = BlockedState(*(x[0] for x in state))
        st1 = _predict_shard(config, st1, twist[0], Q)
        cov_mm0 = st1.cov_mm                              # (2, 2, N, N)
        s0 = _SeqComp(mean_r=st1.mean_r,
                      mm2=st1.mean_m.T.contiguous(),
                      cov_rr=st1.cov_rr,
                      rm6=st1.cov_rm.permute(0, 2, 1).reshape(6, N),
                      n_seen=st1.n_seen,
                      seen=st1.seen)
        (mr_o, mm2_o, crr_o, rm6_o, diag_o, seen_o, ns_o,
         Kb, HSb, CRb, gb, kb) = deferred_seq_scan(
            s0.mean_r, s0.mm2, s0.cov_rr, s0.rm6, st1.diag4, s0.seen,
            s0.n_seen, cov_mm0.reshape(4, N, N), zs[0], valid[0],
            ids[0] if known else None, R, known=known,
            match_gate=config.match_gate, new_gate=config.new_gate,
            wrap_innovation=config.wrap_innovation,
            symmetrize=config.symmetrize, use_kernel=seq_kernel,
            gate_margins=gate_margins)
        s_out = _SeqComp(mean_r=mr_o, mm2=mm2_o, cov_rr=crr_o, rm6=rm6_o,
                         n_seen=ns_o, seen=seen_o)
        A, Bm, crow, ccol, rowT, colT = grid_operands(Kb, HSb, CRb, gb, kb)
        cov = fused_grid_update(cov_mm0, A, Bm, crow, ccol, rowT, colT,
                                use_kernel=grid_kernel)
        return BlockedState(
            mean_r=s_out.mean_r[None],
            mean_m=s_out.mm2.T[None].contiguous(),
            cov_rr=s_out.cov_rr[None],
            cov_rm=s_out.rm6.reshape(3, 2, N).permute(0, 2, 1)[None]
            .contiguous(),
            cov_mm=cov[None],
            diag4=diag_o[None],
            n_seen=s_out.n_seen.reshape(1),
            seen=s_out.seen[None])

    return step
