"""Batch-trailing dense EKF-SLAM: the explicitly batched engine (port of
``shermbot_navigation_tpu.models.ekf_batch``).

Same math and semantics as ``models.ekf_slam`` (the reference
``ExtendedKalman``, nuslam/src/slam_library.cpp:65-282 + the slam node's
measurement loop, slam.cpp:279-318), with the batch dimension TRAILING on
every tensor::

    mean (D, B)   cov (D, D, B)   n_seen (B,)   seen (N, B)

The JAX package chose this layout for the TPU's lane axis. It is kept
here: with one element per world, the trailing batch is also the coalesced
layout on a GPU, and per-world predicates (``(B,)`` masks) broadcast
against every tensor without a reshape. The implementation is the JAX
package's broadcast-arithmetic decomposition (no matmuls on the covariance
path, mask arithmetic for the slot reads and writes), op for op; the
``lax.scan`` over a tick's measurements is a Python loop. Gating stays a
select (``torch.where``), never a multiplication: a gated-off world that
holds a non-finite intermediate stays finite.

Every function returns new tensors; inputs are not modified.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from ..ops import se2
from .ekf_slam import (ASSOC_MATCH, ASSOC_NEW, ASSOC_OVERFLOW, ASSOC_SKIP,
                       EKFConfig, EKFState, _motion_delta)


class BatchState(NamedTuple):
    """Batch-trailing filter state (D = 3 + 2N)."""

    mean: torch.Tensor    # (D, B)
    cov: torch.Tensor     # (D, D, B)
    n_seen: torch.Tensor  # (B,) int32
    seen: torch.Tensor    # (N, B) bool


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def init(config: EKFConfig, batch: int, robot_pose=None,
         dtype=torch.float32, device=None) -> BatchState:
    """Initial state of ``batch`` worlds; ``device=None`` is the card."""
    device = resolve(device)
    D = config.dim
    N = config.num_landmarks
    mean = torch.zeros((D, batch), dtype=dtype, device=device)
    if robot_pose is not None:
        mean[:3] = torch.as_tensor(robot_pose, dtype=dtype,
                                   device=device)[:, None]
    diag = torch.zeros(D, dtype=dtype, device=device)
    diag[3:3 + 2 * N] = config.init_cov
    cov = torch.diag(diag)[:, :, None].expand(D, D, batch).contiguous()
    return BatchState(mean=mean, cov=cov,
                      n_seen=torch.zeros(batch, dtype=torch.int32,
                                         device=device),
                      seen=torch.zeros((N, batch), dtype=torch.bool,
                                       device=device))


def from_vmapped(st: EKFState) -> BatchState:
    """Re-layout a leading-batch EKFState tree into batch-trailing (tests
    and migration; one transpose each way)."""
    return BatchState(mean=st.mean.T.contiguous(),
                      cov=st.cov.permute(1, 2, 0).contiguous(),
                      n_seen=st.n_seen, seen=st.seen.T.contiguous())


def to_vmapped(st: BatchState) -> EKFState:
    return EKFState(mean=st.mean.T.contiguous(),
                    cov=st.cov.permute(2, 0, 1).contiguous(),
                    n_seen=st.n_seen, seen=st.seen.T.contiguous())


# ---------------------------------------------------------------------------
# Predict (rank-2 strip, ekf_slam.predict transcribed)
# ---------------------------------------------------------------------------

def predict(config: EKFConfig, st: BatchState, twist, Q) -> BatchState:
    """``twist`` is (B, 3) (the natural batch-first producer layout)."""
    theta = st.mean[0]                                  # (B,)
    dq, b = _motion_delta(theta, _like(twist, st.mean))
    bT = b.T                                            # (2, B)
    mean = st.mean.clone()
    mean[:3] += dq.T

    cov = st.cov.clone()
    r0 = st.cov[0]                                      # (D, B) original
    s00 = st.cov[0, 0]                                  # (B,)
    strip = bT[:, None, :] * r0[None, :, :]             # (2, D, B)
    cov[1:3, :, :] += strip
    cov[:, 1:3, :] += strip.permute(1, 0, 2)
    cov[1:3, 1:3, :] += s00 * bT[:, None, :] * bT[None, :, :]
    cov[:3, :3, :] += _like(Q, cov)[:, :, None]
    return st._replace(mean=mean, cov=cov)


# ---------------------------------------------------------------------------
# Measurement geometry
# ---------------------------------------------------------------------------

def _slot_masks(D, j, dtype):
    """(D, B) 0/1 masks for state entries ``3+2j`` and ``4+2j``."""
    lane = torch.arange(D, device=j.device)[:, None]
    idx = (3 + 2 * j)[None, :]
    return ((lane == idx).to(dtype), (lane == idx + 1).to(dtype))


def _landmark_delta(mean, j):
    dt = mean.dtype
    m0, m1 = _slot_masks(mean.shape[0], j, dt)
    mx = torch.sum(mean * m0, dim=0)                    # (B,)
    my = torch.sum(mean * m1, dim=0)
    dx = mx - mean[1]
    dy = my - mean[2]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    return dx, dy, d, torch.sqrt(d), m0, m1


def _h5_rows(dx, dy, d, sq):
    """The 9 nonzeros of H as two rows of five (B,)- or (N, B)-shaped
    coefficients on the basis ``[theta, x, y, mx, my]``."""
    a_ = dx / sq
    b_ = dy / sq
    c_ = dy / d
    e_ = -dx / d
    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    return ((zero, -a_, -b_, a_, b_), (-one, c_, e_, -c_, -e_))


def _floor_det(det):
    return torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                       det)


# ---------------------------------------------------------------------------
# Update (rank-2, broadcast-arithmetic -- ekf_slam.update transcribed)
# ---------------------------------------------------------------------------

def update(config: EKFConfig, st: BatchState, z, j, R) -> BatchState:
    """``z`` (B, 2), ``j`` (B,) int32."""
    mean, cov = st.mean, st.cov
    z = _like(z, mean)
    R = _like(R, mean)

    dx, dy, d, sq, m0, m1 = _landmark_delta(mean, j)
    w = _h5_rows(dx, dy, d, sq)

    # Sigma H^T columns: 3 robot cols are plain slices; the landmark pair
    # via one mask-reduce pass over cov
    cols_r = cov[:, :3, :]                              # (D, 3, B)
    cm0 = torch.sum(cov * m0[None, :, :], dim=1)        # (D, B)
    cm1 = torch.sum(cov * m1[None, :, :], dim=1)
    SHt = []
    for q in range(2):
        wq = w[q]
        SHt.append(cols_r[:, 0] * wq[0][None, :]
                   + cols_r[:, 1] * wq[1][None, :]
                   + cols_r[:, 2] * wq[2][None, :]
                   + cm0 * wq[3][None, :] + cm1 * wq[4][None, :])  # (D, B)

    # psi = H (Sigma H^T) + R from the same 5 rows of SHt
    psi = [[None, None], [None, None]]
    for q in range(2):
        r5 = [SHt[q][0], SHt[q][1], SHt[q][2],
              torch.sum(SHt[q] * m0, dim=0), torch.sum(SHt[q] * m1, dim=0)]
        for p in range(2):
            wp = w[p]
            psi[p][q] = (wp[0] * r5[0] + wp[1] * r5[1] + wp[2] * r5[2]
                         + wp[3] * r5[3] + wp[4] * r5[4]) + R[p, q]

    z_hat0 = sq
    z_hat1 = se2.normalize_angle(torch.atan2(dy, dx) - mean[0])
    dz0 = z[:, 0] - z_hat0
    dz1 = z[:, 1] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = _floor_det(psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0])
    i00 = psi[1][1] / det
    i01 = -psi[0][1] / det
    i10 = -psi[1][0] / det
    i11 = psi[0][0] / det
    K0 = SHt[0] * i00[None, :] + SHt[1] * i10[None, :]  # (D, B)
    K1 = SHt[0] * i01[None, :] + SHt[1] * i11[None, :]
    mean = mean + K0 * dz0[None, :] + K1 * dz1[None, :]

    mean = torch.cat([se2.normalize_angle(mean[:1]), mean[1:]])
    if config.symmetrize:
        # symmetrized downdate: 0.5 (cov' + cov'^T) with
        # cov' = cov - K (SHt)^T equals cov - 0.5 (K x S + S x K) whenever
        # the incoming cov is symmetric (every op in this engine writes
        # symmetric terms); this form never transposes the big tensor
        cov = cov - 0.5 * (K0[:, None, :] * SHt[0][None, :, :]
                           + SHt[0][:, None, :] * K0[None, :, :]
                           + K1[:, None, :] * SHt[1][None, :, :]
                           + SHt[1][:, None, :] * K1[None, :, :])
    else:
        cov = cov - (K0[:, None, :] * SHt[0][None, :, :]
                     + K1[:, None, :] * SHt[1][None, :, :])
    return st._replace(mean=mean, cov=cov)


# ---------------------------------------------------------------------------
# Landmark initialization (mask arithmetic -- ekf_slam transcribed)
# ---------------------------------------------------------------------------

def init_landmark(config: EKFConfig, st: BatchState, z, j) -> BatchState:
    mean = st.mean
    dt = mean.dtype
    z = _like(z, mean)
    ang = z[:, 1] + mean[0]                             # (B,)
    gx = mean[1] + z[:, 0] * torch.cos(ang)
    gy = mean[2] + z[:, 0] * torch.sin(ang)
    m0, m1 = _slot_masks(mean.shape[0], j, dt)
    mean = (mean * (1.0 - m0) * (1.0 - m1)
            + m0 * gx[None, :] + m1 * gy[None, :])
    return st._replace(mean=mean)


def _init_cov_comps(mean, cov, z, R):
    """First-observation covariance ingredients: ``cross`` (two (D, B)
    rows) and the 2x2 ``block`` components -- they depend only on theta, z,
    R and the CURRENT cov (not on the init'd mean slot)."""
    z = _like(z, mean)
    R = _like(R, mean)
    a = z[:, 1] + mean[0]
    r = z[:, 0]
    sa, ca = torch.sin(a), torch.cos(a)
    one = torch.ones_like(r)
    zero = torch.zeros_like(r)
    # Gx rows as component (B,) triples
    Gx = ((-r * sa, one, zero), (r * ca, zero, one))
    # cross[k] = Gx[k] . cov[:3]  -> (D, B)
    c3 = cov[:3]                                        # (3, D, B)
    cross = [Gx[k][0][None, :] * c3[0] + Gx[k][1][None, :] * c3[1]
             + Gx[k][2][None, :] * c3[2] for k in range(2)]
    # block = Gx crr Gx^T + Gz R Gz^T, components (B,)
    crr = cov[:3, :3]                                   # (3, 3, B)
    u = [[crr[i, 0] * Gx[k][0] + crr[i, 1] * Gx[k][1] + crr[i, 2] * Gx[k][2]
          for i in range(3)] for k in range(2)]         # u[k][i] (B,)
    gxc = [[Gx[p][0] * u[k][0] + Gx[p][1] * u[k][1] + Gx[p][2] * u[k][2]
            for k in range(2)] for p in range(2)]
    Gz = ((ca, -r * sa), (sa, r * ca))
    gzr = [[Gz[p][0] * (R[0, 0] * Gz[q][0] + R[0, 1] * Gz[q][1])
            + Gz[p][1] * (R[1, 0] * Gz[q][0] + R[1, 1] * Gz[q][1])
            for q in range(2)] for p in range(2)]
    block = [[gxc[p][q] + gzr[p][q] for q in range(2)] for p in range(2)]
    return cross, block


def _analytic_init_cov(st: BatchState, z, j, R) -> torch.Tensor:
    """First-observation covariance blocks, batch-trailing mask arithmetic
    (the exact infinite-prior limit; see ekf_slam._analytic_init_cov)."""
    mean, cov = st.mean, st.cov
    dt = mean.dtype
    cross, block = _init_cov_comps(mean, cov, z, R)

    m0, m1 = _slot_masks(cov.shape[0], j, dt)
    inrow = (m0 + m1)[:, None, :]                       # (D, 1, B)
    incol = (m0 + m1)[None, :, :]                       # (1, D, B)
    rowv = (m0[:, None, :] * cross[0][None, :, :]
            + m1[:, None, :] * cross[1][None, :, :])
    colv = (cross[0][:, None, :] * m0[None, :, :]
            + cross[1][:, None, :] * m1[None, :, :])
    blockv = (m0[:, None, :] * m0[None, :, :] * block[0][0]
              + m0[:, None, :] * m1[None, :, :] * block[0][1]
              + m1[:, None, :] * m0[None, :, :] * block[1][0]
              + m1[:, None, :] * m1[None, :, :] * block[1][1])
    return (cov * (1.0 - inrow) * (1.0 - incol)
            + rowv * (1.0 - incol)
            + colv * (1.0 - inrow)
            + blockv)


# ---------------------------------------------------------------------------
# Association (componentized w-chain -- ekf_slam.associate transcribed)
# ---------------------------------------------------------------------------

class BatchAssoc(NamedTuple):
    outcome: torch.Tensor    # (B,) int32
    index: torch.Tensor      # (B,) int32
    distances: torch.Tensor  # (N, B)


def associate(config: EKFConfig, st: BatchState, z, R) -> BatchAssoc:
    """Mahalanobis association of ``z (B, 2)`` in every world (first_hit
    or nearest; see ``ekf_slam.associate``)."""
    N = config.num_landmarks
    mean, cov = st.mean, st.cov
    z = _like(z, mean)
    R = _like(R, mean)
    B = mean.shape[1]

    m = mean[3:3 + 2 * N].reshape(N, 2, B)              # (N, 2, B)
    dx = m[:, 0] - mean[1][None, :]                     # (N, B)
    dy = m[:, 1] - mean[2][None, :]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)

    crr = cov[:3, :3]                                   # (3, 3, B)
    Srm = cov[:3, 3:3 + 2 * N].reshape(3, N, 2, B)      # (3, N, 2, B)
    rows = cov[3:3 + 2 * N, 3:3 + 2 * N].reshape(N, 2, N, 2, B)
    # each landmark's own 2x2 block: Smm[p, q, b, n] = rows[n, p, n, q, b]
    Smm = torch.diagonal(rows, dim1=0, dim2=2)
    w = _h5_rows(dx, dy, d, sq)
    rm = [Srm[i, :, p] for i in range(3) for p in range(2)]   # (N, B)
    dg = [Smm[p, q].T for p in range(2) for q in range(2)]    # (N, B)
    psi_c = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(crr[k, 0][None, :] * wl[0] + crr[k, 1][None, :] * wl[1]
                     + crr[k, 2][None, :] * wl[2]
                     + rm[k * 2 + 0] * wl[3] + rm[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm[0 + p] * wl[0] + rm[2 + p] * wl[1]
                     + rm[4 + p] * wl[2]
                     + dg[p * 2 + 0] * wl[3] + dg[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi_c[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                           + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]

    z_hat1 = se2.normalize_angle(torch.atan2(dy, dx) - mean[0][None, :])
    dz0 = z[:, 0][None, :] - sq                         # (N, B)
    dz1 = z[:, 1][None, :] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = _floor_det(psi_c[0][0] * psi_c[1][1] - psi_c[0][1] * psi_c[1][0])
    dist = (dz0 * (psi_c[1][1] * dz0 - psi_c[0][1] * dz1)
            + dz1 * (-psi_c[1][0] * dz0 + psi_c[0][0] * dz1)) / det
    inf = torch.full_like(dist, float("inf"))
    dist = torch.where(st.seen, dist, inf)              # (N, B)

    if config.assoc_mode == "nearest":
        d_first, first = torch.min(dist, dim=0)
        any_hit = d_first < config.new_gate
        first_match = d_first < config.match_gate
    else:
        lt_new = dist < config.new_gate
        any_hit = lt_new.any(dim=0)
        lane = torch.arange(N, device=mean.device)[:, None]
        first = torch.where(lt_new, lane, N).min(dim=0).values
        first = torch.where(any_hit, first, 0)       # JAX argmax: 0 if none
        finite = torch.where(torch.isfinite(dist), dist,
                             torch.zeros_like(dist))
        d_first = torch.gather(finite, 0, first[None, :])[0]
        first_match = any_hit & (d_first < config.match_gate)

    no_seen = st.n_seen == 0
    capacity_full = st.n_seen >= N
    full_or_new = torch.where(capacity_full, ASSOC_OVERFLOW, ASSOC_NEW)
    outcome = torch.where(
        no_seen, full_or_new,
        torch.where(any_hit,
                    torch.where(first_match, ASSOC_MATCH, ASSOC_SKIP),
                    full_or_new)).to(torch.int32)
    index = torch.where(outcome == ASSOC_MATCH, first,
                        torch.clamp_max(st.n_seen, N - 1)).to(torch.int32)
    return BatchAssoc(outcome=outcome, index=index, distances=dist)


# ---------------------------------------------------------------------------
# Tick drivers (control flow of ekf_slam.step_measurement / step /
# known_association_step, with (B,) predicates)
# ---------------------------------------------------------------------------

def _where_state(pred, a: BatchState, b: BatchState) -> BatchState:
    """Per-world select; (B,) pred broadcasts against trailing batch."""
    return BatchState(
        mean=torch.where(pred, a.mean, b.mean),
        cov=torch.where(pred, a.cov, b.cov),
        n_seen=torch.where(pred, a.n_seen, b.n_seen),
        seen=torch.where(pred, a.seen, b.seen),
    )


def _slot_hit(N, j):
    """(N, B) bool: slot n is world b's slot ``j[b]``."""
    return torch.arange(N, device=j.device)[:, None] == j[None, :]


def step_measurement(config: EKFConfig, st: BatchState, z, valid, stopped,
                     R, margins: list | None = None):
    """``z`` (B, 2), ``valid``/``stopped`` (B,) bool. ``margins`` (a list,
    diagnostics) receives each world's smallest relative distance of a
    score to a gate over its seen slots, a (B,) tensor (inf where the
    measurement does not act or no slot is seen)."""
    res = associate(config, st, z, R)
    act = valid & ~stopped
    if margins is not None:
        dist = res.distances
        rel = torch.minimum(
            torch.abs(dist - config.match_gate) / config.match_gate,
            torch.abs(dist - config.new_gate) / config.new_gate)
        margins.append(torch.where(st.seen & act[None, :], rel,
                                   torch.full_like(rel, float("inf")))
                       .amin(0))

    is_new = act & (res.outcome == ASSOC_NEW)
    is_match = act & (res.outcome == ASSOC_MATCH)
    is_overflow = act & (res.outcome == ASSOC_OVERFLOW)
    do_update = is_match if config.analytic_init else (is_new | is_match)

    st_init = init_landmark(config, st, z, res.index)
    if config.analytic_init:
        st_init = st_init._replace(cov=_analytic_init_cov(st_init, z,
                                                          res.index, R))
    pre = _where_state(is_new, st_init, st)
    pre = pre._replace(
        n_seen=torch.where(is_new, st.n_seen + 1, st.n_seen),
        seen=st.seen | (is_new[None, :]
                        & _slot_hit(st.seen.shape[0], res.index)))

    upd = update(config, pre, z, res.index, R)
    new_state = _where_state(do_update, upd, pre)
    return new_state, stopped | is_overflow


def step(config: EKFConfig, st: BatchState, twist, zs, z_valid, Q, R,
         margins: list | None = None) -> BatchState:
    """One SLAM tick, unknown association. ``twist`` (B, 3), ``zs``
    (B, M, 2), ``z_valid`` (B, M)."""
    st = predict(config, st, twist, Q)
    zs = _like(zs, st.mean)
    R = _like(R, st.mean)
    stopped = torch.zeros(st.mean.shape[1], dtype=torch.bool,
                          device=st.mean.device)
    for k in range(zs.shape[1]):
        st, stopped = step_measurement(config, st, zs[:, k], z_valid[:, k],
                                       stopped, R, margins)
    return st


def known_association_step(config: EKFConfig, st: BatchState, twist, zs,
                           z_valid, z_ids, Q, R) -> BatchState:
    """Known-association tick. ``z_ids`` (B, M) int32; same capacity
    semantics as the dense engine (at/beyond-capacity id = sticky stop,
    negative id = no-op)."""
    st = predict(config, st, twist, Q)
    zs = _like(zs, st.mean)
    R = _like(R, st.mean)
    N = config.num_landmarks
    stopped = torch.zeros(st.mean.shape[1], dtype=torch.bool,
                          device=st.mean.device)
    for k in range(zs.shape[1]):
        z, j = zs[:, k], z_ids[:, k]
        overflow = j >= N
        valid = z_valid[:, k] & ~stopped & ~overflow & (j >= 0)
        stopped = stopped | overflow
        j_safe = torch.clamp(j, 0, N - 1)
        hit = _slot_hit(N, j_safe)
        seen_j = (hit & st.seen).any(dim=0)
        is_new = valid & ~seen_j
        st_init = init_landmark(config, st, z, j_safe)
        if config.analytic_init:
            st_init = st_init._replace(
                cov=_analytic_init_cov(st_init, z, j_safe, R))
        st_init = st_init._replace(n_seen=st.n_seen + 1, seen=st.seen | hit)
        pre = _where_state(is_new, st_init, st)
        do_update = (valid & seen_j) if config.analytic_init else valid
        upd = update(config, pre, z, j_safe, R)
        st = _where_state(do_update, upd, pre)
    return st
