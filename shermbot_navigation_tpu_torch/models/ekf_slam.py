"""EKF-SLAM core: predict / associate / update over a padded landmark map
(port of ``shermbot_navigation_tpu.models.ekf_slam``).

State layout (the reference's, ``slam_library.cpp:39-63``)::

    zeta = [theta, x, y, m1x, m1y, ..., mNx, mNy]  in R^(3+2N)

with a fixed capacity N, an ``n_seen`` counter and a per-slot ``seen``
mask. The covariance algebra keeps the JAX package's sparse forms: the
predict is a rank-2 strip update (rows/cols 1:3), the Kalman update a
rank-2 downdate built from five columns of Sigma, and association scores
every slot from the robot strip and each landmark's own 2x2 block.

Differences from the JAX module, none of them semantic:

- Slot indices stay tensors and are read with ``index_select`` on the
  clamped slot (JAX clamps a dynamic slice the same way); a slot outside
  the map only ever feeds a branch that a ``torch.where`` then drops, so
  nothing goes back to the host inside a tick.
- The tick applies its two whole-state selects exactly but without whole
  (D, D) passes: the init select only touches the two rows, two columns
  and 2x2 block that the init writes, and the update select is the
  ``apply`` flag of :func:`update`, which the CUDA kernel of
  ``pallas_update='on'`` applies inside its one pass over Sigma.
- ``pallas_update='on'`` runs ``ops/kernels/cov_update`` (the CUDA kernel
  on the card, its plain version on the CPU); ``'auto'`` takes the plain
  rank-2 downdate, as the JAX package's demoted ``'auto'`` does.
- The engine is written for one world. ``pipeline/driver.run_scenario_batch``
  runs it over a leading batch with ``torch.func.vmap`` (the JAX driver's
  ``vmap``): every op here has a batching rule, so no op falls back to a
  loop over the worlds.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve
from ..ops import se2

# Association outcomes (see `associate`).
ASSOC_MATCH = 0      # matched an existing landmark
ASSOC_SKIP = 1       # "gray area" -- measurement ignored (ref slam_library.cpp:243-246)
ASSOC_NEW = 2        # new landmark created
ASSOC_OVERFLOW = 3   # capacity full -- caller stops the tick (ref slam.cpp:301-316)

INT_MAX = 2147483647.0  # ref initCov, slam_library.cpp:31


@dataclasses.dataclass(frozen=True)
class EKFConfig:
    """Static configuration; field for field the JAX ``EKFConfig``."""

    num_landmarks: int                 # capacity N (ref slam.cpp:71: 6)
    match_gate: float = 0.01           # ref slam_library.cpp:193
    new_gate: float = 60.0             # ref slam_library.cpp:194
    init_cov: float = INT_MAX          # unseen-landmark prior variance
    analytic_init: bool = True         # f32-safe first-observation init
    wrap_innovation: bool = False      # reference does not wrap (PARITY.md)
    symmetrize: bool = True            # re-symmetrize Sigma after updates
    assoc_mode: str = "first_hit"      # "first_hit" (reference) or "nearest"
    pad_state_to: int = 0              # dense state padded size (0 = 3+2N)
    pallas_update: str = "auto"        # "on": the fused update kernel

    @property
    def dim(self) -> int:
        D = 3 + 2 * self.num_landmarks
        if self.pad_state_to:
            if self.pad_state_to < D:
                raise ValueError(f"pad_state_to {self.pad_state_to} < {D}")
            return self.pad_state_to
        return D


class EKFState(NamedTuple):
    """Dense filter state: mean, covariance, per-slot landmark bookkeeping
    (``seen`` is a per-slot mask; see the JAX ``EKFState``)."""

    mean: torch.Tensor    # (D,)  [theta, x, y, m1x, m1y, ...]
    cov: torch.Tensor     # (D, D)
    n_seen: torch.Tensor  # () int32 -- number of initialized landmarks
    seen: torch.Tensor    # (N,) bool -- which slots are initialized


def init(config: EKFConfig, robot_pose, dtype=torch.float32,
         device=None) -> EKFState:
    """Initial dense state (ref ctor slam_library.cpp:39-63 + initCov):
    zero robot block, ``init_cov`` on the 2N logical landmark diagonal,
    zero on any padded tail. ``device=None`` is the card
    (``device.resolve``)."""
    device = resolve(device)
    D = config.dim
    mean = torch.zeros(D, dtype=dtype, device=device)
    mean[:3] = torch.as_tensor(robot_pose, dtype=dtype, device=device)
    diag = torch.zeros(D, dtype=dtype, device=device)
    diag[3:3 + 2 * config.num_landmarks] = config.init_cov
    return EKFState(mean=mean, cov=torch.diag(diag),
                    n_seen=torch.zeros((), dtype=torch.int32, device=device),
                    seen=torch.zeros(config.num_landmarks, dtype=torch.bool,
                                     device=device))


def cartesian2polar(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x, y) -> [range, bearing] (ref slam_library.cpp:16-22)."""
    r = torch.sqrt(x * x + y * y)
    phi = se2.normalize_angle(torch.atan2(y, x))
    return torch.stack([r, phi], dim=-1)


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------

def _motion_delta(theta: torch.Tensor, twist: torch.Tensor):
    """Arc motion increment ``dq = [dth, dx, dy]`` and the two nonzeros
    ``b = [B10, B20]`` of ``B = A - I`` (ref ``predictEstimate``,
    slam_library.cpp:71-94, and ``getA``, :127-148); the ``dth == 0``
    branch is the same branchless limit as the JAX version."""
    dth, dx = twist[..., 0], twist[..., 1]
    small = torch.abs(dth) < 1e-7
    safe = torch.where(small, torch.ones_like(dth), dth)
    ratio = dx / safe  # v / omega (arc radius)
    st, ct = torch.sin(theta), torch.cos(theta)
    st1, ct1 = torch.sin(theta + dth), torch.cos(theta + dth)
    dq_x = torch.where(small, dx * ct, -ratio * st + ratio * st1)
    dq_y = torch.where(small, dx * st, ratio * ct - ratio * ct1)
    b10 = torch.where(small, -dx * st, -ratio * ct + ratio * ct1)
    b20 = torch.where(small, dx * ct, -ratio * st + ratio * st1)
    dq = torch.stack([dth, dq_x, dq_y], dim=-1)
    b = torch.stack([b10, b20], dim=-1)
    return dq, b


def predict(config: EKFConfig, state: EKFState, twist, Q) -> EKFState:
    """Prediction step (ref ``predict``, slam_library.cpp:65-69): the arc
    motion model on the robot block (theta not normalized) and the exact
    rank-2 strip form of ``Sigma <- A Sigma A^T + Qbar``::

        Sigma' = Sigma + g r0^T + r0 g^T + Sigma00 g g^T + Qbar

    with ``r0`` the ORIGINAL row 0; only rows/cols 1:3 change. Returns new
    tensors (one copy of Sigma)."""
    mean, cov = state.mean, state.cov
    dq, b = _motion_delta(mean[0], _like(twist, mean))
    mean = mean.clone()
    mean[:3] += dq
    r0 = cov[0, :].clone()                  # (D,) original row 0
    s00 = r0[0]
    strip = b[:, None] * r0[None, :]        # (2, D)
    cov = cov.clone()
    cov[1:3, :] += strip
    cov[:, 1:3] += strip.T
    cov[1:3, 1:3] += s00 * (b[:, None] * b[None, :])
    cov[:3, :3] += _like(Q, cov)
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


def predict_dense(config: EKFConfig, state: EKFState, twist, Q) -> EKFState:
    """Literal dense ``A Sigma A^T + Qbar`` (O(D^3)) -- test oracle for
    :func:`predict`, mirroring ref ``propagateUncertainty`` exactly."""
    D = config.dim
    mean, cov = state.mean, state.cov
    dq, b = _motion_delta(mean[0], _like(twist, mean))
    mean = mean.clone()
    mean[:3] += dq
    A = torch.eye(D, dtype=cov.dtype, device=cov.device)
    A[1, 0] += b[0]
    A[2, 0] += b[1]
    Qbar = torch.zeros((D, D), dtype=cov.dtype, device=cov.device)
    Qbar[:3, :3] = _like(Q, cov)
    return EKFState(mean=mean, cov=A @ cov @ A.T + Qbar,
                    n_seen=state.n_seen, seen=state.seen)


# ---------------------------------------------------------------------------
# Measurement model
# ---------------------------------------------------------------------------

def _slot_index(D: int, j) -> torch.Tensor:
    """State lanes ``[3+2j, 4+2j]`` of slot ``j`` (a tensor), with the start
    clamped into ``[0, D-2]`` as a JAX dynamic slice clamps it. Every slot
    read and write goes through it; the JAX version's one-hot ``_slot_onehot``
    matvecs exist only to avoid TPU gathers under vmap."""
    start = torch.clamp(3 + 2 * j.long(), 0, D - 2)
    return start + torch.arange(2, device=j.device)


def _slot_cols(cov: torch.Tensor, j) -> torch.Tensor:
    """Sigma's (D, 2) column pair at slot ``j``. The JAX version switches
    from a masked reduce to a dynamic slice above ``_ONEHOT_MAX_D`` for TPU
    lowering reasons; both read the same exact columns for a slot inside
    the map, which is what ``index_select`` reads here."""
    return cov.index_select(1, _slot_index(cov.shape[-1], j))


def _landmark_delta(mean: torch.Tensor, j):
    """``(dx, dy, d, sqrt_d)`` from robot to landmark slot ``j`` (0-based),
    with safe denominators (slots may be uninitialized; results are masked
    out downstream). Ref slam_library.cpp:150-186 uses 1-based ``j``."""
    m = mean.index_select(0, _slot_index(mean.shape[0], j))
    dx = m[0] - mean[1]
    dy = m[1] - mean[2]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    return dx, dy, d, torch.sqrt(d)


def predicted_measurement(state: EKFState, j) -> torch.Tensor:
    """``z_hat`` for landmark slot ``j`` (ref
    ``computeTheoreticalMeasurement``, slam_library.cpp:150-160)."""
    j = torch.as_tensor(j, device=state.mean.device)
    dx, dy, _, sq = _landmark_delta(state.mean, j)
    return torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - state.mean[0])])


def _h5(dx, dy, d, sq) -> torch.Tensor:
    """The 2x5 compressed measurement Jacobian on the basis
    ``[theta, x, y, mx, my]`` (the 9 nonzeros of H,
    ref slam_library.cpp:174-183)."""
    z = torch.zeros_like(dx)
    row0 = torch.stack([z, -dx / sq, -dy / sq, dx / sq, dy / sq], dim=-1)
    row1 = torch.stack([-torch.ones_like(dx), dy / d, -dx / d, -dy / d,
                        dx / d], dim=-1)
    return torch.stack([row0, row1], dim=-2)  # (..., 2, 5)


def _inv2x2(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 2x2 inverse with a safe determinant (|det| < 1e-30 is
    replaced by 1e-30, as in the JAX version)."""
    a, b_, c, d_ = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    det = a * d_ - b_ * c
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    inv = torch.stack([torch.stack([d_, -b_], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return inv / det[..., None, None]


def _z_hat_dz(config: EKFConfig, mean, z, dx, dy, sq):
    z_hat = torch.stack(
        [sq, se2.normalize_angle(torch.atan2(dy, dx) - mean[0])])
    dz = z - z_hat
    if config.wrap_innovation:
        dz = torch.stack([dz[0], se2.normalize_angle(dz[1])])
    return dz


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

def _pallas_update_mode(config: EKFConfig, D: int, dtype):
    """Resolve the Kalman-update schedule: ``None`` (the plain rank-2
    downdate) or ``"fused"`` (``ops/kernels/cov_update``: the CUDA kernel
    for a state on the card, its plain version on the CPU).

    ``'on'`` needs f32 and ``D % 128 == 0`` and raises otherwise, as in
    JAX. ``'auto'`` is the plain downdate, following the JAX package, whose
    ``'auto'`` was demoted after a TPU A/B; whether the H100 should route
    it to the kernel is decided on the card's own numbers."""
    if config.pallas_update != "on":
        return None
    if not (D % 128 == 0 and dtype == torch.float32):
        raise ValueError(
            f"pallas_update='on' needs f32 and D % 128 == 0 (set "
            f"pad_state_to); got D={D}, {dtype}")
    return "fused"


def _sht_psi(state: EKFState, z, j, R):
    """Head of the update: ``(SHt (D, 2), psi (2, 2), dx, dy, sq)`` with
    ``Sigma H^T`` as the five-column combination of the JAX version."""
    mean, cov = state.mean, state.cov
    dx, dy, d, sq = _landmark_delta(mean, j)
    H5 = _h5(dx, dy, d, sq)                                        # (2, 5)
    cols_r = cov[:, :3]                                            # (D, 3)
    cols_m = _slot_cols(cov, j)                                    # (D, 2)
    SHt = torch.stack(
        [cols_r[:, 0] * H5[q, 0] + cols_r[:, 1] * H5[q, 1]
         + cols_r[:, 2] * H5[q, 2]
         + cols_m[:, 0] * H5[q, 3] + cols_m[:, 1] * H5[q, 4]
         for q in range(2)], dim=-1)                               # (D, 2)
    rows5 = torch.cat([SHt[:3], SHt.index_select(
        0, _slot_index(mean.shape[0], j))])                        # (5, 2)
    psi = torch.stack(
        [torch.stack([torch.sum(H5[q] * rows5[:, r]) for r in range(2)])
         for q in range(2)]) + R
    return SHt, psi, dx, dy, sq


def update(config: EKFConfig, state: EKFState, z, j, R,
           apply=None) -> EKFState:
    """Kalman update against landmark slot ``j`` (ref ``update``,
    slam_library.cpp:263-282) in the sparse form: ``Sigma H^T`` from five
    columns, ``K = Sigma H^T psi^-1`` with a closed-form 2x2 inverse, and
    the rank-2 downdate ``Sigma - K (Sigma H^T)^T`` -- through
    ``ops/kernels/cov_update`` when ``config.pallas_update == 'on'``.

    The innovation is raw ``z - z_hat`` (no wrap) unless
    ``config.wrap_innovation``; theta is re-normalized afterwards (ref
    slam_library.cpp:274).

    ``apply`` (optional bool tensor, the tick's update flag) makes the
    result exactly ``where(apply, update(state), state)`` field by field,
    applied as a select (inside the kernel on the fused route), never as a
    multiplication. Returns new tensors; ``state`` is not modified.
    """
    mean, cov = state.mean, state.cov
    z = _like(z, mean)
    R = _like(R, mean)
    j = torch.as_tensor(j, device=mean.device)
    SHt, psi, dx, dy, sq = _sht_psi(state, z, j, R)
    dz = _z_hat_dz(config, mean, z, dx, dy, sq)
    inv = _inv2x2(psi)

    if _pallas_update_mode(config, mean.shape[0], mean.dtype) is not None:
        from ..ops.kernels.cov_update import fused_kalman_update
        cov_u, mean_u = fused_kalman_update(cov, SHt, inv, dz, mean,
                                            apply=apply)
    else:
        # gain + rank-2 downdate as broadcasts, the JAX XLA schedule
        K0 = SHt[:, 0] * inv[0, 0] + SHt[:, 1] * inv[1, 0]         # (D,)
        K1 = SHt[:, 0] * inv[0, 1] + SHt[:, 1] * inv[1, 1]
        mean_u = mean + K0 * dz[0] + K1 * dz[1]
        cov_u = cov - (K0[:, None] * SHt[:, 0][None, :]
                       + K1[:, None] * SHt[:, 1][None, :])
        if apply is not None:
            mean_u = torch.where(apply, mean_u, mean)
            cov_u = torch.where(apply, cov_u, cov)

    th = se2.normalize_angle(mean_u[0])
    if apply is not None:
        th = torch.where(apply, th, mean[0])
    mean_u = torch.cat([th.reshape(1), mean_u[1:]])
    if config.symmetrize:
        sym = 0.5 * (cov_u + cov_u.T)
        cov_u = sym if apply is None else torch.where(apply, sym, cov_u)
    return EKFState(mean=mean_u, cov=cov_u, n_seen=state.n_seen,
                    seen=state.seen)


def innovation(config: EKFConfig, state: EKFState, z, j, R):
    """Pre-update innovation and its covariance ``(dz, psi)`` against
    landmark slot ``j`` -- the NIS ingredients (``metrics.nis``)."""
    mean = state.mean
    z = _like(z, mean)
    R = _like(R, mean)
    j = torch.as_tensor(j, device=mean.device)
    _, psi, dx, dy, sq = _sht_psi(state, z, j, R)
    return _z_hat_dz(config, mean, z, dx, dy, sq), psi


def update_dense(config: EKFConfig, state: EKFState, z, j, R) -> EKFState:
    """Literal dense update (test oracle), mirroring ref
    slam_library.cpp:263-282 with an explicitly assembled 2xD ``H``."""
    D = config.dim
    mean, cov = state.mean, state.cov
    z = _like(z, mean)
    R = _like(R, mean)
    j = torch.as_tensor(j, device=mean.device)
    dx, dy, d, sq = _landmark_delta(mean, j)
    H5 = _h5(dx, dy, d, sq)
    H = torch.zeros((2, D), dtype=mean.dtype, device=mean.device)
    H = H.index_copy(1, _slot_index(D, j), H5[:, 3:])
    H[:, :3] = H5[:, :3]
    K = cov @ H.T @ torch.linalg.inv(H @ cov @ H.T + R)
    dz = _z_hat_dz(config, mean, z, dx, dy, sq)
    mean = mean + K @ dz
    mean = torch.cat([se2.normalize_angle(mean[:1]), mean[1:]])
    cov = (torch.eye(D, dtype=mean.dtype, device=mean.device) - K @ H) @ cov
    return EKFState(mean=mean, cov=cov, n_seen=state.n_seen,
                    seen=state.seen)


# ---------------------------------------------------------------------------
# Landmark initialization
# ---------------------------------------------------------------------------

def init_landmark(config: EKFConfig, state: EKFState, z, j) -> EKFState:
    """Write landmark ``j``'s mean from a range-bearing measurement (ref
    ``initializeLandmark``, slam_library.cpp:255-261)::

        m = [x + r cos(phi + theta), y + r sin(phi + theta)]

    as a masked write over the (D,) row (nothing is written for a slot
    outside the state). The analytic covariance write is
    :func:`_analytic_init_cov`, applied by :func:`step_measurement`."""
    mean = state.mean
    z = _like(z, mean)
    j = torch.as_tensor(j, device=mean.device)
    ang = z[1] + mean[0]
    m = torch.stack([mean[1] + z[0] * torch.cos(ang),
                     mean[2] + z[0] * torch.sin(ang)])
    idx = 3 + 2 * j
    lane = torch.arange(mean.shape[0], device=mean.device)
    mean = torch.where(lane == idx, m[0],
                       torch.where(lane == idx + 1, m[1], mean))
    return EKFState(mean=mean, cov=state.cov, n_seen=state.n_seen,
                    seen=state.seen)


def _init_blocks(state: EKFState, z, R):
    """First-observation blocks (the JAX ``_analytic_init_cov`` algebra):
    the cross rows ``Gx Sigma[0:3, :]`` (2, D) and the own block
    ``Gx Sigma_rr Gx^T + Gz R Gz^T`` (2, 2), with ``a = phi + theta``::

        Gx = [[-r sin(a), 1, 0], [r cos(a), 0, 1]]
        Gz = [[cos(a), -r sin(a)], [sin(a), r cos(a)]]
    """
    mean, cov = state.mean, state.cov
    z = _like(z, mean)
    R = _like(R, mean)
    a = z[1] + mean[0]
    r = z[0]
    sa, ca = torch.sin(a), torch.cos(a)
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    Gx = torch.stack([torch.stack([-r * sa, one, zero]),
                      torch.stack([r * ca, zero, one])])
    Gz = torch.stack([torch.stack([ca, -r * sa]), torch.stack([sa, r * ca])])
    cross = Gx @ cov[:3, :]                                       # (2, D)
    block = (Gx @ cov[:3, :3]) @ Gx.T + (Gz @ R) @ Gz.T           # (2, 2)
    return cross, block


def _write_init(cov: torch.Tensor, j, cross, block, sel=None) -> None:
    """IN PLACE: rows, then columns, then the own 2x2 block of slot ``j``
    <- ``cross``, ``cross^T`` and ``block`` (the JAX slice writes, start
    clamped). With ``sel`` (bool tensor) each write is
    ``where(sel, new, old)``, so ``sel=False`` leaves ``cov`` bitwise as it
    was; only O(D) entries are read or written either way."""
    idx = _slot_index(cov.shape[0], j)
    pick = (lambda new, old: new) if sel is None else (
        lambda new, old: torch.where(sel, new, old))
    # index_put_, not index_copy_: it has a vmap batching rule, so the
    # batched dense engine writes every world's slot in one launch
    lane = torch.arange(cov.shape[0], device=cov.device)
    cov.index_put_((idx,), pick(cross, cov.index_select(0, idx)))
    cov.index_put_((lane[:, None], idx[None, :]),
                   pick(cross.T, cov.index_select(1, idx)))
    rc = (idx[:, None], idx[None, :])
    cov.index_put_(rc, pick(block, cov[rc]))


def _analytic_init_cov(state: EKFState, z, j, R) -> torch.Tensor:
    """First-observation covariance for landmark ``j`` (f32-safe path):
    cross ``Sigma_m,: = Gx Sigma[0:3, :]`` and diagonal block
    ``Sigma_mm = Gx Sigma_rr Gx^T + Gz R Gz^T``, the exact limit of the
    reference's infinite-prior update. Returns a new covariance."""
    cov = state.cov.clone()
    cross, block = _init_blocks(state, z, R)
    _write_init(cov, torch.as_tensor(j, device=cov.device), cross, block)
    return cov


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------

class AssocResult(NamedTuple):
    outcome: torch.Tensor    # () int32, one of ASSOC_*
    index: torch.Tensor      # () int32: matched slot, or the new slot for NEW
    distances: torch.Tensor  # (N,) Mahalanobis distances (inf for unseen)


def associate(config: EKFConfig, state: EKFState, z, R) -> AssocResult:
    """Mahalanobis data association with the reference's first-hit
    semantics (ref ``associateLandmark``, slam_library.cpp:188-253):

    1. No landmarks seen -> NEW at slot 0.
    2. Scan slots in order; the FIRST slot with distance < ``new_gate``
       decides: MATCH if < ``match_gate`` else SKIP.
    3. All distances >= ``new_gate`` -> NEW at slot ``n_seen`` (OVERFLOW
       if the capacity is full).

    ``assoc_mode='nearest'``: the minimum distance decides instead. All N
    distances at once from the robot strip and each landmark's own 2x2
    block, in the component form of the JAX version."""
    N = config.num_landmarks
    mean, cov = state.mean, state.cov
    z = _like(z, mean)
    R = _like(R, mean)

    m = mean[3:3 + 2 * N].reshape(N, 2)
    dx = m[:, 0] - mean[1]
    dy = m[:, 1] - mean[2]
    d = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    sq = torch.sqrt(d)

    crr = cov[:3, :3]
    Srm = cov[:3, 3:3 + 2 * N].reshape(3, N, 2)
    rows = cov[3:3 + 2 * N, 3:3 + 2 * N].reshape(N, 2, N, 2)
    Smm = torch.diagonal(rows, dim1=0, dim2=2)          # (2, 2, N) [p, q, n]
    a_ = dx / sq
    b_ = dy / sq
    c_ = dy / d
    e_ = -dx / d
    zero = torch.zeros_like(dx)
    one = torch.ones_like(dx)
    w = ((zero, -a_, -b_, a_, b_), (-one, c_, e_, -c_, -e_))
    rm = [Srm[i, :, p] for i in range(3) for p in range(2)]   # [i*2+p]
    dg = [Smm[p, q] for p in range(2) for q in range(2)]      # [p*2+q]
    psi_c = [[None, None], [None, None]]
    for l in range(2):
        wl = w[l]
        u = []
        for k in range(3):
            u.append(crr[k, 0] * wl[0] + crr[k, 1] * wl[1]
                     + crr[k, 2] * wl[2]
                     + rm[k * 2 + 0] * wl[3] + rm[k * 2 + 1] * wl[4])
        for p in range(2):
            u.append(rm[0 + p] * wl[0] + rm[2 + p] * wl[1]
                     + rm[4 + p] * wl[2]
                     + dg[p * 2 + 0] * wl[3] + dg[p * 2 + 1] * wl[4])
        for p in range(2):
            wp = w[p]
            psi_c[p][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2]
                           + wp[3] * u[3] + wp[4] * u[4]) + R[p, l]

    z_hat1 = se2.normalize_angle(torch.atan2(dy, dx) - mean[0])
    dz0 = z[0] - sq                              # (N,) raw, like the ref
    dz1 = z[1] - z_hat1
    if config.wrap_innovation:
        dz1 = se2.normalize_angle(dz1)

    det = psi_c[0][0] * psi_c[1][1] - psi_c[0][1] * psi_c[1][0]
    # the |det| floor of _inv2x2: a singular psi gives a huge finite
    # distance, not NaN (which would poison the nearest-mode min)
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    dist = (dz0 * (psi_c[1][1] * dz0 - psi_c[0][1] * dz1)
            + dz1 * (-psi_c[1][0] * dz0 + psi_c[0][0] * dz1)) / det
    dist = torch.where(state.seen, dist, torch.full_like(dist, float("inf")))

    lane = torch.arange(N, device=mean.device)
    if config.assoc_mode == "nearest":
        first = torch.argmin(dist)
        d_first = dist.min()
        any_hit = d_first < config.new_gate
        first_match = d_first < config.match_gate
    else:
        lt_new = dist < config.new_gate
        any_hit = lt_new.any()
        first = torch.where(lt_new, lane, N).min()
        first = torch.where(any_hit, first, 0)       # JAX argmax: 0 if none
        finite = torch.where(torch.isfinite(dist), dist,
                             torch.zeros_like(dist))
        d_first = finite.index_select(0, first.reshape(1))[0]
        first_match = any_hit & (d_first < config.match_gate)

    n_seen = state.n_seen
    no_seen = n_seen == 0
    capacity_full = n_seen >= N
    full_or_new = torch.where(capacity_full, ASSOC_OVERFLOW, ASSOC_NEW)
    outcome = torch.where(
        no_seen, full_or_new,
        torch.where(any_hit,
                    torch.where(first_match, ASSOC_MATCH, ASSOC_SKIP),
                    full_or_new)).to(torch.int32)
    index = torch.where(outcome == ASSOC_MATCH, first,
                        torch.clamp_max(n_seen, N - 1)).to(torch.int32)
    return AssocResult(outcome=outcome, index=index, distances=dist)


# ---------------------------------------------------------------------------
# The tick: sequential measurement processing
# ---------------------------------------------------------------------------

def _init_or_keep(config: EKFConfig, state: EKFState, z, j, R, is_new,
                  owned: bool) -> EKFState:
    """``where(is_new, init(state, j), state)`` with the bookkeeping, where
    init is :func:`init_landmark` plus (analytic init) the covariance
    blocks. The covariance select touches only what the init writes;
    ``owned`` lets it write into ``state.cov`` instead of a copy."""
    mean = torch.where(is_new, init_landmark(config, state, z, j).mean,
                       state.mean)
    cov = state.cov
    if config.analytic_init:
        cross, block = _init_blocks(state._replace(mean=mean), z, R)
        if not owned:
            cov = cov.clone()
        _write_init(cov, j, cross, block, is_new)
    N = config.num_landmarks
    hit = torch.arange(N, device=mean.device) == j
    return EKFState(mean=mean, cov=cov,
                    n_seen=torch.where(is_new, state.n_seen + 1,
                                       state.n_seen).to(torch.int32),
                    seen=state.seen | (is_new & hit))


def _step_measurement(config, state, z, valid, stopped, R, owned):
    res = associate(config, state, z, R)
    act = valid & ~stopped
    is_new = act & (res.outcome == ASSOC_NEW)
    is_match = act & (res.outcome == ASSOC_MATCH)
    is_overflow = act & (res.outcome == ASSOC_OVERFLOW)
    # analytic init already contains the measurement; without it
    # (reference mode) the update against the huge prior collapses it
    do_update = is_match if config.analytic_init else (is_new | is_match)
    pre = _init_or_keep(config, state, z, res.index, R, is_new, owned)
    return update(config, pre, z, res.index, R, apply=do_update), \
        stopped | is_overflow


def step_measurement(config: EKFConfig, state: EKFState, z, valid, stopped,
                     R):
    """Process one measurement with the reference node's control flow (ref
    slam.cpp:279-318): associate -> maybe initialize -> maybe update.
    ``valid`` masks padded slots; ``stopped`` is the sticky
    capacity-overflow flag (the reference ``break``s, slam.cpp:301-316).
    Returns ``(new_state, new_stopped)``; both selects are exact."""
    dev = state.mean.device
    return _step_measurement(
        config, state, _like(z, state.mean),
        torch.as_tensor(valid, dtype=torch.bool, device=dev),
        torch.as_tensor(stopped, dtype=torch.bool, device=dev),
        _like(R, state.mean), owned=False)


def step(config: EKFConfig, state: EKFState, twist, zs, z_valid, Q, R
         ) -> EKFState:
    """One SLAM tick (ref slam.cpp:231-365 ``main_loop`` body): predict,
    then the M measurements *sequentially* with unknown association.
    ``zs`` (M, 2) range-bearing; ``z_valid`` (M,) bool."""
    state = predict(config, state, twist, Q)
    dev = state.mean.device
    zs = _like(zs, state.mean)
    z_valid = torch.as_tensor(z_valid, dtype=torch.bool, device=dev)
    R = _like(R, state.mean)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(zs.shape[0]):
        # the tick owns every covariance after predict's copy
        state, stopped = _step_measurement(config, state, zs[k], z_valid[k],
                                           stopped, R, owned=True)
    return state


def known_association_step(config: EKFConfig, state: EKFState, twist, zs,
                           z_valid, z_ids, Q, R) -> EKFState:
    """Tick with *known* data association (``z_ids`` gives each
    measurement's slot; a first observation initializes it).

    Capacity: an id at or beyond N stops the tick -- no further
    measurement is processed, valid or not (ref slam.cpp:301-316
    ``break``; the sticky stop). A negative id is a plain no-op, as in the
    blocked engine."""
    state = predict(config, state, twist, Q)
    dev = state.mean.device
    N = config.num_landmarks
    zs = _like(zs, state.mean)
    z_valid = torch.as_tensor(z_valid, dtype=torch.bool, device=dev)
    z_ids = torch.as_tensor(z_ids, device=dev).long()
    R = _like(R, state.mean)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for k in range(zs.shape[0]):
        z, j = zs[k], z_ids[k]
        overflow = j >= N
        valid = z_valid[k] & ~stopped & ~overflow & (j >= 0)
        stopped = stopped | overflow
        seen = state.seen.index_select(0, j.clamp(0, N - 1).reshape(1))[0]
        is_new = valid & ~seen
        pre = _init_or_keep(config, state, z, j, R, is_new, owned=True)
        do_update = (valid & seen) if config.analytic_init else valid
        state = update(config, pre, z, j, R, apply=do_update)
    return state
