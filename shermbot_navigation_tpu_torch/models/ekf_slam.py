"""EKF-SLAM core pieces shared by the ported engines (port of
``shermbot_navigation_tpu.models.ekf_slam``).

Only what the deferred blocked serving tick uses is here: the static
config, the dense state (the serving migration's input), the arc motion
model and the closed-form 2x2 inverse. The dense ``predict`` / ``update``
engine arrives with its own slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops import se2

# Association outcomes (see the JAX ``associate``).
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
    pallas_update: str = "auto"        # dense-engine kernel routing

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
         device="cpu") -> EKFState:
    """Initial dense state (ref ctor slam_library.cpp:39-63 + initCov):
    zero robot block, ``init_cov`` on the 2N logical landmark diagonal,
    zero on any padded tail."""
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
