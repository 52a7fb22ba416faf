"""Single-robot serving at large map sizes (port of
``shermbot_navigation_tpu.pipeline.serving``), known or unknown
association.

A serving tick is the deferred blocked tick at map=1, batch=1
(``parallel/blocked_ekf.make_deferred_step``): the whole measurement scan
is one kernel over strips and the landmark grid is touched by one rank-2M
pass per tick. On the card both are the hand-written CUDA kernels
(``ops/kernels``); on the CPU their plain versions run.

Use :class:`ServingEngine` for a stateful loop, or
:func:`make_serving_step` + :func:`state_from_dense` for the functional
step. A dense map migrates in with :func:`state_from_dense` (exact block
re-layout).
"""

from __future__ import annotations

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig, EKFState
from ..parallel import blocked_ekf

def state_from_dense(config: EKFConfig, st: EKFState
                     ) -> blocked_ekf.BlockedState:
    """Re-layout a dense :class:`EKFState` into the blocked serving state
    (batch dim 1): ``plane[p, q, n, m] = cov[3+2n+p, 3+2m+q]``. Exact; any
    padded tail (``config.pad_state_to``) is dropped."""
    N = config.num_landmarks
    D = 3 + 2 * N
    mean = st.mean[:D]
    cov = st.cov[:D, :D]
    cov_mm = cov[3:, 3:].reshape(N, 2, N, 2).permute(1, 3, 0, 2).contiguous()
    diag4 = torch.diagonal(cov_mm, dim1=-2, dim2=-1).reshape(4, N)
    return blocked_ekf.BlockedState(
        mean_r=mean[:3][None].clone(),
        mean_m=mean[3:].reshape(N, 2)[None].clone(),
        cov_rr=cov[:3, :3][None].clone(),
        cov_rm=cov[:3, 3:].reshape(3, N, 2)[None].clone(),
        cov_mm=cov_mm[None],
        diag4=diag4[None].contiguous(),
        n_seen=st.n_seen.reshape(1).clone(),
        seen=st.seen[None].clone(),
    )


def state_to_dense(config: EKFConfig, bst: blocked_ekf.BlockedState
                   ) -> EKFState:
    """Inverse of :func:`state_from_dense` (batch element 0)."""
    N = config.num_landmarks
    D = config.dim
    kw = dict(dtype=bst.mean_r.dtype, device=bst.mean_r.device)
    mean = torch.zeros(D, **kw)
    mean[:3] = bst.mean_r[0]
    mean[3:3 + 2 * N] = bst.mean_m[0].reshape(-1)
    cov = torch.zeros((D, D), **kw)
    cov[:3, :3] = bst.cov_rr[0]
    rm = bst.cov_rm[0].reshape(3, 2 * N)
    cov[:3, 3:3 + 2 * N] = rm
    cov[3:3 + 2 * N, :3] = rm.T
    cov[3:3 + 2 * N, 3:3 + 2 * N] = bst.cov_mm[0].permute(2, 0, 3, 1
                                                          ).reshape(2 * N,
                                                                    2 * N)
    return EKFState(mean=mean, cov=cov, n_seen=bst.n_seen[0],
                    seen=bst.seen[0])


def make_serving_step(config: EKFConfig, max_meas: int, known: bool = True,
                      dtype=torch.float32, device=None,
                      seq_kernel: bool | None = None,
                      grid_kernel: bool | None = None, donate: bool = True):
    """Build the single-robot serving tick on ``device`` (``None`` is the
    card, ``device.resolve``).

    Returns ``tick(state, twist (3,), zs (M, 2), valid (M,), ids (M,),
    Q, R) -> state`` for ``known=True``, and ``tick(state, twist, zs,
    valid, Q, R)`` for ``known=False`` (the reference's Mahalanobis
    first-hit gating). The kernels route as in ``ops/kernels`` (``None`` =
    the CUDA kernels on the card, the plain versions on the CPU).
    ``donate=True`` lets the tick update the input state's grid in place
    (serving states are linear chains); ``donate=False`` copies it first.
    ``dtype`` is the state's dtype (the kernels take f32 only).
    """
    device = resolve(device)
    step = blocked_ekf.make_deferred_step(config, max_meas, device,
                                          known=known, seq_kernel=seq_kernel,
                                          grid_kernel=grid_kernel)

    def tick(state, twist, zs, valid, *rest):
        if state.cov_mm.dtype != dtype:
            raise ValueError(f"state dtype {state.cov_mm.dtype}, tick built "
                             f"for {dtype}")
        if not donate:
            state = state._replace(cov_mm=state.cov_mm.clone())
        ids = (rest[0][None],) if known else ()
        return step(state, twist[None], zs[None], valid[None], *ids,
                    *rest[-2:])

    return tick


class ServingEngine:
    """Stateful single-robot serving loop over a blocked state, known or
    unknown association.

    ``measurements`` shorter than ``max_meas`` are padded with
    ``valid=False`` slots. The state's grid is updated in place.
    ``device=None`` is the card (``device.resolve``)."""

    def __init__(self, config: EKFConfig, max_meas: int, Q, R,
                 known: bool = True, robot_pose=None, dense_state=None,
                 dtype=torch.float32, device=None, **kw):
        self.config = config
        self.max_meas = max_meas
        self.known = known
        self.device = resolve(device)
        self._dtype = dtype
        self._Q = torch.as_tensor(Q, dtype=dtype, device=self.device)
        self._R = torch.as_tensor(R, dtype=dtype, device=self.device)
        if dense_state is not None:
            st = state_from_dense(config, dense_state)
            self.state = blocked_ekf.BlockedState(
                *(x.to(self.device) for x in st))
        else:
            self.state = blocked_ekf.init(config, 1, robot_pose=robot_pose,
                                          dtype=dtype, device=self.device)
        self._tick = make_serving_step(config, max_meas, known=known,
                                       dtype=dtype, device=self.device,
                                       **kw)

    def tick(self, twist, zs, valid=None, ids=None):
        """One tick; ``ids`` is required with known association and
        ignored without it."""
        M = self.max_meas
        dev = self.device
        zs = torch.as_tensor(zs, dtype=self._dtype, device=dev).reshape(-1, 2)
        m = zs.shape[0]
        if m > M:
            raise ValueError(f"{m} measurements > max_meas {M}")
        pad = M - m
        if valid is None:
            valid = torch.ones(m, dtype=torch.bool, device=dev)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
        zs = torch.cat([zs, zs.new_zeros((pad, 2))])
        valid = torch.cat([valid, valid.new_zeros(pad)])
        tw = torch.as_tensor(twist, dtype=self._dtype, device=dev)
        args = ()
        if self.known:
            if ids is None:
                raise ValueError("known-association serving needs ids")
            ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
            args = (torch.cat([ids, ids.new_zeros(pad)]),)
        self.state = self._tick(self.state, tw, zs, valid, *args, self._Q,
                                self._R)
        return self.state

    @property
    def pose(self):
        return self.state.mean_r[0]

    @property
    def n_seen(self):
        return int(self.state.n_seen[0])
