"""Move filter state between the JAX package and this one.

A state crosses as a dict of numpy arrays keyed by the JAX field names, in
the JAX layouts (for a JAX ``NamedTuple`` state ``s``:
``{k: numpy.asarray(v) for k, v in s._asdict().items()}``). Dtypes are
kept: float32 / float64 fields, int32 ``n_seen``, bool ``seen``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ekf_slam import EKFState
from ..parallel.blocked_ekf import BlockedState


def _from_numpy(cls, arrays: dict, device):
    return cls(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                  for k in cls._fields})


def _to_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def blocked_state_from_numpy(arrays: dict, device="cpu") -> BlockedState:
    return _from_numpy(BlockedState, arrays, device)


def blocked_state_to_numpy(state: BlockedState) -> dict:
    return _to_numpy(state)


def ekf_state_from_numpy(arrays: dict, device="cpu") -> EKFState:
    return _from_numpy(EKFState, arrays, device)


def ekf_state_to_numpy(state: EKFState) -> dict:
    return _to_numpy(state)
