"""Move state between the JAX package and this one.

A state crosses as a dict of numpy arrays keyed by the JAX field names, in
the JAX layouts (for a JAX ``NamedTuple`` state ``s``:
``{k: numpy.asarray(v) for k, v in s._asdict().items()}``). Dtypes are
kept: float32 / float64 fields, int32 counters, bool masks. A nested state
(``WorldState.drive``) crosses as a nested dict. A vmapped JAX state has
its batch leading, which is the port's batch-first layout; the
batch-trailing ``BatchState`` has the same layout on both sides.

``device=None`` is the card, as everywhere in the package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..models.ekf_batch import BatchState
from ..models.ekf_slam import EKFState
from ..ops.clustering import Clusters
from ..ops.diff_drive import DiffDriveState
from ..parallel.blocked_ekf import BlockedState
from ..sim.tube_world import WorldState


def _from_numpy(cls, arrays: dict, device):
    device = resolve(device)
    return cls(**{k: torch.from_numpy(np.array(arrays[k])).to(device)
                  for k in cls._fields})


def _to_numpy(state) -> dict:
    return {k: (_to_numpy(v) if hasattr(v, "_asdict")
                else v.detach().cpu().numpy())
            for k, v in state._asdict().items()}


def blocked_state_from_numpy(arrays: dict, device=None) -> BlockedState:
    return _from_numpy(BlockedState, arrays, device)


def blocked_state_to_numpy(state: BlockedState) -> dict:
    return _to_numpy(state)


def ekf_state_from_numpy(arrays: dict, device=None) -> EKFState:
    return _from_numpy(EKFState, arrays, device)


def ekf_state_to_numpy(state: EKFState) -> dict:
    return _to_numpy(state)


def batch_state_from_numpy(arrays: dict, device=None) -> BatchState:
    return _from_numpy(BatchState, arrays, device)


def batch_state_to_numpy(state: BatchState) -> dict:
    return _to_numpy(state)


def world_state_from_numpy(arrays: dict, device=None) -> WorldState:
    return WorldState(
        drive=_from_numpy(DiffDriveState, arrays["drive"], device),
        cmd_wheels=torch.from_numpy(np.array(arrays["cmd_wheels"])).to(
            resolve(device)))


def world_state_to_numpy(state: WorldState) -> dict:
    return _to_numpy(state)


def clusters_from_numpy(arrays: dict, device=None) -> Clusters:
    return _from_numpy(Clusters, arrays, device)
