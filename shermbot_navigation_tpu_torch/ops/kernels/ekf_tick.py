"""The batch-trailing filter's whole tick in one kernel
(``csrc/ekf_tick.cu``), with its plain version.

:func:`step` takes the state of B worlds (``models.ekf_batch.BatchState``:
mean ``(D, B)``, cov ``(D, D, B)``) and one tick's odometry and
measurements, and returns the new state: the predict, then the M
measurements in order, with unknown (first-hit or nearest) or known
association, as ``ekf_batch.step`` / ``known_association_step`` do. On the
card that is one launch for all B worlds; each block keeps its worlds'
state in shared memory from the first read to the one write, where the
eager tick read and wrote the whole covariance ~600 times. The plain
version, :func:`reference_step`, is those two functions; the kernel
repeats their operations one rounding at a time.

It replaces no TPU kernel (the JAX package leaves the tick to XLA). The
wrapper follows the package rule (``ops/kernels/__init__.py``): the
kernel for a CUDA state, the plain version on the CPU; on a CUDA operand
the kernel does not take (not float32, a padded state, no
:func:`launch_plan` for its D and M) it raises, never falls back.
``step.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...models import ekf_batch
from ...models.ekf_slam import EKFConfig
from . import checked_operands, require, wants_kernel
from ._build import check, library, stream_handle

SHARED_LIMIT = 232_448      # dynamic shared memory a block may use (H100)
SLICES = 32                 # threads a world
SCALARS = 16                # per-world scalars in shared memory
WORLDS = 8                  # worlds a block

# launch flags (csrc/ekf_tick.cu)
KNOWN, NEAREST, ANALYTIC, SYMMETRIZE, WRAP = 1, 2, 4, 8, 16


class Plan(NamedTuple):
    worlds: int             # worlds a block
    threads: int            # threads a block (SLICES a world)
    shared_bytes: int       # dynamic shared memory a block


def shared_bytes(D: int, M: int) -> int:
    """Dynamic shared memory of a block: its worlds' state (covariance,
    mean), SHt and K, the distances, the tick's measurements and the
    per-world scalars and bookkeeping (``smem_bytes`` in the source
    computes the same)."""
    W, N = WORLDS, (D - 3) // 2
    floats = W * (D * D + 5 * D + N + 2 * M + SCALARS) + 16
    ints = W * (3 + M)
    nbytes = W * (N + M)
    return (4 * (floats + ints) + nbytes + 15) // 16 * 16


def launch_plan(D: int, M: int) -> Plan | None:
    """The launch for state size ``D = 3 + 2N`` and ``M`` measurements a
    tick: :data:`WORLDS` worlds a block, their state in shared memory, or
    None where it does not fit (the kernel then refuses). Pure: no card.
    """
    if D < 5 or D % 2 == 0 or M < 1:
        return None
    nb = shared_bytes(D, M)
    return Plan(WORLDS, SLICES * WORLDS, nb) if nb <= SHARED_LIMIT else None


def reference_step(config: EKFConfig, st: ekf_batch.BatchState, twist, zs,
                   valid, Q, R, ids=None, margins: list | None = None
                   ) -> ekf_batch.BatchState:
    """The plain version: ``ekf_batch.known_association_step`` where
    ``ids`` (B, M) int32 is given, else ``ekf_batch.step`` (which appends
    each measurement's per-world gate margins to ``margins``)."""
    if ids is not None:
        return ekf_batch.known_association_step(config, st, twist, zs,
                                                valid, ids, Q, R)
    return ekf_batch.step(config, st, twist, zs, valid, Q, R, margins)


def _flags(config: EKFConfig, known: bool) -> int:
    return ((KNOWN if known else 0)
            | (NEAREST if config.assoc_mode == "nearest" else 0)
            | (ANALYTIC if config.analytic_init else 0)
            | (SYMMETRIZE if config.symmetrize else 0)
            | (WRAP if config.wrap_innovation else 0))


def _launch(config, st, twist, zs, valid, Q, R, ids, margins):
    name = "ekf_tick"
    D, B = st.mean.shape
    N = config.num_landmarks
    M = zs.shape[1]
    dev = st.mean.device
    f32, i32 = torch.float32, torch.int32
    require(config.assoc_mode in ("first_hit", "nearest"), name,
            f"unknown assoc_mode {config.assoc_mode!r}")
    plan = launch_plan(D, M)
    require(plan is not None and D == 3 + 2 * N, name,
            f"no launch plan for D={D} (N={N}), M={M}")
    spec = {"cov": (st.cov, (D, D, B), f32), "mean": (st.mean, (D, B), f32),
            "n_seen": (st.n_seen, (B,), i32),
            "seen": (st.seen, (N, B), torch.bool),
            "twist": (twist, (B, 3), f32), "zs": (zs, (B, M, 2), f32),
            "valid": (valid, (B, M), torch.bool), "Q": (Q, (3, 3), f32),
            "R": (R, (2, 2), f32)}
    if ids is not None:
        spec["ids"] = (ids, (B, M), i32)
    ops = checked_operands(name, dev, spec)
    # 16-byte copies of the covariance and the mean
    require(ops["cov"].data_ptr() % 16 == 0
            and ops["mean"].data_ptr() % 16 == 0, name,
            "cov and mean must be 16-byte aligned")
    out = ekf_batch.BatchState(mean=torch.empty_like(ops["mean"]),
                               cov=torch.empty_like(ops["cov"]),
                               n_seen=torch.empty_like(ops["n_seen"]),
                               seen=torch.empty_like(ops["seen"]))
    marg = None
    if margins is not None and ids is None:
        marg = torch.empty(B, dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = library().ekf_tick(
        ptr(ops["cov"]), ptr(ops["mean"]), ptr(ops["n_seen"]),
        ptr(ops["seen"]), ptr(ops["twist"]), ptr(ops["zs"]),
        ptr(ops["valid"]), ptr(ops.get("ids")), ptr(ops["Q"]),
        ptr(ops["R"]), ptr(out.cov), ptr(out.mean), ptr(out.n_seen),
        ptr(out.seen), ptr(marg), D, M, B, plan.worlds, plan.shared_bytes,
        _flags(config, ids is not None), config.match_gate,
        config.new_gate, stream_handle(dev))
    check(name, code)
    step.launches += 1
    if marg is not None:
        margins.append(marg)
    return out


def step(config: EKFConfig, st: ekf_batch.BatchState, twist, zs, valid, Q,
         R, ids=None, margins: list | None = None) -> ekf_batch.BatchState:
    """One tick of B worlds; returns the new state (new tensors).

    ``twist`` (B, 3), ``zs`` (B, M, 2), ``valid`` (B, M) bool, ``Q`` (3, 3),
    ``R`` (2, 2); ``ids`` (B, M) int32 for known association (None:
    unknown). ``margins`` (a list, diagnostics, unknown association):
    the kernel appends each world's smallest relative gate margin of the
    tick, one (B,) tensor, where the plain version appends one a
    measurement; their ``amin`` agrees."""
    if not wants_kernel(st.cov):
        return reference_step(config, st, twist, zs, valid, Q, R, ids,
                              margins)
    return _launch(config, st, twist, zs, valid, Q, R, ids, margins)


step.launches = 0
