"""The segmented perception path's front end in one kernel
(``csrc/perception.cu``), with its plain version.

:func:`fit_inputs` takes scans ``ranges (..., n)`` and gives each scan's
C cluster slots the circle fit's inputs: ``(moments (..., C, 10), cx, cy,
zbar, count, valid, is_circle)``, the moments the ten distinct sums (zz,
zx, zy, z, xx, xy, x, yy, y, n) that ``circle_fit.fit_tail`` reads. The
plain version is ``clustering._segment_fit_inputs``, which reduces
``(..., C, n)`` one-hot tensors by matrix products; on the card the
kernel takes all B scans in one launch and builds no such tensor.

It replaces no TPU kernel (the JAX package leaves this stage to XLA). Per
ray the kernel repeats the plain version's operations one rounding at a
time, and it sums each slot's rows one after another in ray order; so it
gives the bits of the plain version whose one-hot products add the rays in
ray order. cuBLAS's products on the card mostly take that order, but not
always: on config 3's scans at B = 1024, 0.42% of the slots' moments
differ, by up to 2e-6, within float32's bound for another order. The
wrapper follows the package rule (``ops/kernels/__init__.py``): the
kernel for scans on the card, the plain version on the CPU; a scan the
kernel does not take (not float32, not contiguous, no :func:`launch_plan`
for its n and C) raises, never falls back. ``fit_inputs.launches`` counts
kernel launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..clustering import SPLIT_THRESHOLD, _segment_fit_inputs
from . import require, wants_kernel
from ._build import check, library, stream_handle

NAME = "segment_fit_inputs"
MAX_RAYS = 1024             # rays a scan
MAX_SLOTS = 32              # cluster slots a scan
SLOT_BYTES = 1040           # a world's shared memory beside its rays
RAY_WORDS = 5               # shared words a ray: range, x, y, angle, slot
WORLDS = 4                  # worlds a block, a warp each
RAYS = (1, 2, 4, 8, 12, 16, 24, 32)   # the source's instances: rays a lane


class Plan(NamedTuple):
    rays: int               # rays a lane (the instance)
    threads: int            # threads a block
    shared_bytes: int       # dynamic shared memory a block


def launch_plan(n: int, C: int, P: int) -> Plan | None:
    """The launch for scans of ``n`` rays into ``C`` slots of ``P`` rows:
    a warp a world, :data:`WORLDS` worlds a block, each lane a run of
    consecutive rays (the smallest instance that holds n), or None past
    what the kernel takes (n > 1024, C > 32). Pure: no card."""
    if not (1 <= n <= MAX_RAYS and 1 <= C <= MAX_SLOTS and P >= 1):
        return None
    rays = next(k for k in RAYS if 32 * k >= n)
    rays_bytes = 4 * RAY_WORDS * (-(-n // 4) * 4)
    return Plan(rays, 32 * WORLDS, WORLDS * (SLOT_BYTES + rays_bytes))


def _bound(v, dev, what):
    """(pointer, value) of a range bound: a float32 one-element tensor on
    the scan's device is read by the kernel where it lies (no host read);
    a number is passed by value."""
    if isinstance(v, torch.Tensor):
        if not (v.dtype == torch.float32 and v.numel() == 1
                and v.device == dev):
            require(False, NAME, f"{what} must be a float32 number or "
                                 f"one-element tensor on {dev}, got "
                                 f"{v.dtype} {tuple(v.shape)} on {v.device}")
        return v.data_ptr(), 0.0
    return None, float(v)


def _launch(ranges, min_range, max_range, C, P, std_threshold_deg,
            margins):
    dev = ranges.device
    if ranges.dtype != torch.float32 or ranges.dim() < 1:
        require(False, NAME, f"scan must be torch.float32 (..., n), got "
                             f"{ranges.dtype} {tuple(ranges.shape)}")
    require(ranges.is_contiguous(), NAME, "scan must be contiguous")
    lead, n = ranges.shape[:-1], ranges.shape[-1]
    plan = launch_plan(n, C, P)
    require(plan is not None, NAME, f"no launch plan for n={n}, C={C}, P={P} "
                                    f"(n <= {MAX_RAYS}, C <= {MAX_SLOTS})")
    B = ranges.numel() // n
    require(B >= 1, NAME, "needs at least one scan")
    lo_p, lo = _bound(min_range, dev, "min_range")
    hi_p, hi = _bound(max_range, dev, "max_range")
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    mom, cx, cy, zbar = f32(B, C, 10), f32(B, C), f32(B, C), f32(B, C)
    count = torch.empty((B, C), dtype=torch.int32, device=dev)
    valid = torch.empty((B, C), dtype=torch.bool, device=dev)
    circle = torch.empty((B, C), dtype=torch.bool, device=dev)
    marg = f32(B, 2) if margins is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    check(NAME, library().segment_fit_inputs(
        ranges.data_ptr(), lo_p, hi_p, lo, hi, SPLIT_THRESHOLD,
        std_threshold_deg, mom.data_ptr(), cx.data_ptr(), cy.data_ptr(),
        zbar.data_ptr(), count.data_ptr(), valid.data_ptr(),
        circle.data_ptr(), ptr(marg), n, C, P, B, plan.rays,
        plan.shared_bytes, stream_handle(dev)))
    fit_inputs.launches += 1
    if marg is not None:
        least = marg.amin(0)
        margins["split"], margins["std"] = least[0], least[1]
    shape = lambda *s: (*lead, C, *s)
    return (mom.reshape(shape(10)), cx.reshape(shape()), cy.reshape(shape()),
            zbar.reshape(shape()), count.reshape(shape()),
            valid.reshape(shape()), circle.reshape(shape()))


def fit_inputs(ranges, min_range, max_range, max_clusters: int,
               max_points: int, std_threshold_deg: float = 10.0,
               margins: dict | None = None):
    """Scans ``ranges (..., n)`` -> ``(moments (..., C, 10), cx, cy, zbar,
    count (int32), valid, is_circle)`` for ``C = max_clusters`` slots of
    ``max_points`` rows, as ``clustering._segment_fit_inputs``.
    ``min_range`` / ``max_range``: numbers, or one-element float32 tensors
    on the scans' device. ``margins`` (a dict, diagnostics) receives the
    smallest distances of a split and a circle decision to their
    thresholds, as there."""
    if not wants_kernel(ranges):
        return _segment_fit_inputs(ranges, min_range, max_range,
                                   max_clusters, max_points,
                                   std_threshold_deg, margins)
    return _launch(ranges, min_range, max_range, max_clusters, max_points,
                   std_threshold_deg, margins)


fit_inputs.launches = 0
