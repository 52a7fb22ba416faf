"""Circle-fit front end: masked centroid + 4x4 moment matrix per cluster
(port of ``shermbot_navigation_tpu.ops.pallas.circle_moments``).

For each cluster of ``P`` padded points with ``count`` valid ones::

    w = pos < count,  n = max(count, 1)
    cx, cy = sum(x w) / n, sum(y w) / n
    xc, yc = (x - cx) w, (y - cy) w,  z = xc^2 + yc^2
    M = Z^T Z,  Z = [z, xc, yc, w]        zbar = sum(z) / n

``count`` may exceed ``P`` (``cluster_scan`` drops overflow rows but keeps
the full count): the sums then run over all ``P`` rows and the divisions
use the full count.

On the card it is ``csrc/circle_moments.cu``, which replaces the TPU kernel
``circle_moments_raw`` (``ops/pallas/circle_moments.py``). It is bound by
device-memory bandwidth in name (one read of the points, 8.4 MB at
C=16384, P=64; 19 floats written a cluster) and by the launch in fact: the
bound is a few microseconds. One warp per cluster, a float2 load per point,
shuffle reductions; any ``C >= 1`` and ``P >= 1`` (the TPU kernel's
``C % 8`` tile gate was lowering only). :func:`reference_circle_moments`
is the plain version.
"""

from __future__ import annotations

import torch

from . import require, wants_kernel
from ._build import check, library, stream_handle


def _reference_raw(points, counts):
    """Plain version on ``points (..., P, 2)``, ``counts (...,)``:
    ``(mc, cx, cy, zbar)`` with ``mc`` the 16 row-major entries of ``M`` as
    a list of ``(...,)`` tensors. The mask is applied as a select, so rows
    at and past ``count`` may hold anything."""
    P = points.shape[-2]
    dt = points.dtype
    mask = torch.arange(P, device=points.device) < counts[..., None]
    w = mask.to(dt)
    n = torch.clamp_min(counts.to(dt), 1.0)
    zero = torch.zeros((), dtype=dt, device=points.device)
    cx = torch.sum(torch.where(mask, points[..., 0], zero), dim=-1) / n
    cy = torch.sum(torch.where(mask, points[..., 1], zero), dim=-1) / n
    x = torch.where(mask, points[..., 0] - cx[..., None], zero)
    y = torch.where(mask, points[..., 1] - cy[..., None], zero)
    z = x * x + y * y
    s = lambda a: torch.sum(a, dim=-1)
    szz, szx, szy, sz = s(z * z), s(z * x), s(z * y), s(z)
    sxx, sxy, sx = s(x * x), s(x * y), s(x)
    syy, sy, sn = s(y * y), s(y), s(w)
    mc = [szz, szx, szy, sz,
          szx, sxx, sxy, sx,
          szy, sxy, syy, sy,
          sz, sx, sy, sn]
    return mc, cx, cy, sz / n


def reference_circle_moments(points, counts):
    """Plain PyTorch twin of the JAX ``reference_circle_moments``:
    ``points (C, P, 2)``, ``counts (C,)`` -> ``(M (C, 4, 4), centroid
    (C, 2), zbar (C,))``; f32 or f64, CPU or card."""
    mc, cx, cy, zbar = _reference_raw(points, counts)
    M = torch.stack(mc, dim=-1).reshape(*points.shape[:-2], 4, 4)
    return M, torch.stack([cx, cy], dim=-1), zbar


def circle_moments_raw(points, counts, use_kernel: bool | None = None):
    """``points (..., P, 2)``, ``counts (...,)`` integer -> ``(M16 (..., 16)``
    row-major flat, ``centroid (..., 2)``, ``zbar (...,))``. Leading batch
    dimensions are flattened into the kernel's cluster axis.

    ``use_kernel`` follows the package rule (``ops/kernels/__init__.py``):
    auto launches the CUDA kernel for CUDA points and runs the plain
    version on the CPU; the kernel takes f32 only and raises otherwise.
    ``circle_moments_raw.launches`` counts kernel launches."""
    name = "circle_moments"
    if not wants_kernel(points, use_kernel, name):
        mc, cx, cy, zbar = _reference_raw(points, counts)
        return (torch.stack(mc, dim=-1), torch.stack([cx, cy], dim=-1),
                zbar)
    lead = points.shape[:-2]
    P = points.shape[-2]
    dev = points.device
    require(points.dim() >= 3 and points.shape[-1] == 2 and P >= 1, name,
            f"points must be (..., P >= 1, 2), got {tuple(points.shape)}")
    require(points.dtype == torch.float32, name,
            f"points must be float32, got {points.dtype}")
    require(tuple(counts.shape) == tuple(lead) and counts.device == dev
            and not counts.dtype.is_floating_point
            and counts.dtype != torch.bool, name,
            f"counts must be integer {tuple(lead)} on {dev}, got "
            f"{counts.dtype} {tuple(counts.shape)} on {counts.device}")
    C = 1
    for d in lead:
        C *= d
    require(C >= 1, name, "needs at least one cluster")
    pts = points.reshape(C, P, 2).contiguous()
    cnt = counts.reshape(C).to(torch.int32).contiguous()
    m16 = torch.empty((C, 16), dtype=torch.float32, device=dev)
    cent = torch.empty((C, 2), dtype=torch.float32, device=dev)
    zbar = torch.empty((C,), dtype=torch.float32, device=dev)
    # float2 loads of the points, float4 stores of the moment rows
    require(pts.data_ptr() % 8 == 0 and m16.data_ptr() % 16 == 0, name,
            "points must be 8-byte aligned")
    code = library().circle_moments(
        pts.data_ptr(), cnt.data_ptr(), m16.data_ptr(), cent.data_ptr(),
        zbar.data_ptr(), C, P, stream_handle(dev))
    check(name, code)
    circle_moments_raw.launches += 1
    return (m16.reshape(*lead, 16), cent.reshape(*lead, 2),
            zbar.reshape(lead))


circle_moments_raw.launches = 0


def circle_moments(points, counts, use_kernel: bool | None = None):
    """Tensor-output wrapper: ``(M (..., 4, 4), centroid (..., 2),
    zbar (...,))``."""
    m, cent, zbar = circle_moments_raw(points, counts, use_kernel=use_kernel)
    return m.reshape(*m.shape[:-1], 4, 4), cent, zbar
