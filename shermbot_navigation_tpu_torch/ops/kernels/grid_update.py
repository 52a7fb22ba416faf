"""The deferred rank-2M landmark-grid pass (port of
``shermbot_navigation_tpu.ops.pallas.grid_update``).

Per comp plane (p, r) of the grid ``cov (2, 2, Nl, N)``::

    out[p, r] = replay(cov[p, r]) - A[p] @ B[r]

where the replay applies the tick's landmark-init row and column
overwrites in op order (last writer wins; at equal op index the row wins)
and the rank-2M term subtracts every later Kalman update's outer product.

On the card the pass is ``csrc/grid_update.cu``: it replaces the TPU kernel
``fused_grid_update`` (``ops/pallas/grid_update.py``), is bound by
device-memory bandwidth (one read and one write of the grid, 2 x 16 N^2
bytes per tick), and does it as one tiled pass with the overwrite resolved
in closed form per element and the K=2M sum as f32 FMA. It updates the grid
in place; :func:`reference_grid_update` is the plain version.
"""

from __future__ import annotations

import torch

from . import require, wants_kernel
from ._build import check, library, stream_handle


def reference_grid_update(cov, a, b, crow, ccol, rowt, colt):
    """Plain PyTorch twin of the JAX ``reference_grid_update``: the
    ascending replay loop, then the per-plane product (full f32 or f64).

    cov  (2, 2, Nl, N)   a (2, Nl, 2M)   b (2, 2M, N)
    crow (2, 2, M, N)    ccol (2, 2, Nl, M)
    rowt (Nl,) int32     colt (N,) int32   (-1 = no init)
    Returns a new tensor.
    """
    M = crow.shape[2]
    rt = rowt[:, None]
    ct = colt[None, :]
    outs = []
    for p in range(2):
        row_out = []
        for r in range(2):
            base = cov[p, r]
            for i in range(M):
                base = torch.where(ct == i, ccol[p, r, :, i:i + 1], base)
                base = torch.where(rt == i, crow[p, r, i:i + 1, :], base)
            row_out.append(base - a[p] @ b[r])
        outs.append(torch.stack(row_out))
    return torch.stack(outs)


def fused_grid_update(cov, a, b, crow, ccol, rowt, colt,
                      use_kernel: bool | None = None):
    """Apply the grid pass to ``cov`` IN PLACE and return it.

    Operands as in :func:`reference_grid_update`. ``use_kernel`` follows
    the package rule (``ops/kernels/__init__.py``): auto launches the CUDA
    kernel for a CUDA ``cov`` (f32 only; anything else raises) and runs the
    plain version on the CPU. ``fused_grid_update.launches`` counts kernel
    launches.
    """
    name = "grid_update"
    if not wants_kernel(cov, use_kernel, name):
        cov.copy_(reference_grid_update(cov, a, b, crow, ccol, rowt, colt))
        return cov
    _, _, nl, n = cov.shape
    m = crow.shape[2]
    dev = cov.device
    require(cov.dtype == torch.float32, name, f"cov must be f32, got "
            f"{cov.dtype}")
    require(cov.is_contiguous(), name, "cov must be contiguous (in place)")
    require(tuple(cov.shape[:2]) == (2, 2), name, f"cov {tuple(cov.shape)}")
    shapes = {"a": (a, (2, nl, 2 * m), torch.float32),
              "b": (b, (2, 2 * m, n), torch.float32),
              "crow": (crow, (2, 2, m, n), torch.float32),
              "ccol": (ccol, (2, 2, nl, m), torch.float32),
              "rowt": (rowt, (nl,), torch.int32),
              "colt": (colt, (n,), torch.int32)}
    ops = {}
    for key, (t, shape, dtype) in shapes.items():
        require(tuple(t.shape) == shape and t.dtype == dtype
                and t.device == dev, name,
                f"{key} must be {dtype} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        ops[key] = t.contiguous()
    code = library().grid_update(
        cov.data_ptr(), ops["a"].data_ptr(), ops["b"].data_ptr(),
        ops["crow"].data_ptr(), ops["ccol"].data_ptr(),
        ops["rowt"].data_ptr(), ops["colt"].data_ptr(), nl, n, m,
        stream_handle(dev))
    check(name, code)
    fused_grid_update.launches += 1
    return cov


fused_grid_update.launches = 0
