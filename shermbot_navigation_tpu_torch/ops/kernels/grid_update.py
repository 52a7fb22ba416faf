"""The deferred rank-2M landmark-grid pass (port of
``shermbot_navigation_tpu.ops.pallas.grid_update``).

Per comp plane (p, r) of the grid ``cov (2, 2, Nl, N)``::

    out[p, r] = replay(cov[p, r]) - A[p] @ B[r]

where the replay applies the tick's landmark-init row and column
overwrites in op order (last writer wins; at equal op index the row wins)
and the rank-2M term subtracts every later Kalman update's outer product.

On the card the pass is ``csrc/grid_update.cu``: it replaces the TPU kernel
``fused_grid_update`` (``ops/pallas/grid_update.py``) and is bound by
device-memory bandwidth (one read and one write of the grid, 2 x 16 N^2
bytes per tick). A block owns 256 columns of a plane over a run of rows,
loads its columns of B once, and walks down the rows in 16-row tiles that
arrive through a ``cp.async`` ring in shared memory, so the next tiles'
loads are in flight while this one is multiplied (f32 FMA, K = 2M) and
stored; the overwrite is resolved in closed form per element.
:func:`launch_plan` chooses the rows a block walks and the ring's depth.
It updates the grid in place;
:func:`reference_grid_update` is the plain version. With B worlds
(operands with a leading B) one launch covers them all: the launch grid's
z runs over the 4 B (world, plane) pairs.
"""

from __future__ import annotations

import torch

from . import checked_operands, require, wants_kernel
from ._build import check, library, stream_handle


TILE_ROWS, TILE_COLS = 16, 256   # the kernel's tile; a block is 64 x 4 threads
MAX_CHUNK = 64                   # K values of B a launch keeps in shared memory
STAGES = 2                       # the kernel's ring: the tile in use + the next
ROWS_PER_BLOCK = 64              # the walk: B is staged once per this many rows
MIN_BLOCKS = 2 * 132             # two blocks for each of the card's SMs


MAX_WORLDS = 65535 // 4           # the launch grid's z is 4 B


def launch_plan(nl: int, n: int, m: int, *, batch: int = 1) -> dict:
    """How the CUDA kernel is launched for B = ``batch`` grids of
    (2, 2, nl, n) and M = m: a pure function. Returns
    ``{"rows_per_block", "blocks", "smem_bytes"}``. A block walks
    ``rows_per_block`` rows (a multiple of 16) of one 256-column strip of
    one world's plane; the walk is halved while the launch has fewer than
    ``MIN_BLOCKS`` blocks, so a small grid still fills the card.
    ``smem_bytes`` is the B strip and the two ring slots (52 KB at M = 8:
    four blocks an SM)."""
    if min(nl, n, m, batch) < 1:
        raise ValueError(f"grid_update plan: nl, n, m, batch >= 1, got "
                         f"{nl}, {n}, {m}, {batch}")
    strips = -(-n // TILE_COLS)
    rows_per_block = min(ROWS_PER_BLOCK, -(-nl // TILE_ROWS) * TILE_ROWS)
    while (rows_per_block > TILE_ROWS and rows_per_block % 32 == 0
           and 4 * batch * strips * -(-nl // rows_per_block) < MIN_BLOCKS):
        rows_per_block //= 2
    kc = min(2 * m, MAX_CHUNK)
    stage_bytes = 4 * (TILE_ROWS * TILE_COLS
                       + 2 * (TILE_ROWS * (-(-kc // 4) * 4) + TILE_ROWS))
    return {"rows_per_block": rows_per_block,
            "blocks": 4 * batch * strips * -(-nl // rows_per_block),
            "smem_bytes": 4 * kc * TILE_COLS + STAGES * stage_bytes}


def reference_grid_update(cov, a, b, crow, ccol, rowt, colt):
    """Plain PyTorch twin of the JAX ``reference_grid_update``: the
    ascending replay loop, then the per-plane product (full f32 or f64).

    cov  (2, 2, Nl, N)   a (2, Nl, 2M)   b (2, 2M, N)
    crow (2, 2, M, N)    ccol (2, 2, Nl, M)
    rowt (Nl,) int32     colt (N,) int32   (-1 = no init)
    or each with a leading world axis B. Returns a new tensor.
    """
    M = crow.shape[-2]
    rt = rowt[..., :, None]
    ct = colt[..., None, :]
    outs = []
    for p in range(2):
        row_out = []
        for r in range(2):
            base = cov[..., p, r, :, :]
            for i in range(M):
                base = torch.where(ct == i, ccol[..., p, r, :, i:i + 1], base)
                base = torch.where(rt == i, crow[..., p, r, i:i + 1, :], base)
            row_out.append(base - a[..., p, :, :] @ b[..., r, :, :])
        outs.append(torch.stack(row_out, dim=-3))
    return torch.stack(outs, dim=-4)


def kernel_operands(cov, a, b, crow, ccol, rowt, colt):
    """What the CUDA kernel takes: a contiguous f32 ``cov (2, 2, nl, n)``
    (updated in place), f32 operands and int32 tables of
    :func:`reference_grid_update`'s shapes on ``cov``'s device, for one
    world, or each with a leading B <= ``MAX_WORLDS``. Raises
    ``ValueError`` otherwise; returns (contiguous operands by name, each
    with the leading B, 1 for one world; nl, n, m). Needs no card."""
    name = "grid_update"
    require(cov.dtype == torch.float32, name, f"cov must be f32, got "
            f"{cov.dtype}")
    require(cov.dim() in (4, 5) and tuple(cov.shape[-4:-2]) == (2, 2)
            and crow.dim() == cov.dim(), name,
            f"cov (2, 2, nl, n) and crow (2, 2, m, n), or each with a "
            f"leading B, got {tuple(cov.shape)} and {tuple(crow.shape)}")
    require(cov.is_contiguous(), name, "cov must be contiguous (in place)")
    if cov.dim() == 4:
        cov, a, b, crow, ccol, rowt, colt = (
            x[None] for x in (cov, a, b, crow, ccol, rowt, colt))
    B, _, _, nl, n = cov.shape
    m = crow.shape[3]
    require(B <= MAX_WORLDS, name, f"at most {MAX_WORLDS} worlds, got {B}")
    spec = {"a": (a, (B, 2, nl, 2 * m), torch.float32),
            "b": (b, (B, 2, 2 * m, n), torch.float32),
            "crow": (crow, (B, 2, 2, m, n), torch.float32),
            "ccol": (ccol, (B, 2, 2, nl, m), torch.float32),
            "rowt": (rowt, (B, nl), torch.int32),
            "colt": (colt, (B, n), torch.int32)}
    return checked_operands(name, cov.device, spec), nl, n, m


def fused_grid_update(cov, a, b, crow, ccol, rowt, colt):
    """Apply the grid pass to ``cov`` IN PLACE and return it.

    Operands as in :func:`reference_grid_update`: one world, or B worlds
    with a leading B on every operand (one launch for all of them).
    Routed by the package rule (``ops/kernels/__init__.py``): the CUDA
    kernel for a CUDA ``cov`` (f32 only; anything else raises), the plain
    version on the CPU.
    ``fused_grid_update.launches`` counts kernel launches.
    """
    name = "grid_update"
    if not wants_kernel(cov):
        cov.copy_(reference_grid_update(cov, a, b, crow, ccol, rowt, colt))
        return cov
    ops, nl, n, m = kernel_operands(cov, a, b, crow, ccol, rowt, colt)
    B = ops["a"].shape[0]
    plan = launch_plan(nl, n, m, batch=B)
    code = library().grid_update(
        cov.data_ptr(), ops["a"].data_ptr(), ops["b"].data_ptr(),
        ops["crow"].data_ptr(), ops["ccol"].data_ptr(),
        ops["rowt"].data_ptr(), ops["colt"].data_ptr(), nl, n, m, B,
        plan["rows_per_block"], stream_handle(cov.device))
    check(name, code)
    fused_grid_update.launches += 1
    return cov


fused_grid_update.launches = 0
