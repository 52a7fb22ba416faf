"""The work of the port's kernels, counted from the shapes and inputs of a
run, and the card's published peaks: the arithmetic of the kernel table in
``PERF.md`` (each input read once, each output written once), frozen here
so that the yardstick does not move with the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores, at the card's full power limit (700 W).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# f32 operations of one cluster's fit tail (csrc/circle_fit.cu): two 4x4
# Jacobi eigendecompositions of 48 rotations, each rotation 75 multiplies,
# adds and subtracts plus atan2f, cosf and sinf counted as 20 each, and 32
# for the symmetrization; ~380 for Y, Q, the solve and the circle.
TAIL_FLOPS = 2 * (48 * (75 + 3 * 20) + 32) + 380


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the f32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def grid_update_work(n_rows: int, n_cols: int, meas: int, worlds: int = 1):
    """Bytes and f32 operations of one grid pass (kernel 1) over ``worlds``
    grids of four (n_rows, n_cols) planes with ``meas`` measurements: each
    plane read and written once (32 bytes an element of the four), the
    operands A (2, Nl, 2M), B (2, 2M, N), the init rows (2, 2, M, N) and
    columns (2, 2, Nl, M) and the op tables read once; a multiply and an add
    for each of the 2M terms of each plane element."""
    M, Nl, N = meas, n_rows, n_cols
    planes = 2 * 4 * 4 * Nl * N
    operands = 4 * (2 * Nl * 2 * M + 2 * 2 * M * N + 4 * M * N + 4 * Nl * M
                    ) + 4 * (Nl + N)
    flops = 4 * Nl * N * 2 * (2 * M)
    return worlds * (planes + operands), worlds * flops


def circle_fit_tail_work(slots: int, live: int):
    """Bytes and f32 operations of the fit tail (kernel 4) over ``slots``
    cluster slots of which ``live`` hold a cluster to fit (valid, at least
    four points): per slot the 10 moments, cx, cy, zbar and the count read
    (4 bytes each), the valid flag (1 byte), the centre, radius (4 bytes
    each) and ok (1 byte) written; the tail's operations for each live
    cluster."""
    return slots * (14 * 4 + 1 + 3 * 4 + 1), live * TAIL_FLOPS


def ekf_tick_work(worlds: int, D: int, N: int, M: int):
    """Bytes and f32 operations of one filter tick (kernel 5) over
    ``worlds`` worlds of state size ``D = 3 + 2N`` with ``M`` measurements:
    the state read and written once (cov (D, D) and mean (D,) f32, n_seen
    i32, seen (N,) bool a world), the tick's twist (3,) f32, zs (M, 2) f32
    and valid (M,) bool read once (first-hit association: no ids); Q and R
    (13 floats) once for all worlds.

    The operations are those of the busiest tick, every measurement a
    Kalman update: the predict's robot rows and columns (18 D), and for
    each measurement the association over the N landmarks (H P H^T on the
    five columns H touches, 280 each, the distance 20) and the update (P
    H^T 20 D, the gain 8 D, the mean 4 D, the symmetric rank-2 downdate 2
    D (D + 1)). At config 3's D = 43 even these take 0.18 ms at B = 65536
    against the bytes' 0.30 ms, so the bytes set the least time of any of
    its ticks. (At D = 13 they would pass the bytes: a cell there would
    count its ticks' own updates.)"""
    state = 4 * D * D + 4 * D + 4 + N
    inputs = 4 * 3 + 4 * M * 2 + M
    nbytes = worlds * (2 * state + inputs) + 4 * 13
    per_meas = N * 300 + 32 * D + 2 * D * (D + 1)
    return nbytes, worlds * (18 * D + M * per_meas)
