"""The port's grid pass (ops/kernels/grid_update.py) against the JAX
reference (ops/pallas/grid_update.py): the same numpy operands through
both. On the CPU the port's wrapper runs its plain version; the CUDA
kernel is held to it on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import grid_operands
from shermbot_navigation_tpu.ops.pallas import grid_update as jgu
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as tgu
from shermbot_navigation_tpu_torch.parallel import blocked_ekf


def _tie_operands(N, M, dtype):
    """Row/column ties at equal op index (at the first and the last op),
    and rows and columns whose last inits differ in both orders."""
    ops = grid_operands(N, N, M, seed=5, dtype=dtype)
    rowt = np.full(N, -1, np.int32)
    colt = np.full(N, -1, np.int32)
    rowt[3] = colt[3] = 2                 # tie: the row wins at (3, 3)
    rowt[7], colt[7] = 1, 3
    rowt[9], colt[9] = 3, 0
    colt[11] = M - 1
    rowt[11] = M - 1                      # tie at the last op
    return ops[:5] + [rowt, colt]


def _double_init_operands(N, M):
    """Operands assembled from op buffers (``blocked_ekf.grid_operands``)
    of a tick that initializes slot 3 twice, slot 5 once between, and
    updates in between and after."""
    rng = np.random.default_rng(9)
    bufs = [torch.from_numpy(rng.normal(size=(M, 4, N)).astype(np.float32))
            for _ in range(3)]
    gb = torch.tensor([3, 1, 5, 3, 2, -1][:M], dtype=torch.int32)
    kb = torch.tensor([2, 1, 2, 2, 1, 0][:M], dtype=torch.int32)
    A, Bm, crow, ccol, rowT, colT = blocked_ekf.grid_operands(*bufs, gb,
                                                               kb)
    assert rowT[3] == 3 and rowT[5] == 2 and rowT[1] == -1
    cov = rng.normal(size=(2, 2, N, N)).astype(np.float32)
    return [cov] + [t.numpy() for t in (A, Bm, crow, ccol, rowT, colT)]


def _torch(ops):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in ops]


@pytest.mark.parametrize("Nl,N,M", [(64, 64, 4), (32, 128, 8)])
def test_reference_matches_jax_reference_f64(Nl, N, M):
    """f64: the replay is exact and the products agree to rounding."""
    ops = grid_operands(Nl, N, M)
    want = np.asarray(jgu.reference_grid_update(*map(jnp.asarray, ops)))
    got = tgu.reference_grid_update(*_torch(ops)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["random", "ties", "double_init"])
def test_matches_jax_kernel_interpret_f32(case):
    """f32 against the Pallas kernel in interpret mode; atol 1e-5 is the
    f32 summation-order bound of the K=2M products (M <= 6) of O(1)
    operands."""
    N = 64
    ops = {"random": lambda: grid_operands(N, N, 4, seed=1, dtype=np.float32),
           "ties": lambda: _tie_operands(N, 4, np.float32),
           "double_init": lambda: _double_init_operands(N, 6)}[case]()
    want = np.asarray(jgu.fused_grid_update(*map(jnp.asarray, ops),
                                            interpret=True))
    got = tgu.reference_grid_update(*_torch(ops)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_tie_replay_picks_last_op_row_first():
    """The closed form the CUDA kernel uses: row value when rowt >= colt
    and rowt >= 0, else column value when colt >= 0, else cov."""
    N, M = 16, 4
    cov, a, b, crow, ccol, rowt, colt = _tie_operands(N, M, np.float64)
    zero_a, zero_b = np.zeros_like(a), np.zeros_like(b)
    got = tgu.reference_grid_update(
        *_torch([cov, zero_a, zero_b, crow, ccol, rowt, colt])).numpy()
    want = cov.copy()
    for p in range(2):
        for r in range(2):
            for n in range(N):
                for m in range(N):
                    rt, ct = rowt[n], colt[m]
                    if rt >= 0 and rt >= ct:
                        want[p, r, n, m] = crow[p, r, rt, m]
                    elif ct >= 0:
                        want[p, r, n, m] = ccol[p, r, n, ct]
    np.testing.assert_array_equal(got, want)


def test_wrapper_routes_cpu_to_plain_in_place():
    ops = _torch(grid_operands(32, 32, 4, seed=2, dtype=np.float32))
    want = tgu.reference_grid_update(*ops)
    cov = ops[0].clone()
    before = tgu.fused_grid_update.launches
    out = tgu.fused_grid_update(cov, *ops[1:])
    assert out is cov
    torch.testing.assert_close(cov, want, rtol=0, atol=0)
    assert tgu.fused_grid_update.launches == before


@pytest.mark.parametrize("nl,n,m", [(1, 1, 1), (48, 50, 3), (256, 512, 8),
                                    (2048, 2048, 8), (16, 2048, 8),
                                    (8192, 8192, 8), (16384, 16384, 8),
                                    (64, 64, 64), (2048, 2048, 200)])
def test_launch_plan_walks_every_row_within_shared_memory(nl, n, m):
    """The CUDA kernel's launch plan, a pure function: the walks are
    multiples of the 16-row tile and cover every row, the blocks cover
    every 256-column strip of the four planes, and the B strip (at most 64
    K values a launch) with the two ring slots fits one block's 227 KB."""
    plan = tgu.launch_plan(nl, n, m)
    rows = plan["rows_per_block"]
    assert rows % tgu.TILE_ROWS == 0 and rows >= tgu.TILE_ROWS
    chunks = -(-nl // rows)
    assert chunks * rows >= nl > (chunks - 1) * rows
    assert plan["blocks"] == 4 * -(-n // tgu.TILE_COLS) * chunks
    kc = min(2 * m, tgu.MAX_CHUNK)
    stage = 4 * (16 * 256 + 2 * (16 * (-(-kc // 4) * 4) + 16))
    assert plan["smem_bytes"] == 4 * kc * 256 + 2 * stage
    assert plan["smem_bytes"] <= 227 * 1024


def test_launch_plan_overrides_and_limits():
    """The plan takes no override: it is a function of the shape alone. A
    large grid walks ``ROWS_PER_BLOCK`` rows a block; a small one is cut
    into shorter walks so that it fills the card, down to one tile; a
    short grid walks its rows rounded up to a tile."""
    assert tgu.launch_plan(2048, 2048, 8) == {
        "rows_per_block": tgu.ROWS_PER_BLOCK, "blocks": 4 * 8 * 32,
        "smem_bytes": 4 * 16 * 256 + 2 * 4 * (16 * 256 + 2 * (16 * 16 + 16))}
    assert tgu.launch_plan(256, 512, 8)["rows_per_block"] == 16
    assert tgu.launch_plan(300, 520, 6)["blocks"] == 4 * 3 * 19
    assert tgu.launch_plan(40, 2048, 8)["rows_per_block"] == 48
    with pytest.raises(TypeError):
        tgu.launch_plan(64, 64, 4, 32)
    with pytest.raises(ValueError, match=">= 1"):
        tgu.launch_plan(0, 64, 4)


@pytest.mark.parametrize("which,bad,match", [
    (0, lambda x: x.double(), "f32"),
    (0, lambda x: x.transpose(2, 3), "contiguous"),
    (0, lambda x: x[0], r"cov \(2, 2, nl, n\)"),
    (1, lambda x: x[:, :, :-1], "a must be"),
    (2, lambda x: x.double(), "b must be torch.float32"),
    (3, lambda x: x[:, :, :, :-1], "crow must be"),
    (4, lambda x: x.to("meta"), "ccol must be"),
    (5, lambda x: x.long(), "rowt must be torch.int32"),
    (6, lambda x: x[:-1], "colt must be"),
])
def test_kernel_operands_raise_on_what_the_kernel_does_not_take(which, bad,
                                                                match):
    """The kernel route's operand check (it needs no card): f64, a
    non-contiguous grid, wrong shapes, wrong index types and an operand on
    another device raise; a well-formed set passes."""
    ops = _torch(grid_operands(32, 32, 4, seed=2, dtype=np.float32))
    got, nl, n, m = tgu.kernel_operands(*ops)
    assert (nl, n, m) == (32, 32, 4) and len(got) == 6
    ops[which] = bad(ops[which])
    with pytest.raises(ValueError, match=match):
        tgu.kernel_operands(*ops)
