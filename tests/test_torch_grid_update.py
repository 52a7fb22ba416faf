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
    with pytest.raises(ValueError, match="CUDA"):
        tgu.fused_grid_update(cov, *ops[1:], use_kernel=True)
