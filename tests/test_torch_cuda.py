"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and ``nvcc`` and skips elsewhere. The
file imports no JAX (the card's machine has none). Run it there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Tolerances: the
grid pass's K=2M products are summed in another order than cuBLAS (atol
1e-4 for O(1) operands); the scan and the tick differ from the plain
version by summation order, libm ulps and the row-for-column grid read
(PARITY D13), atol 1e-5 at these small sizes and few ticks.
"""

import numpy as np
import pytest
import torch

from _torch_parity import grid_operands, scan_inputs
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as tgu
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as tsq
from shermbot_navigation_tpu_torch.parallel import bigmap
from shermbot_navigation_tpu_torch.pipeline import serving

pytestmark = pytest.mark.requires_cuda
NAMES = ("mean_r", "mm2", "cov_rr", "rm6", "diag4", "seen", "n_seen", "Kb",
         "HSb", "CRb", "gb", "kindb")
DISCRETE = {"seen", "n_seen", "gb", "kindb"}


@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("Nl,N,M", [(256, 512, 8), (48, 50, 3)])
def test_grid_update_kernel_matches_plain(dev, Nl, N, M):
    """Includes a ragged shape (rows not a multiple of 16, N % 4 != 0)."""
    ops = [torch.from_numpy(x).to(dev) for x in
           grid_operands(Nl, N, M, seed=3, dtype=np.float32)]
    want = tgu.reference_grid_update(*ops)
    before = tgu.fused_grid_update.launches
    cov = ops[0].clone()
    got = tgu.fused_grid_update(cov, *ops[1:])
    torch.cuda.synchronize()
    assert got is cov and tgu.fused_grid_update.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_grid_update_kernel_raises_on_f64(dev):
    ops = [torch.from_numpy(x).to(dev) for x in grid_operands(32, 32, 4)]
    with pytest.raises(ValueError, match="f32"):
        tgu.fused_grid_update(ops[0], *ops[1:])


@pytest.mark.parametrize("ids,valid", [
    ([60, 5, 60, 3], [1, 1, 1, 1]),
    ([64, 61, -1, 7], [1, 1, 1, 0]),
])
def test_seq_scan_kernel_matches_plain(dev, ids, valid):
    x = scan_inputs(64, 4, ids, valid)
    args = [torch.from_numpy(np.array(v)).to(dev)
            for v in x.values()]
    before = tsq.deferred_seq_scan.launches
    got = tsq.deferred_seq_scan(*args)
    torch.cuda.synchronize()
    assert tsq.deferred_seq_scan.launches == before + 1
    want = tsq.reference_seq_scan(*args)
    for name, g, w in zip(NAMES, got, want):
        if name in DISCRETE:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)


def test_serving_kernel_path_matches_plain_path(dev):
    N, M, T = 64, 4, 24
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, T, M, device=dev)
    engines = [serving.ServingEngine(cfg, M, Q, R, device=dev,
                                     robot_pose=[0.0, 0.0, 0.0],
                                     seq_kernel=k, grid_kernel=k)
               for k in (None, False)]
    launches = (tgu.fused_grid_update.launches,
                tsq.deferred_seq_scan.launches)
    for t in range(T):
        zs, ids, tw = bigmap.measurements(wl, t)
        for e in engines:
            e.tick(tw, zs, ids=ids)
    assert (tgu.fused_grid_update.launches - launches[0],
            tsq.deferred_seq_scan.launches - launches[1]) == (T, T)
    a, b = engines[0].state, engines[1].state
    assert torch.equal(a.seen, b.seen) and engines[0].n_seen == N
    for k in ("mean_r", "mean_m", "cov_rr", "cov_rm", "cov_mm", "diag4"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0,
                                   atol=1e-5, msg=k)
