"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and ``nvcc`` and skips elsewhere. The
file imports no JAX (the card's machine has none). Run it there with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest``: the suite's conftest configures JAX). Tolerances: the
grid pass's K=2M products are summed in another order than cuBLAS (atol
1e-4 for O(1) operands); the scan and the tick differ from the plain
version by summation order, libm ulps and the row-for-column grid read
(PARITY D13), atol 1e-5 at these small sizes and few ticks; the fused
Kalman update differs from the plain version's two matmuls by the order
of a 2-term sum (atol 1e-5 for O(1) operands), and with ``apply`` false
it is an exact copy.
"""

import numpy as np
import pytest
import torch

from _torch_parity import grid_operands, scan_inputs, unknown_scan_inputs
from shermbot_navigation_tpu_torch.models import ekf_slam
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops.kernels import cov_update as tcu
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


@pytest.mark.parametrize("D", [128, 384])
def test_cov_update_kernel_matches_plain(dev, D):
    rng = np.random.default_rng(D)
    a = rng.normal(size=(D, D)).astype(np.float32)
    ops = [torch.from_numpy(x).to(dev) for x in (
        a @ a.T / D, rng.normal(size=(D, 2)).astype(np.float32),
        np.array([[2.0, -0.3], [-0.3, 1.5]], np.float32),
        rng.normal(size=2).astype(np.float32),
        rng.normal(size=D).astype(np.float32))]
    for flag in (None, True, False):
        apply = None if flag is None else torch.tensor(flag, device=dev)
        before = tcu.fused_kalman_update.launches
        cov, mean = tcu.fused_kalman_update(*ops, apply=apply)
        torch.cuda.synchronize()
        assert tcu.fused_kalman_update.launches == before + 1
        want = tcu.reference_kalman_update(*ops, apply=apply)
        if flag is False:
            assert torch.equal(cov, ops[0]) and torch.equal(mean, ops[4])
        torch.testing.assert_close(cov, want[0], rtol=0, atol=1e-5)
        torch.testing.assert_close(mean, want[1], rtol=0, atol=1e-5)


def test_cov_update_kernel_raises_off_its_shapes(dev):
    def ops(D, dtype):
        return [torch.zeros(s, dtype=dtype, device=dev)
                for s in ((D, D), (D, 2), (2, 2), (2,), (D,))]
    with pytest.raises(ValueError, match="D % 128"):
        tcu.fused_kalman_update(*ops(130, torch.float32))
    with pytest.raises(ValueError, match="float32"):
        tcu.fused_kalman_update(*ops(128, torch.float64))


UNKNOWN_PLANS = [
    (False, [("match", 5), ("skip", 9), ("new", 20), ("invalid", 3)]),
    (True, [("match", 7), ("new", 20), ("match", 5), ("new", 30)]),
]


@pytest.mark.parametrize("full,plan", UNKNOWN_PLANS)
def test_unknown_seq_scan_kernel_matches_plain(dev, full, plan):
    """Match, skip, new and invalid; and a full map where a new point
    overflows and the rest of the tick is inert."""
    x = unknown_scan_inputs(64, 4, plan, full=full)
    args = [torch.from_numpy(np.array(v)).to(dev) for v in x.values()]
    args[10] = None                               # no ids
    before = tsq.deferred_seq_scan.launches
    got = tsq.deferred_seq_scan(*args, known=False)
    torch.cuda.synchronize()
    assert tsq.deferred_seq_scan.launches == before + 1
    want = tsq.reference_seq_scan(*args, known=False)
    for name, g, w in zip(NAMES, got, want):
        if name in DISCRETE:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5, msg=name)
    kinds = got[-1].tolist()
    assert kinds == ([1, 0, 2, 0] if not full else [1, 0, 0, 0])


def test_unknown_serving_kernel_path_matches_plain_path(dev):
    N, M, T = 64, 4, 24
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, T, M, device=dev)
    engines = [serving.ServingEngine(cfg, M, Q, R, device=dev, known=False,
                                     robot_pose=[0.0, 0.0, 0.0],
                                     seq_kernel=k, grid_kernel=k)
               for k in (None, False)]
    before = tsq.deferred_seq_scan.launches
    for t in range(T):
        zs, _, tw = bigmap.measurements(wl, t)
        for e in engines:
            e.tick(tw, zs)
        assert torch.equal(engines[0].state.seen, engines[1].state.seen)
    assert tsq.deferred_seq_scan.launches - before == T
    a, b = engines[0].state, engines[1].state
    assert engines[0].n_seen == engines[1].n_seen > N // 2
    for k in ("mean_r", "mean_m", "cov_rr", "cov_rm", "cov_mm", "diag4"):
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0,
                                   atol=1e-5, msg=k)


def test_dense_on_route_matches_off_route(dev):
    """The dense engine through the kernel ('on', padded to 128) against
    the plain downdate ('off', unpadded), 4 known ticks at N=6; the
    kernel launches once per update and the padded tail stays 0."""
    N, M, T, D = 6, 3, 4, 15
    Q = torch.diag(torch.tensor([1e-3] * 3, device=dev))
    R = torch.diag(torch.tensor([1e-3] * 2, device=dev))
    runs = []
    before = tcu.fused_kalman_update.launches
    for cfg in (EKFConfig(num_landmarks=N, pallas_update="off"),
                EKFConfig(num_landmarks=N, pad_state_to=128,
                          pallas_update="on")):
        st = ekf_slam.init(cfg, [0.0, 0.0, 0.0], device=dev)
        r = np.random.default_rng(9)
        for t in range(T):
            tw = torch.tensor(r.uniform(-0.05, 0.05, 3), dtype=torch.float32,
                              device=dev)
            zs = torch.tensor(np.stack([r.uniform(0.3, 1.0, M),
                                        r.uniform(-3, 3, M)], -1),
                              dtype=torch.float32, device=dev)
            ids = torch.tensor([(t + k) % N for k in range(M)], device=dev)
            st = ekf_slam.known_association_step(
                cfg, st, tw, zs, torch.ones(M, dtype=torch.bool, device=dev),
                ids, Q, R)
        runs.append(st)
    torch.cuda.synchronize()
    assert tcu.fused_kalman_update.launches - before == T * M
    a, b = runs
    torch.testing.assert_close(b.mean[:D], a.mean, rtol=0, atol=1e-5)
    torch.testing.assert_close(b.cov[:D, :D], a.cov, rtol=0, atol=1e-4)
    assert not b.cov[D:].any() and not b.mean[D:].any()
