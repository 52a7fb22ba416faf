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
it is an exact copy; the circle moments are sums of <= P products of O(1)
terms taken in another order (rtol 1e-5, atol 1e-5; the count entry is
exact); the circle fit's two entries must give their plain versions'
bits, centre, radius and ok (the plain version's every elementwise
operation is one rounded operation of the kernel, and the CUDA math
library's atan2f, cosf and sinf serve both). At N=2048 and N=8192 the scan
is held to 1e-4 of each output's
scale (the planes' f32 asymmetry, amplified by the gain; ``chip_smoke.py``
states the same bound), discrete outputs exactly; across cluster sizes and
launch plans every output must be bit-equal. The dense engine under
``torch.func.vmap`` and the lanes engine make the same decisions on the
same noise and part by summation order only (poses within 1e-4 over 12
f32 ticks of config 2). A launch for B worlds gives each world the bits of
its own one-world launch (no world reads another's operands), and config
4's sequential tick makes the deferred tick's decisions at B worlds.
Config 4 over 8 map shards in one process never waits for the device,
and an nccl mesh whose two ranks share the card raises.
Config 5's refinement (no kernel) runs on the card by default, equals the
CPU run in f64 within 1e-9, its GN step never waits for the device, and a
checkpoint of it loads back onto the card bit for bit. Kernel 3 for B
worlds (one launch through ``torch.func.vmap``) gives each world the bits
of its own launch; the guarded deferred tick never waits for the device
and equals the unguarded one bit for bit; the staged pipeline on two
streams equals its sequential oracle (poses 1e-6 / 1e-4, as
``tests/test_staged.py``). ``blocked_ekf.init`` allocates the state and
nothing more (peak within 1% of its bytes), and ``lidar20_tuned`` (nearest
association) runs kernel 4 once a tick on both batched engines, which make
the same decisions (poses within 1e-4 over 20 f32 ticks).
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import grid_operands, scan_inputs, unknown_scan_inputs
from shermbot_navigation_tpu_torch.models import ekf_batch, ekf_slam
from shermbot_navigation_tpu_torch.models import pose_graph, schur
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops import circle_fit, landmark_detection
from shermbot_navigation_tpu_torch.ops.clustering import Clusters
from shermbot_navigation_tpu_torch.ops.kernels import circle_fit as cfk
from shermbot_navigation_tpu_torch.ops.kernels import circle_moments as tcm
from shermbot_navigation_tpu_torch.ops.kernels import cov_update as tcu
from shermbot_navigation_tpu_torch.ops.kernels import ekf_tick
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as tgu
from shermbot_navigation_tpu_torch.ops.kernels import perception
from shermbot_navigation_tpu_torch.ops.kernels import plain_versions
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as tsq
from shermbot_navigation_tpu_torch.parallel import bigmap, blocked_ekf
from shermbot_navigation_tpu_torch.parallel import megamap, schur_dist
from shermbot_navigation_tpu_torch.pipeline import driver, serving
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario

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


@pytest.mark.parametrize("Nl,N,M", [(256, 512, 8), (48, 50, 3),
                                    (16, 2048, 8), (200, 1000, 40),
                                    (8192, 8192, 8)])
def test_grid_update_kernel_matches_plain(dev, Nl, N, M):
    """Includes a ragged shape (rows not a multiple of 16, N % 4 != 0), one
    row tile for many blocks, Nl != N with 2M beyond one K-chunk, and
    N=8192."""
    ops = [torch.from_numpy(x).to(dev) for x in
           grid_operands(Nl, N, M, seed=3, dtype=np.float32)]
    want = tgu.reference_grid_update(*ops)
    before = tgu.fused_grid_update.launches
    cov = ops[0].clone()
    got = tgu.fused_grid_update(cov, *ops[1:])
    torch.cuda.synchronize()
    assert got is cov and tgu.fused_grid_update.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_grid_update_launch_plans_agree_bit_for_bit(dev):
    """The walk's length changes no bit of the result (each element is one
    thread's work in one order): the first rows of a grid, passed as a
    grid of their own, take another plan and give the same bits."""
    Nl, N, M = 1024, 2048, 8
    ops = [torch.from_numpy(x).to(dev) for x in
           grid_operands(Nl, N, M, seed=4, dtype=np.float32)]
    cov, a, b, crow, ccol, rowt, colt = ops
    want = tgu.fused_grid_update(cov.clone(), *ops[1:])
    walks = set()
    for nl in (Nl, 256, 40):
        walks.add(tgu.launch_plan(nl, N, M)["rows_per_block"])
        got = tgu.fused_grid_update(
            cov[:, :, :nl].clone(), a[:, :nl].contiguous(), b, crow,
            ccol[:, :, :nl].contiguous(), rowt[:nl].contiguous(), colt)
        assert torch.equal(got, want[:, :, :nl]), nl
    assert walks == {64, 16, 48}
    torch.testing.assert_close(want, tgu.reference_grid_update(*ops),
                               rtol=0, atol=1e-4)


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


def _assert_scan_close(got, want, atol=1e-5):
    for name, g, w in zip(NAMES, got, want):
        if name in DISCRETE:
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=atol, msg=name)


@pytest.mark.parametrize("N,M,ids", [
    (64, 1, [5]), (64, 1, [60]),                   # M=1: an update, an init
    (64, 4, [5, 5, 5, 5]), (64, 4, [60, 60, 60, 60]),   # one slot, M times
    (50, 4, [46, 3, 46, 49]),                      # rows not 16-byte aligned
    (256, 64, [(7 * i) % 256 for i in range(60)] + [230, 3, 230, 256]),
])
def test_seq_scan_kernel_edge_shapes(dev, N, M, ids):
    """M=1 and M=64, a tick whose ids are all one slot (seen: M updates of
    it; unseen: an init, then M-1 updates that replay it), N=50."""
    x = scan_inputs(N, M, ids, [1] * M, ticks=max(24, 2 * N // M))
    args = [torch.from_numpy(np.array(v)).to(dev) for v in x.values()]
    got = tsq.deferred_seq_scan(*args)
    torch.cuda.synchronize()
    want = tsq.reference_seq_scan(*args)
    if M == 64:
        # a chain of 60 updates: kernel and plain version each sit 1.7e-5
        # from the f64 scan on means of 17 m, so the bound is of the scale
        _scale_close(got, want)
    else:
        _assert_scan_close(got, want)
    assert {1, 2} & set(got[-1].tolist())


def _card_scan_args(dev, N, M, ticks):
    """The scan's arguments from the kernel path's state after ``ticks``
    ticks of the sweep (ticks * M slots seen, the rest unseen), with a
    tick of updates, inits, a repeated slot, an out-of-range id and an
    invalid slot; and that state's plan for unknown association."""
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, ticks + 1, M, device=dev)
    eng = serving.ServingEngine(cfg, M, Q, R, device=dev,
                                robot_pose=[0.0, 0.0, 0.0])
    for t in range(ticks):
        zs, ids, tw = bigmap.measurements(wl, t)
        eng.tick(tw, zs, ids=ids)
    st = eng.state
    u = ticks * M                                   # first unseen slot
    ids = torch.tensor(([5, u + 4, 5, u + 4, N + 5, u // 2, u + 5, 7]
                        * M)[:M], dtype=torch.int32, device=dev)
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    valid[-1] = M == 1
    wl = wl._replace(schedule=ids.clamp(0, N - 1)[None].expand(ticks + 1, M))
    zs, _, _ = bigmap.measurements(wl, ticks)
    known = (st.mean_r[0], st.mean_m[0].T.contiguous(), st.cov_rr[0],
             st.cov_rm[0].permute(0, 2, 1).reshape(6, N), st.diag4[0],
             st.seen[0], st.n_seen[0], st.cov_mm[0].reshape(4, N, N), zs,
             valid, ids, R)
    # unknown: exact revisits (f64 geometry) of seen slots, far points
    mr, mm = st.mean_r[0].double(), st.mean_m[0].double()

    def z_at(p):
        d = p - mr[1:]
        b = torch.atan2(d[1], d[0]) - mr[0]
        return torch.stack([torch.hypot(d[0], d[1]),
                            torch.atan2(torch.sin(b), torch.cos(b))])
    plan = ([("hit", 5), ("far", 20), ("hit", u // 2), ("far", 40),
             ("hit", 5), ("hit", u - 1), ("far", 60), ("hit", 9)] * M)[:M]
    zu = torch.stack([z_at(mm[s] + (1000.0 if what == "far" else 0.0))
                      for what, s in plan]).float()
    unknown = known[:8] + (zu, valid, None, R)
    return known, unknown


def _scale_close(got, want, tol=1e-4):
    for name, g, w in zip(NAMES, got, want):
        if name in DISCRETE:
            assert torch.equal(g, w), name
        else:
            bound = tol * max(1.0, float(w.abs().max()))
            torch.testing.assert_close(g, w, rtol=0, atol=bound, msg=name)


@pytest.mark.parametrize("N", [2048, 8192])
def test_seq_scan_kernel_matches_plain_large_map(dev, N):
    """Known and unknown association at N=2048 and N=8192 (a cluster of
    CTAs), kernel against plain; each tick holds updates and inits."""
    known, unknown = _card_scan_args(dev, N, 8, 40)
    for args, kw in ((known, {}), (unknown, {"known": False})):
        got = tsq.deferred_seq_scan(*args, **kw)
        torch.cuda.synchronize()
        _scale_close(got, tsq.reference_seq_scan(*args, **kw))
        assert {1, 2} <= set(got[-1].tolist()), got[-1].tolist()


def test_seq_scan_cluster_sizes_agree_bit_for_bit(dev):
    """Every cluster size that can hold the map gives the same bits, known
    and unknown: all arithmetic is lane-local or replicated and the one
    reduction is an integer minimum."""
    known, unknown = _card_scan_args(dev, 2048, 8, 40)
    for args, kw in ((known, {}), (unknown, {"known": False})):
        outs = {c: tsq.deferred_seq_scan(*args, cluster=c, **kw)
                for c in (1, 2, 4, 8, 16)}
        torch.cuda.synchronize()
        for c, got in outs.items():
            for name, g, w in zip(NAMES, got, outs[1]):
                assert torch.equal(g, w), (c, name)


def test_serving_tick_never_waits_for_the_device(dev):
    """The serving loop (the workload's measurements and the engine's
    tick, known and unknown) makes no synchronizing call -- no copy from a
    host number, no ``.item()`` -- so the host can run ahead of the card:
    PyTorch's sync debug mode raises on any."""
    N, M = 256, 8
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, 16, M, device=dev)
    engines = [serving.ServingEngine(cfg, M, Q, R, device=dev, known=k,
                                     robot_pose=[0.0, 0.0, 0.0])
               for k in (True, False)]
    for e in engines:                       # builds and first launches
        zs, ids, tw = bigmap.measurements(wl, 0)
        e.tick(tw, zs, ids=ids)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            zs, ids, tw = bigmap.measurements(wl, t)
            for e in engines:
                e.tick(tw, zs, ids=ids)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert engines[0].n_seen == 6 * M


def test_serving_kernel_path_matches_plain_path(dev):
    N, M, T = 64, 4, 24
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, T, M, device=dev)
    engines = [serving.ServingEngine(cfg, M, Q, R, device=dev,
                                     robot_pose=[0.0, 0.0, 0.0])
               for _ in range(2)]
    launches = (tgu.fused_grid_update.launches,
                tsq.deferred_seq_scan.launches)
    for t in range(T):
        zs, ids, tw = bigmap.measurements(wl, t)
        engines[0].tick(tw, zs, ids=ids)
        with plain_versions():
            engines[1].tick(tw, zs, ids=ids)
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
                                     robot_pose=[0.0, 0.0, 0.0])
               for _ in range(2)]
    before = tsq.deferred_seq_scan.launches
    for t in range(T):
        zs, _, tw = bigmap.measurements(wl, t)
        engines[0].tick(tw, zs)
        with plain_versions():
            engines[1].tick(tw, zs)
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


@pytest.mark.parametrize("lead,P", [((16,), 64), ((3, 7), 45), ((1,), 1),
                                    ((5,), 200)])
def test_circle_moments_kernel_matches_plain(dev, lead, P):
    """Any C and P (C no multiple of 8, P no multiple of 32, P beyond the
    rows a lane keeps in registers), leading batch dimensions, counts of
    0, 1..3, exactly P and more than P; rows at and past a count hold NaN,
    so only the mask decides."""
    rng = np.random.default_rng(P)
    C = int(np.prod(lead))
    pts = rng.normal(size=(*lead, P, 2)).astype(np.float32)
    cnt = rng.integers(0, P + 1, lead)
    flat = cnt.reshape(-1)
    flat[0 % C], flat[1 % C], flat[2 % C] = P, P + 17, min(P, 2)
    flat[3 % C] = 0
    pts[np.arange(P) >= cnt[..., None]] = np.nan
    pts, cnt = torch.from_numpy(pts).to(dev), torch.from_numpy(cnt).to(dev)
    before = tcm.circle_moments_raw.launches
    got = tcm.circle_moments_raw(pts, cnt)
    torch.cuda.synchronize()
    assert tcm.circle_moments_raw.launches == before + 1
    with plain_versions():
        want = tcm.circle_moments_raw(pts, cnt)
    assert [tuple(g.shape) for g in got] == [(*lead, 16), (*lead, 2), lead]
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0][..., 15], want[0][..., 15])


def test_circle_moments_kernel_raises_on_f64(dev):
    pts = torch.zeros((4, 8, 2), dtype=torch.float64, device=dev)
    cnt = torch.full((4,), 5, device=dev)
    with pytest.raises(ValueError, match="float32"):
        tcm.circle_moments_raw(pts, cnt)
    with pytest.raises(ValueError, match="counts"):
        tcm.circle_moments_raw(pts.float(), cnt.float())


def test_fit_circles_and_buffered_detection_launch_the_kernel(dev):
    """``fit_circles`` on CUDA f32 clusters goes through the whole-fit
    kernel (one launch of ``circle_fit``) and agrees with the plain route:
    ``valid`` equal, centre and radius within 1e-4 (noisy arcs, so the
    moment matrices are well away from the fit's rank-deficiency switch;
    the plain route sums its moments in another order); so does the
    buffered ``detect_landmarks`` on a scan of three tubes, against the
    segmented one, whose fit is one launch of the tail kernel."""
    rng = np.random.default_rng(2)
    C, P = 12, 64
    cnt = rng.integers(0, 40, C)
    cnt[:3] = [3, 4, 70]
    arc = rng.uniform(0.0, np.pi, (C, P))
    pts = np.stack([0.5 + 0.04 * np.cos(arc), 0.3 + 0.04 * np.sin(arc)], -1)
    pts += rng.normal(scale=1e-3, size=pts.shape)
    cl = Clusters(points=torch.from_numpy(pts.astype(np.float32)).to(dev),
                  counts=torch.from_numpy(cnt.astype(np.int32)).to(dev),
                  valid=torch.from_numpy(cnt >= 3).to(dev))
    before = cfk.circle_fit_raw.launches
    got = circle_fit.fit_circles(cl)
    assert cfk.circle_fit_raw.launches == before + 1
    with plain_versions():
        want = circle_fit.fit_circles(cl)
    assert torch.equal(got.valid, want.valid) and bool(got.valid.any())
    ok = got.valid
    torch.testing.assert_close(got.center[ok], want.center[ok], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got.radius[ok], want.radius[ok], rtol=0,
                               atol=1e-4)

    ang = np.deg2rad(np.arange(360.0))
    ranges = np.full((2, 360), 2.0)
    for cx, cy in ((0.6, 0.0), (0.0, 0.5), (-0.4, -0.4)):
        b = cx * np.cos(ang) + cy * np.sin(ang)
        disc = b * b - (cx * cx + cy * cy - 0.0381 ** 2)
        hit = (disc > 0) & (b > 0)
        t = np.where(hit, b - np.sqrt(np.maximum(disc, 0.0)), 2.0)
        ranges = np.minimum(ranges, t)
    ranges += rng.normal(scale=2e-4, size=ranges.shape) * (ranges < 1.5)
    scan = torch.from_numpy(ranges.astype(np.float32)).to(dev)
    before = cfk.circle_fit_raw.launches, cfk.fit_tail.launches
    buf = landmark_detection.detect_landmarks(scan, 0.05, 1.0,
                                              segmented=False)
    seg = landmark_detection.detect_landmarks(scan, 0.05, 1.0)
    assert (cfk.circle_fit_raw.launches, cfk.fit_tail.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(buf.valid, seg.valid)
    assert buf.valid.sum(-1).tolist() == [3, 3]
    torch.testing.assert_close(buf.positions[buf.valid],
                               seg.positions[seg.valid], rtol=0, atol=1e-3)


def _fit_inputs(dev, lead, P, seed):
    """Clusters for the fit kernels: tube-sized arcs, every third one
    noise-free (its moment matrix singular up to rounding: the rank
    switch), counts 0, 1..3, exactly P and above P, NaN at and past each
    count; ``valid`` false on a tenth of the slots."""
    rng = np.random.default_rng(seed)
    C = int(np.prod(lead))
    th = rng.uniform(0.0, 2.0, (C, P))
    ctr = rng.uniform(-1.0, 1.0, (C, 1, 2))
    pts = ctr + 0.0381 * np.stack([np.cos(th), np.sin(th)], -1)
    pts[np.arange(C) % 3 != 0] += rng.normal(scale=1e-3, size=(P, 2))
    cnt = rng.integers(4, P + 1, C)
    cnt[:6] = [0, 1, 2, 3, P, P + 17]
    pts[np.arange(P)[None, :] >= cnt[:, None]] = np.nan
    valid = (cnt >= 3) & (rng.uniform(size=C) > 0.1)
    to = lambda a, t: torch.from_numpy(a.astype(t)).reshape(
        *lead, *a.shape[1:]).to(dev)
    return to(pts, np.float32), to(cnt, np.int32), to(valid, bool)


def same_bits(g, w):
    """Elementwise: equal bit for bit (any NaN equals any NaN)."""
    if not g.is_floating_point():
        return g == w
    return (g.view(torch.int32) == w.view(torch.int32)) | (
        torch.isnan(g) & torch.isnan(w))


def _first_difference(got, want):
    """None when the fits ``(center, radius, ok)`` are equal bit for bit,
    else a message naming the first differing cluster."""
    C = got[2].numel()
    for name, g, w in zip(("center", "radius", "ok"), got, want):
        same = same_bits(g, w).reshape(C, -1).all(-1)
        if not bool(same.all()):
            i = int(torch.nonzero(~same)[0])
            return f"{name} differs first at cluster {i}"
    return None


@pytest.mark.parametrize("lead,P", [((7, 143), 45), ((64, 16), 64)])
def test_circle_fit_kernel_is_bit_equal_to_plain(dev, lead, P):
    """``circle_fit`` (one launch): its moments within the moment kernel's
    bounds of the plain version's and equal to the moment-only entry's;
    centre, radius and ok equal bit for bit to the plain chain on its own
    moments, and so to the route of the moment-only kernel and the plain
    chain."""
    pts, cnt, valid = _fit_inputs(dev, lead, P, 11)
    before = cfk.circle_fit_raw.launches
    got = cfk.circle_fit_raw(pts, cnt, valid)
    torch.cuda.synchronize()
    assert cfk.circle_fit_raw.launches == before + 1
    assert [tuple(g.shape) for g in got] == [
        (*lead, 2), lead, lead, (*lead, 16), (*lead, 2), lead]
    mom = tcm.circle_moments_raw(pts, cnt)
    for g, w in zip(got[3:], mom):
        assert torch.equal(g, w)
    with plain_versions():
        plain = tcm.circle_moments_raw(pts, cnt)
    for g, w in zip(got[3:], plain):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    m16, cent, zbar = got[3:]
    want = cfk._fit_tail_c([m16[..., k] for k in range(16)], cent[..., 0],
                           cent[..., 1], zbar, cnt, valid)
    assert _first_difference(got[:3], want) is None
    assert bool(got[2].any())


def test_fit_tail_kernel_is_bit_equal_to_plain(dev):
    """``circle_fit_tail`` on the segmented path's own moments (config 3's
    scans, 64 worlds x 16 slots, the 10 distinct sums read in place at
    their row stride) and on 16-wide rows: centre, radius and ok equal bit
    for bit to the plain chain; the segmented detections equal those of
    the plain route, and bit for bit the plain tail's on the front-end
    kernel's fit inputs."""
    scn = get_scenario("lidar20_full")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    last = {}
    driver.run_scenario_batch_lanes(
        scn, gen, 64, steps=12, device=dev,
        on_tick=lambda t, obs, zs, valid: last.update(scan=obs.scan))
    params = scn.world_params(device=dev)
    mom, cx, cy, zbar, cnt, valid, _ = landmark_detection._segment_fit_inputs(
        last["scan"], params.scan_min, params.scan_max, 16, 64)
    assert tuple(mom.shape) == (64, 16, 10) and not mom.is_contiguous()
    before = cfk.fit_tail.launches
    got = cfk.fit_tail(mom, cx, cy, zbar, cnt, valid)
    torch.cuda.synchronize()
    assert cfk.fit_tail.launches == before + 1
    want = cfk._fit_tail_c(cfk.components(mom), cx, cy, zbar, cnt, valid)
    assert _first_difference(got, want) is None and bool(got[2].any())
    wide = torch.stack(cfk.components(mom), -1)
    assert _first_difference(cfk.fit_tail(wide, cx, cy, zbar, cnt, valid),
                             want) is None
    a = landmark_detection.detect_landmarks(last["scan"], params.scan_min,
                                            params.scan_max)
    with plain_versions():
        b = landmark_detection.detect_landmarks(
            last["scan"], params.scan_min, params.scan_max)
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.positions, b.positions)
    front = perception.fit_inputs(last["scan"], params.scan_min,
                                  params.scan_max, 16, 64)
    center, radius, okf = cfk._fit_tail_c(cfk.components(front[0]),
                                          *front[1:6])
    c = landmark_detection._compact(center, front[6] & okf & (radius <= 1.0))
    assert torch.equal(a.valid, c.valid)
    assert torch.equal(a.positions, c.positions)


def test_circle_fit_trace_equals_the_plain_trace(dev):
    """The trace entry's 369 intermediates of a cluster's tail equal the
    plain version's on the card, for a noisy arc and an exact one."""
    pts, cnt, valid = _fit_inputs(dev, (8,), 64, 12)
    _, _, _, m16, cent, zbar = cfk.circle_fit_raw(pts, cnt, valid)
    for c in (6, 7):
        trace = []
        cfk._fit_tail_c([m16[c:c + 1, k] for k in range(16)],
                        cent[c:c + 1, 0], cent[c:c + 1, 1], zbar[c:c + 1],
                        cnt[c:c + 1], valid[c:c + 1], trace=trace)
        plain = torch.cat([v.reshape(1) for _, v in trace])
        got = cfk.trace(m16[c], cent[c, 0], cent[c, 1], zbar[c],
                        bool(valid[c]) and int(cnt[c]) >= 4)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), cfk.trace_names()[int(
            torch.nonzero(got != plain)[0])]


def test_circle_fit_kernels_raise_on_f64(dev):
    pts = torch.zeros((4, 8, 2), dtype=torch.float64, device=dev)
    cnt = torch.full((4,), 5, device=dev)
    valid = torch.ones(4, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cfk.circle_fit_raw(pts, cnt, valid)
    with pytest.raises(ValueError, match="float32"):
        cfk.fit_tail(torch.zeros((4, 16), dtype=torch.float64, device=dev),
                     *(torch.zeros(4, device=dev),) * 3, cnt, valid)
    with pytest.raises(ValueError, match="valid"):
        cfk.circle_fit_raw(pts.float(), cnt, valid.float())


def test_default_device_runs_a_tick_on_the_card(dev):
    """The repaired fault: naming no device (or a bare "cuda") means
    ``cuda:<current>``, so the serving engine, ``run_bigmap`` and the lanes
    driver with a "cuda" generator each run on the card."""
    cfg = EKFConfig(num_landmarks=64)
    Q, R = bigmap.noise()
    eng = serving.ServingEngine(cfg, 8, Q, R)
    assert eng.device == torch.device("cuda", torch.cuda.current_device())
    eng.tick([0.0, 0.1, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    assert eng.n_seen == 2 and eng.state.cov_mm.is_cuda
    st, _ = bigmap.run_bigmap(N=64, T=2, M=8)
    assert int(st.n_seen[0]) == 16 and st.mean_r.is_cuda
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    outs = driver.run_scenario_batch_lanes(get_scenario("lidar20_full"), gen,
                                           2, steps=2)
    assert outs.slam_pose.is_cuda and bool(torch.isfinite(
        outs.slam_pose).all())


def test_dense_batch_driver_and_bench_entry_default_to_the_card(dev, capsys):
    """``run_scenario_batch`` and the bench entry with no device run on
    ``cuda:<current>``; the dense engine under ``torch.func.vmap`` equals
    the lanes engine there on the same noise."""
    from shermbot_navigation_tpu_torch import bench
    scn = get_scenario("course12_noisy")
    here = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    seq = driver.tw.TickNoise(*(torch.stack(f) for f in zip(*(
        driver.draw_noise(scn, gen, (4,)) for _ in range(12)))))
    dense = driver.run_scenario_batch(scn, seq, 4, steps=12)
    lanes = driver.run_scenario_batch_lanes(scn, seq, 4, steps=12)
    assert dense.slam_pose.device == here
    assert torch.equal(dense.n_seen, lanes.n_seen)
    assert float((dense.slam_pose - lanes.slam_pose).abs().max()) < 1e-4
    assert bench.main(["--batch", "4", "--steps", "3", "--cpp-runs", "1",
                       "--engine", "vmapped"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["device"].startswith(torch.cuda.get_device_name(here))
    assert row["execution"] == "eager" and row["value"] > 0


def _worlds(args_list):
    """One-world argument lists (``R`` last, shared) as one list of B
    worlds."""
    cols = list(zip(*(a[:-1] for a in args_list)))
    return [None if c[0] is None else torch.stack(c) for c in cols] + [
        args_list[0][-1]]


def _scan_worlds(dev, N):
    """Three worlds that differ for each association (states after other
    numbers of ticks, other ids, measurements and validity)."""
    to = lambda x: [torch.from_numpy(np.array(v)).to(dev) for v in x.values()]
    if N == 2048:
        both = [_card_scan_args(dev, N, 8, t) for t in (36, 40, 44)]
        return [b[0] for b in both], [list(b[1]) for b in both]
    known = [to(scan_inputs(N, 4, ids, valid, ticks=t)) for ids, valid, t in
             (([60, 5, 60, 3], [1, 1, 1, 1], 24),
              ([64, 61, -1, 7], [1, 1, 1, 0], 26),
              ([2, 2, 9, 57], [1, 0, 1, 1], 30))]
    unknown = []
    for full, plan in UNKNOWN_PLANS + [
            (False, [("new", 11), ("match", 2), ("invalid", 0),
                     ("skip", 4)])]:
        args = to(unknown_scan_inputs(N, 4, plan, full=full))
        args[10] = None
        unknown.append(args)
    return known, unknown


@pytest.mark.parametrize("N", [64, 2048])
def test_seq_scan_batched_worlds_equal_their_own_launches(dev, N):
    """One launch for three worlds that differ: each world's twelve
    outputs are bit-equal to its own one-world launch (a cluster a world,
    none reads another's operands), and held to the plain version as the
    one-world scan is."""
    known, unknown = _scan_worlds(dev, N)
    for worlds, kw in ((known, {}), (unknown, {"known": False})):
        before = tsq.deferred_seq_scan.launches
        got = tsq.deferred_seq_scan(*_worlds(worlds), **kw)
        torch.cuda.synchronize()
        assert tsq.deferred_seq_scan.launches == before + 1
        with plain_versions():
            want = tsq.deferred_seq_scan(*_worlds(worlds), **kw)
        for b, args in enumerate(worlds):
            alone = tsq.deferred_seq_scan(*args, **kw)
            for name, g, w in zip(NAMES, got, alone):
                assert torch.equal(g[b], w), (b, name)
            close = _scale_close if N == 2048 else _assert_scan_close
            close([x[b] for x in got], [x[b] for x in want])
        slots = {tuple(g) for g in got[-2].tolist()}
        assert len(slots) > 1, slots


@pytest.mark.parametrize("Nl,N,M", [(256, 512, 8), (48, 50, 3)])
def test_grid_update_batched_worlds_equal_their_own_launches(dev, Nl, N, M):
    """One launch for three worlds of other operands (a ragged shape
    too): each world bit-equal to its own launch, all within the plain
    version's tolerance."""
    worlds = [[torch.from_numpy(x).to(dev) for x in
               grid_operands(Nl, N, M, seed=s, dtype=np.float32)]
              for s in (3, 4, 5)]
    ops = [torch.stack(c) for c in zip(*worlds)]
    before = tgu.fused_grid_update.launches
    got = tgu.fused_grid_update(ops[0].clone(), *ops[1:])
    torch.cuda.synchronize()
    assert tgu.fused_grid_update.launches == before + 1
    torch.testing.assert_close(got, tgu.reference_grid_update(*ops), rtol=0,
                               atol=1e-4)
    for b, w in enumerate(worlds):
        assert torch.equal(got[b], tgu.fused_grid_update(w[0].clone(),
                                                         *w[1:])), b


def test_one_world_launch_is_a_batch_of_one(dev):
    """The one-world forms of both kernels launch what a batch of one
    launches, bit for bit."""
    g = [torch.from_numpy(x).to(dev) for x in
         grid_operands(256, 512, 8, seed=6, dtype=np.float32)]
    one = tgu.fused_grid_update(g[0].clone(), *g[1:])
    batch = tgu.fused_grid_update(g[0][None].clone(), *(x[None] for x in g[1:]))
    assert torch.equal(one, batch[0])
    known, unknown = _scan_worlds(dev, 64)
    for args, kw in ((known[0], {}), (unknown[0], {"known": False})):
        one = tsq.deferred_seq_scan(*args, **kw)
        batch = tsq.deferred_seq_scan(*_worlds([args]), **kw)
        for name, a, b in zip(NAMES, one, batch):
            assert a.shape == b.shape[1:] and torch.equal(a, b[0]), name


def test_bigmap_worlds_on_the_card(dev):
    """``run_bigmap(batch=3)`` through the kernels: every world bit-equal
    to ``run_bigmap(batch=1)``, each kernel launched once a tick; and the
    sequential tick at batch 3 makes the deferred tick's decisions, known
    and unknown, the state within f32 summation-order distance (the CPU
    f32 runs at this size part by <= 1.2e-7 m on the means and 5e-7 on the
    grid; bounds 1e-5 and 1e-5 of scale)."""
    N, T, M = 256, 40, 8
    one, _ = bigmap.run_bigmap(N=N, T=T, M=M, device=dev)
    g0, s0 = tgu.fused_grid_update.launches, tsq.deferred_seq_scan.launches
    three, _ = bigmap.run_bigmap(N=N, T=T, M=M, batch=3, device=dev)
    torch.cuda.synchronize()
    assert tgu.fused_grid_update.launches - g0 == T
    assert tsq.deferred_seq_scan.launches - s0 == T
    for f in one._fields:
        for b in range(3):
            assert torch.equal(getattr(three, f)[b], getattr(one, f)[0]), f
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, device=dev)
    Q, R = bigmap.noise(device=dev)
    for make in (bigmap.make_runner, bigmap.make_unknown_runner):
        a, b = (make(cfg, M, dev, batch=3, deferred=d)(
            blocked_ekf.init(cfg, 3, device=dev), wl, Q, R, 0, T)
            for d in (True, False))
        assert torch.equal(a.n_seen, b.n_seen) and torch.equal(a.seen, b.seen)
        for f in ("mean_r", "mean_m", "cov_rr", "cov_rm"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                       atol=1e-5, msg=f)
        seen = a.seen[0]
        for f, x, y in (("diag4", a.diag4[:, :, seen], b.diag4[:, :, seen]),
                        ("cov_mm", a.cov_mm[:, :, :, seen][..., seen],
                         b.cov_mm[:, :, :, seen][..., seen])):
            bound = 1e-5 * max(1.0, float(y.abs().max()))
            torch.testing.assert_close(x, y, rtol=0, atol=bound, msg=f)


def test_seq_scan_occupancy_query(dev):
    """The card's answer to how many scan clusters fit at once, which
    ``launch_plan`` reads at B > 1: at least one for every cluster size
    that holds the map, and more for one CTA a world than for eight."""
    fits = [tsq.max_active_clusters(tsq.launch_plan(2048, 8, cluster=c), 8)
            for c in (8, 4, 2, 1)]
    assert min(fits) >= 1 and fits[-1] > fits[0], fits


def _megamap_stage2(N, T, obs, n_shards, dev, **kw):
    """(partitioned problem on ``dev``, sharded step) of config 5 after the
    host loop closure."""
    prob = megamap.synthesize(N, T, obs)
    g = pose_graph.optimize_host(prob.graph, iters=3)
    part = schur_dist.partition_problem(prob.bundle._replace(poses=g.poses),
                                        n_shards)
    step = schur_dist.make_sharded_gn(n_shards, T=T, N=N,
                                      M=part.obs_t.shape[0], device=dev,
                                      **kw)
    return schur.BundleProblem(*(x.to(dev) for x in part)), step


def test_schur_gn_step_never_waits_for_the_device(dev):
    """Config 5's stage 2: one GN step, its 16 CG iterations and the
    gauge projection, under PyTorch's sync debug mode: no value goes back
    to the host inside the step."""
    part, step = _megamap_stage2(256, 48, 6, 2, dev, cg_iters=16)
    warm = step(part)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(part)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out.poses.is_cuda and bool(torch.isfinite(out.landmarks).all())
    torch.testing.assert_close(out.poses, warm.poses, rtol=0, atol=1e-4)
    assert torch.equal(out.poses[0], part.poses[0])


def test_run_megamap_defaults_to_the_card(dev):
    """``run_megamap()`` with no device runs stage 2 on ``cuda:<current>``;
    in f64 it equals the CPU run within 1e-9 (the scatter-adds' atomics
    change only the summation order)."""
    here = torch.device("cuda", torch.cuda.current_device())
    kw = dict(N=64, T=24, obs_per_pose=4, mesh=4, dtype=torch.float64)
    _, out = megamap.run_megamap(**kw)
    assert out.poses.device == here and out.landmarks.device == here
    _, cpu = megamap.run_megamap(device="cpu", **kw)
    for k in ("poses", "landmarks"):
        torch.testing.assert_close(getattr(out, k).cpu(), getattr(cpu, k),
                                   rtol=0, atol=1e-9, msg=k)


def test_refinement_checkpoint_loads_onto_the_card(dev, tmp_path):
    """``checkpoint.load`` puts every leaf on its template leaf's device:
    a refined bundle saved from the card comes back there with its bits,
    and the step goes on from it."""
    from shermbot_navigation_tpu_torch.pipeline import checkpoint
    part, step = _megamap_stage2(256, 48, 6, 2, dev, cg_iters=16)
    half = step(part)
    path = str(tmp_path / "bundle.npz")
    checkpoint.save(path, half, step=1)
    restored, saved = checkpoint.load(path, half)
    assert saved == 1
    for a, b in zip(restored, half):
        assert a.device == b.device and torch.equal(a, b)
    assert bool(torch.isfinite(step(restored).poses).all())


def test_sharded_deferred_tick_never_waits_for_the_device(dev):
    """Config 4 over 8 map shards in one process (the plain sharded scan,
    kernel 1 once a tick for every shard's planes), known and unknown:
    no synchronizing call, so the host runs ahead of the card (PyTorch's
    sync debug mode raises on any)."""
    from shermbot_navigation_tpu_torch.parallel import mesh as mesh_lib
    N, M = 256, 8
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, 16, M, device=dev)
    mesh = mesh_lib.make_mesh(map_=8, local_shards=8, device=dev)
    valid = torch.ones((1, M), dtype=torch.bool, device=dev)
    ticks = {k: blocked_ekf.make_deferred_step(cfg, M, dev, known=k,
                                               mesh=mesh)
             for k in (True, False)}
    states = {k: blocked_ekf.shard_state(blocked_ekf.init(cfg, 1, device=dev),
                                         mesh) for k in ticks}

    def tick(t):
        zs, ids, tw = bigmap.measurements(wl, t)
        for k, step in ticks.items():
            states[k] = step(states[k], tw[None], zs[None], valid,
                             *((ids[None],) if k else ()), Q, R)

    before = tgu.fused_grid_update.launches
    tick(0)                                   # builds and first launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            tick(t)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert tgu.fused_grid_update.launches - before == 12
    assert int(states[True].n_seen[0, 0]) == 6 * M


def _nccl_mesh(rank):
    from shermbot_navigation_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.make_mesh(map_=2, local_shards=1, device="cuda:0")


def test_nccl_with_two_ranks_on_one_card_raises(dev):
    """NCCL cannot put two ranks on one device: ``make_mesh`` under an nccl
    cluster whose two ranks share ``cuda:0`` raises, before any NCCL
    collective (two ranks on one card take gloo)."""
    from shermbot_navigation_tpu_torch.parallel import mesh as mesh_lib
    with pytest.raises(RuntimeError, match="nccl needs a card of its own"):
        mesh_lib.run_cluster(_nccl_mesh, 2, backend="nccl", timeout=120)


def test_cov_update_batched_launch_equals_single_launches(dev):
    """Kernel 3 for B worlds in one launch, reached through
    ``torch.func.vmap`` of the one-world wrapper: each world gets the bits
    of its own one-world launch (its flag included), one launch for all;
    and the dense engine with ``'on'`` under vmap launches once an update
    for the B worlds."""
    Bw, D = 5, 384
    rng = np.random.default_rng(21)
    a = rng.normal(size=(Bw, D, D)).astype(np.float32)
    ops = [torch.from_numpy(x).to(dev) for x in (
        a @ a.transpose(0, 2, 1) / D,
        rng.normal(size=(Bw, D, 2)).astype(np.float32),
        np.tile(np.array([[2.0, -0.3], [-0.3, 1.5]], np.float32), (Bw, 1, 1)),
        rng.normal(size=(Bw, 2)).astype(np.float32),
        rng.normal(size=(Bw, D)).astype(np.float32))]
    apply = torch.tensor([True, False, True, True, False], device=dev)
    before = tcu.fused_kalman_update.launches
    cov, mean = torch.func.vmap(tcu.fused_kalman_update)(*ops, apply)
    torch.cuda.synchronize()
    assert tcu.fused_kalman_update.launches == before + 1
    for b in range(Bw):
        c1, m1 = tcu.fused_kalman_update(*(x[b] for x in ops), apply[b])
        assert torch.equal(cov[b], c1) and torch.equal(mean[b], m1), b
    want = tcu.reference_kalman_update(*ops, apply=apply)
    torch.testing.assert_close(cov, want[0], rtol=0, atol=1e-5)
    torch.testing.assert_close(mean, want[1], rtol=0, atol=1e-5)

    cfg = ekf_slam.EKFConfig(num_landmarks=6, pad_state_to=128,
                             pallas_update="on")
    one = ekf_slam.init(cfg, [0.0, 0.0, 0.0], device=dev)
    st = ekf_slam.EKFState(*(f.expand(Bw, *f.shape).clone() for f in one))
    zs = torch.tensor([[0.8, 0.2], [0.9, -1.0], [0.5, 2.0]], device=dev)
    step = torch.func.vmap(lambda s, tw: ekf_slam.known_association_step(
        cfg, s, tw, zs, torch.ones(3, dtype=torch.bool, device=dev),
        torch.arange(3, dtype=torch.int32, device=dev),
        torch.eye(3, device=dev) * 1e-3, torch.eye(2, device=dev) * 1e-3))
    before = tcu.fused_kalman_update.launches
    st = step(st, torch.full((Bw, 3), 0.01, device=dev))
    torch.cuda.synchronize()
    assert tcu.fused_kalman_update.launches - before == 3
    assert st.mean.shape == (Bw, 128) and bool(torch.isfinite(st.cov).all())


def test_guarded_tick_never_waits_for_the_device(dev):
    """``guards.checked_blocked_tick`` around the deferred tick (kernels 1
    and 2): no synchronizing call in five guarded ticks (PyTorch's sync
    debug mode raises on any), the state equal to the unguarded tick's,
    and only ``err.throw()`` reads the record."""
    from shermbot_navigation_tpu_torch.utils import guards
    N, M = 256, 8
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, 16, M, device=dev)
    valid = torch.ones((1, M), dtype=torch.bool, device=dev)
    step = blocked_ekf.make_deferred_step(cfg, M, dev)
    tick = guards.checked_blocked_tick(step)
    plain = guarded = blocked_ekf.init(cfg, 1, device=dev)
    plain = blocked_ekf.BlockedState(*(x.clone() for x in plain))

    def args(t):
        zs, ids, tw = bigmap.measurements(wl, t)
        return tw[None], zs[None], valid, ids[None], Q, R

    err, guarded = tick(guarded, *args(0))          # builds and launches
    plain = step(plain, *args(0))
    torch.cuda.synchronize()
    errs = [err]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(1, 6):
            err, guarded = tick(guarded, *args(t))
            errs.append(err)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for t in range(1, 6):
        plain = step(plain, *args(t))
    torch.cuda.synchronize()
    for e in errs:
        e.throw()
    for f in blocked_ekf.BlockedState._fields:
        assert torch.equal(getattr(guarded, f), getattr(plain, f)), f


def test_staged_rollout_on_two_streams_equals_its_oracle(dev):
    """``lidar20_full`` staged on two streams of the card against the
    sequential oracle on one: the same draws from one seed, equal
    ``n_seen`` every tick, poses within ``tests/test_staged.py``'s 1e-6 /
    1e-4; kernel 4's tail launched once a tick."""
    from shermbot_navigation_tpu_torch.pipeline import staged
    scn = get_scenario("lidar20_full")
    T = 12

    def gen():
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        return g

    before = cfk.fit_tail.launches
    got = staged.make_staged_rollout(scn)(gen(), T)
    torch.cuda.synchronize()
    assert cfk.fit_tail.launches - before == T
    ref = staged.staged_reference(scn, gen(), T)
    assert torch.equal(got.n_seen, ref.n_seen)
    torch.testing.assert_close(got.true_pose, ref.true_pose, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got.odom_pose, ref.odom_pose, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(got.slam_pose, ref.slam_pose, rtol=0,
                               atol=1e-4)


def test_init_peak_memory_is_the_state(dev):
    """``blocked_ekf.init`` at N=8192 (planes of 1.07 GB) peaks at the
    state's own bytes: no ``eye(N)``, broadcast product or copy of the
    planes on the way (at N=65536 those would not fit on an 80 GB card)."""
    cfg = EKFConfig(num_landmarks=8192)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    st = blocked_ekf.init(cfg, 1, robot_pose=[0.0, 0.0, 0.0], device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    state_bytes = sum(x.untyped_storage().nbytes() for x in st)
    assert state_bytes >= 16 * 8192 ** 2
    assert peak <= 1.01 * state_bytes, (peak, state_bytes)
    prior = torch.tensor(cfg.init_cov, dtype=torch.float32)
    assert torch.equal(st.cov_mm[0, 1, 1, 8191, 8191].cpu(), prior)


def test_lidar20_tuned_runs_kernel_4_on_both_engines(dev):
    """Config 3's quality mode (``lidar20_tuned``: nearest association,
    chi-square gates, wrapped innovations, multiplicative slip) on the
    lanes engine and under ``torch.func.vmap``, on the same noise: the
    segmented perception launches the fit kernel once a tick on each, the
    two make the same decisions and their poses agree within 1e-4."""
    scn = get_scenario("lidar20_tuned")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    B, T = 4, 20
    seq = [driver.draw_noise(scn, gen, (B,)) for _ in range(T)]
    noise = type(seq[0])(*(torch.stack(f) for f in zip(*seq)))
    outs = {}
    for name, run in (("lanes", driver.run_scenario_batch_lanes),
                      ("vmapped", driver.run_scenario_batch)):
        cfk.fit_tail.launches = 0
        outs[name] = run(scn, noise, B, steps=T, device=dev)
        assert cfk.fit_tail.launches == T, name
        assert bool(torch.isfinite(outs[name].slam_pose).all()), name
    assert torch.equal(outs["lanes"].n_seen, outs["vmapped"].n_seen)
    assert int(outs["lanes"].n_seen[:, -1].min()) >= 5
    err = float((outs["lanes"].slam_pose - outs["vmapped"].slam_pose).abs()
                .max())
    assert err <= 1e-4, err


def _launches():
    """Every kernel wrapper's launch counter."""
    return (tgu.fused_grid_update.launches, tsq.deferred_seq_scan.launches,
            tcu.fused_kalman_update.launches,
            tcm.circle_moments_raw.launches, cfk.circle_fit_raw.launches,
            cfk.fit_tail.launches, perception.fit_inputs.launches,
            ekf_tick.step.launches)


def _call_every_wrapper(dev):
    """Each kernel wrapper once, on small operands on the card."""
    ops = [torch.from_numpy(x).to(dev) for x in
           grid_operands(48, 50, 3, seed=3, dtype=np.float32)]
    tgu.fused_grid_update(ops[0].clone(), *ops[1:])
    x = scan_inputs(64, 4, [60, 5, 60, 3], [1, 1, 1, 1])
    tsq.deferred_seq_scan(*(torch.from_numpy(np.array(v)).to(dev)
                            for v in x.values()))
    D = 128
    tcu.fused_kalman_update(
        torch.eye(D, device=dev), torch.ones((D, 2), device=dev),
        torch.eye(2, device=dev), torch.ones(2, device=dev),
        torch.zeros(D, device=dev))
    pts, cnt, valid = _fit_inputs(dev, (8,), 16, 5)
    tcm.circle_moments_raw(pts, cnt)
    m16, cent, zbar = cfk.circle_fit_raw(pts, cnt, valid)[3:]
    cfk.fit_tail(m16, cent[..., 0], cent[..., 1], zbar, cnt, valid)
    perception.fit_inputs(torch.full((2, 360), 0.5, device=dev), 0.05, 1.0,
                          16, 64)
    scn = get_scenario("lidar20_full")
    cfg = scn.ekf_config()
    Q, R = scn.noise_matrices(torch.float32, dev)
    ekf_tick.step(cfg, ekf_batch.init(cfg, 2, device=dev),
                  torch.zeros((2, 3), device=dev),
                  torch.ones((2, 16, 2), device=dev),
                  torch.ones((2, 16), dtype=torch.bool, device=dev), Q, R)
    torch.cuda.synchronize()


def test_plain_versions_switch_launches_nothing_and_restores(dev):
    """Inside ``plain_versions()`` every wrapper runs its plain version on
    card tensors: no launch counter moves. After it, and after an
    exception raised inside it, every wrapper launches its kernel again."""
    before = _launches()
    with plain_versions():
        _call_every_wrapper(dev)
    assert _launches() == before
    _call_every_wrapper(dev)
    after = _launches()
    assert all(a == b + 1 for a, b in zip(after, before)), (after, before)
    with pytest.raises(RuntimeError, match="inside"):
        with plain_versions():
            _call_every_wrapper(dev)
            raise RuntimeError("inside")
    assert _launches() == after
    _call_every_wrapper(dev)
    assert all(a == b + 1 for a, b in zip(_launches(), after))
