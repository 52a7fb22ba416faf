"""The segmented perception path's front end in one kernel
(``ops/kernels/perception``, ``csrc/perception.cu``) against its plain
version, ``clustering._segment_fit_inputs``.

The CPU tests (tier 1) hold the wrapper's plain route to the plain version
bit for bit, the pure launch plan and what the wrapper refuses. The card
tests (marked ``requires_cuda``; they skip elsewhere) hold the kernel to
the plain version on the card. The file imports no JAX; on the card run

    python -m pytest tests/test_torch_perception_kernel.py -q --noconftest

Tolerances of the card tests. Per ray the kernel repeats the plain
version's operations one rounding at a time (the CUDA math library's
cosf, sinf and atan2f serve both), and it adds each slot's rows one after
another in ray order. So against the plain version whose one-hot products
are summed in ray order (``_sequential_matmul``: the same additions, an
order only) every output is bit for bit the same. Against the plain
version as it runs, on cuBLAS's products (which mostly sum in ray order
too, but not always: on config 3's scans at B = 1024, 0.42% of the
slots' moments differ), ``count``, ``valid`` and the stored
rows (the moments' n column) exactly; ``is_circle`` exactly for every
slot whose deviation lies farther than STD_MARGIN degrees from the
threshold (the plain version decides the same at the threshold +-
STD_MARGIN); the sums within float32's bound for a sum of another order:
two float32 sums of the same m terms differ by at most 2 (m - 1) u sum
|term| (u = 2^-24), and the centroid, itself such a sum over m, moves a
moment of degree d by up to sqrt(2) d m rho^(d-1) its difference. So the
moments are held to 2 m^2 u rho^(d-1) (rho + 2 d A) (m rows within rho of
the centroid and A of the origin), cx and cy to 2 (m + 1) u A, zbar to
the z moment's bound over m. Final detections: ``valid`` equal, positions
within 1e-5 m; on the noise-free scans of the lidar scenarios all but
FIT_SWITCH_SHARE of them: there a tube's arc is an exact circle, its
moment matrix is singular up to rounding, and an ulp of the moments flips
the fit's rank-deficiency switch and moves the centre by centimetres
(``chip_smoke.py`` bounds the same share between the fit's two moment
routes, FIT_SWITCH_SHARE, and measured 0.14-0.31%).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _scans import (CLUSTER_CASES, arc_scans, synth_scan, tube_scans,
                    wraparound_scan)
from shermbot_navigation_tpu_torch.ops import landmark_detection as ld
from shermbot_navigation_tpu_torch.ops.kernels import _build
from shermbot_navigation_tpu_torch.ops.kernels import circle_fit as cfk
from shermbot_navigation_tpu_torch.ops.kernels import perception as pk
from shermbot_navigation_tpu_torch.ops.kernels import plain_versions
from shermbot_navigation_tpu_torch.pipeline import driver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario

MINR, MAXR = 0.05, 1.0
STD_MARGIN = 1e-3            # degrees
POS_TOL = 1e-5               # m, final detections
FIT_SWITCH_SHARE = 0.01      # of a noise-free scan's detections
U = 2.0 ** -24               # float32's unit roundoff
# each moment's degree in the coordinates (zz, zx, zy, z, xx, xy, x, yy,
# y, n)
DEGREE = (4, 3, 3, 2, 2, 2, 1, 2, 1, 0)
NAMES = ("moments", "cx", "cy", "zbar", "count", "valid", "is_circle")


def _full_cluster_0():
    """A cluster across ray 0 of 90 rows (more than P = 64), so that the
    wrap move overwrites its last stored row, and a second cluster."""
    s = np.full(360, 5.0)
    s[np.arange(-40, 50) % 360] = 0.5
    s[50:60] = 0.7
    return s[None]


def _many_clusters():
    """20 clusters of 6 rays in one scan: more than C = 16 slots."""
    s = np.full(360, 5.0)
    for k in range(20):
        s[5 + 15 * k: 11 + 15 * k] = 0.3 + 0.03 * k
    return s[None]


def _cases():
    return np.stack([synth_scan(s) for s, _ in CLUSTER_CASES.values()])


def _arcs_of(n, seed, count=16):
    """Scans of n rays: an out-of-range background and up to 6 arcs of 3
    to n // 12 + 3 rays (past P = 64 rows at n = 1024), some across ray 0,
    with 1e-3 m of range noise."""
    rng = np.random.default_rng(seed)
    out = np.full((count, n), 5.0)
    for s in out:
        for _ in range(int(rng.integers(1, 7))):
            c, w = int(rng.integers(0, n)), int(rng.integers(3, n // 12 + 4))
            span = np.arange(c - w // 2, c + w - w // 2) % n
            s[span] = rng.uniform(0.1, 0.95) + rng.normal(0, 1e-3, w)
    return out


# rays a scan that take each of the source's instances (rays a lane)
INSTANCE_RAYS = {1: 20, 2: 64, 4: 100, 8: 200, 12: 360, 16: 500, 24: 700,
                 32: 1024}


# (scans, C, P): the scan makers of test_torch_perception.py and the edges
SCANS = {
    "arcs": lambda: (arc_scans(3, 12, 0.01), 16, 64),
    "tubes": lambda: (tube_scans(4, 16), 16, 64),
    "wraparound_and_out_of_range": lambda: (np.concatenate(
        [wraparound_scan(), np.full((2, 360), 5.0)]), 16, 64),
    "reference_cases": lambda: (_cases(), 16, 64),
    "small_buffers": lambda: (_cases(), 2, 4),
    "full_cluster_0": lambda: (_full_cluster_0(), 16, 64),
    "more_clusters_than_slots": lambda: (_many_clusters(), 16, 64),
}


def _scans(case, dtype, device="cpu"):
    scans, C, P = SCANS[case]()
    return torch.as_tensor(scans, dtype=dtype, device=device), C, P


# ---------------------------------------------------------------------------
# CPU: the plain route, the launch plan, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(SCANS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_is_the_plain_version(monkeypatch, case, dtype):
    """On the CPU ``fit_inputs`` is ``_segment_fit_inputs``, bit for bit,
    margins too, and builds nothing."""
    monkeypatch.setattr(pk, "library", _refuse)
    r, C, P = _scans(case, dtype)
    got_m, want_m = {}, {}
    launches = pk.fit_inputs.launches
    got = pk.fit_inputs(r, MINR, MAXR, C, P, 10.0, got_m)
    want = ld._segment_fit_inputs(r, MINR, MAXR, C, P, 10.0, want_m)
    assert pk.fit_inputs.launches == launches
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert got_m.keys() == want_m.keys() == {"split", "std"}
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k


def test_cpu_detection_never_builds(monkeypatch):
    monkeypatch.setattr(_build, "build", _refuse)
    monkeypatch.setattr(pk, "library", _refuse)
    r, _, _ = _scans("tubes", torch.float32)
    launches = pk.fit_inputs.launches
    det = ld.detect_landmarks(r, MINR, MAXR)
    assert pk.fit_inputs.launches == launches
    assert int(det.valid.sum()) > 10


def _refuse(*a, **k):
    raise AssertionError("the kernel was built or launched")


@pytest.mark.parametrize("C", [1, 16, 32])
def test_launch_plan_is_pure_and_takes_the_smallest_instance(C):
    for n in range(1, pk.MAX_RAYS + 1):
        plan = pk.launch_plan(n, C, 64)
        assert plan == pk.launch_plan(n, C, 64)
        assert plan == pk.launch_plan(n, 16, 3)   # only n sizes the launch
        assert plan.rays in pk.RAYS and 32 * plan.rays >= n
        smaller = [k for k in pk.RAYS if k < plan.rays]
        assert not smaller or 32 * max(smaller) < n
        assert plan.threads == 32 * pk.WORLDS
        assert plan.shared_bytes == pk.WORLDS * (
            pk.SLOT_BYTES + 4 * pk.RAY_WORDS * (-(-n // 4) * 4))
        assert plan.shared_bytes <= 232_448    # a block's most on an H100
    assert pk.launch_plan(360, 16, 64) == pk.Plan(
        12, 128, pk.WORLDS * (pk.SLOT_BYTES + 5 * 1440))


def test_the_instance_cases_take_every_instance():
    assert tuple(sorted(INSTANCE_RAYS)) == pk.RAYS
    for rays, n in INSTANCE_RAYS.items():
        assert pk.launch_plan(n, 16, 64).rays == rays
        r = torch.as_tensor(_arcs_of(n, rays), dtype=torch.float32)
        out = ld._segment_fit_inputs(r, MINR, MAXR, 16, 64)
        assert int(out[5].sum()) >= 16, n     # valid slots to compare
        assert bool((out[0][..., 9] > 3).any()), n


@pytest.mark.parametrize("n,C,P", [(0, 16, 64), (1025, 16, 64),
                                   (4096, 16, 64), (360, 0, 64),
                                   (360, 33, 64), (360, 16, 0)])
def test_launch_plan_is_none_past_its_limits(n, C, P):
    assert pk.launch_plan(n, C, P) is None


def test_plan_constants_agree_with_the_source():
    src = (Path(pk.__file__).resolve().parents[2] / "csrc"
           / "perception.cu").read_text()
    for c_name, value in (("kMaxRays", pk.MAX_RAYS),
                          ("kMaxSlots", pk.MAX_SLOTS),
                          ("kSlotBytes", pk.SLOT_BYTES),
                          ("kRayWords", pk.RAY_WORDS),
                          ("kWorlds", pk.WORLDS)):
        m = re.search(rf"constexpr int {c_name} = (\d+);", src)
        assert m and int(m.group(1)) == value, c_name
    assert tuple(int(k) for k in re.findall(r"CASE\((\d+)\)", src)) == \
        pk.RAYS
    assert "smem < kWorlds * (kSlotBytes + 4 * kRayWords * n4)" in src


@pytest.mark.parametrize("case,match", [
    ("float64", "scan must be torch.float32"),
    ("float16", "scan must be torch.float32"),
    ("strided", "scan must be contiguous"),
    ("too_many_rays", "no launch plan for n=1025"),
    ("too_many_slots", "no launch plan for n=360, C=33"),
    ("bound_float64", "min_range must be a float32 number or one-element "
                      "tensor"),
    ("bound_vector", "max_range must be a float32 number or one-element "
                     "tensor"),
])
def test_the_kernel_refuses_what_it_does_not_take(monkeypatch, case, match):
    """A scan the kernel does not take is refused by its message before
    any build: the wrapper never falls back to the plain version."""
    monkeypatch.setattr(_build, "build", _refuse)
    monkeypatch.setattr(pk, "library", _refuse)
    r = torch.full((2, 360), 0.5)
    lo, hi, C = MINR, MAXR, 16
    if case == "float64":
        r = r.double()
    elif case == "float16":
        r = r.half()
    elif case == "strided":
        r = torch.full((2, 720), 0.5)[:, ::2]
    elif case == "too_many_rays":
        r = torch.full((2, 1025), 0.5)
    elif case == "too_many_slots":
        C = 33
    elif case == "bound_float64":
        lo = torch.tensor(MINR, dtype=torch.float64)
    else:
        hi = torch.tensor([MAXR, MAXR])
    with pytest.raises(ValueError, match=match):
        pk._launch(r, lo, hi, C, 64, 10.0, None)


# ---------------------------------------------------------------------------
# The card: the kernel against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


def _clear_circles(r, lo, hi, C, P):
    """Slots whose circle decision stands at the threshold +- STD_MARGIN
    on the plain version (its deviation lies farther than that)."""
    a = ld._segment_fit_inputs(r, lo, hi, C, P, 10.0 - STD_MARGIN)[6]
    b = ld._segment_fit_inputs(r, lo, hi, C, P, 10.0 + STD_MARGIN)[6]
    return a == b


def _assert_fit_inputs_close(got, want, clear, where=""):
    """``got`` (the kernel) against ``want`` (the plain version), by the
    tolerances of the module docstring."""
    mom, cx, cy, zbar, count, valid, circle = got
    wmom, wcx, wcy, wzbar, wcount, wvalid, wcircle = (
        w.contiguous() for w in want)
    assert torch.equal(count, wcount), f"{where}: count"
    assert torch.equal(valid, wvalid), f"{where}: valid"
    assert torch.equal(mom[..., 9], wmom[..., 9]), f"{where}: stored rows"
    bad = int((circle != wcircle)[clear].sum())
    assert bad == 0, f"{where}: is_circle differs in {bad} clear slots"
    m = wmom[..., 9].double().clamp_min(1.0)
    rho = wmom[..., 3].double().clamp_min(0.0).sqrt()  # any row's z <= sum
    A = torch.maximum(wcx.double().abs(), wcy.double().abs()) + rho
    d = torch.tensor(DEGREE[:9], dtype=torch.float64, device=m.device)
    tol = (2 * m[..., None] ** 2 * U * rho[..., None] ** (d - 1)
           * (rho[..., None] + 2 * d * A[..., None]))
    err = (mom[..., :9].double() - wmom[..., :9].double()).abs()
    assert bool((err <= tol).all()), (
        f"{where}: moments off by {float((err - tol).max()):.3g} past "
        f"their bound")
    for name, g, w in (("cx", cx, wcx), ("cy", cy, wcy)):
        e = (g.double() - w.double()).abs()
        assert bool((e <= 2 * (m + 1) * U * A).all()), f"{where}: {name}"
    e = (zbar.double() - wzbar.double()).abs()
    assert bool((e <= tol[..., 3] / m + 2 * U * wzbar.double().abs()).all()), \
        f"{where}: zbar"


def _sequential_matmul(a, b):
    """``a @ b`` for a one-hot ``a (..., C, n)``: each output summed over
    the n rays one after another in ray order."""
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=b.dtype,
                      device=b.device)
    for i in range(a.shape[-1]):
        acc = acc + a[..., :, i, None] * b[..., None, i, :]
    return acc


def _assert_in_ray_order(monkeypatch, r, C, P, where):
    """Every output, margins too, bit for bit against the plain version
    whose segment sums add the rays in ray order."""
    got_m, want_m = {}, {}
    got = pk.fit_inputs(r, MINR, MAXR, C, P, 10.0, got_m)
    with monkeypatch.context() as m:
        m.setattr(torch, "matmul", _sequential_matmul)
        want = ld._segment_fit_inputs(r, MINR, MAXR, C, P, 10.0, want_m)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), f"{where}: {name}"
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), f"{where}: margin {k}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(SCANS))
def test_kernel_is_the_plain_version_summed_in_ray_order(dev, monkeypatch,
                                                         case):
    r, C, P = _scans(case, torch.float32, dev)
    _assert_in_ray_order(monkeypatch, r, C, P, case)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rays", sorted(INSTANCE_RAYS))
def test_every_instance_is_the_plain_version_summed_in_ray_order(
        dev, monkeypatch, rays):
    """Each of the source's instances, on scans of the n rays that take
    it (INSTANCE_RAYS)."""
    n = INSTANCE_RAYS[rays]
    r = torch.as_tensor(_arcs_of(n, rays), dtype=torch.float32, device=dev)
    assert pk.launch_plan(n, 16, 64).rays == rays
    _assert_in_ray_order(monkeypatch, r, 16, 64, f"n={n}")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(SCANS))
def test_kernel_equals_the_plain_version(dev, case):
    r, C, P = _scans(case, torch.float32, dev)
    got_m, want_m = {}, {}
    launches = pk.fit_inputs.launches
    got = pk.fit_inputs(r, MINR, MAXR, C, P, 10.0, got_m)
    assert pk.fit_inputs.launches == launches + 1
    want = ld._segment_fit_inputs(r, MINR, MAXR, C, P, 10.0, want_m)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    _assert_fit_inputs_close(got, want, _clear_circles(r, MINR, MAXR, C, P),
                             case)
    # the split margin is a minimum of per-ray numbers: the same bits
    assert torch.equal(got_m["split"], want_m["split"])
    torch.testing.assert_close(got_m["std"], want_m["std"], rtol=1e-4,
                               atol=STD_MARGIN)


def _assert_detections_close(got, want, switch_share, where=""):
    """``valid`` equal; positions within POS_TOL but for a share of
    ``switch_share`` of the detections."""
    assert torch.equal(got.valid, want.valid), f"{where}: valid"
    ok = got.valid
    far = int(((got.positions - want.positions).abs().amax(-1) > POS_TOL)
              [ok].sum())
    assert far <= switch_share * int(ok.sum()), (
        f"{where}: {far} of {int(ok.sum())} detections off by more than "
        f"{POS_TOL} m")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,noise", [(4, 1e-4), (6, 1e-3)])
def test_final_detections_equal_the_plain_path(dev, seed, noise):
    """Tube scans with range noise: every detection within POS_TOL."""
    r = torch.as_tensor(tube_scans(seed, 16, noise), dtype=torch.float32,
                        device=dev)
    C, P = 16, 64
    got = ld.detect_landmarks(r, MINR, MAXR, max_clusters=C, max_points=P)
    with plain_versions():
        want = ld.detect_landmarks(r, MINR, MAXR, max_clusters=C,
                                   max_points=P)
    _assert_detections_close(got, want, 0.0, f"noise {noise}")
    assert int(got.valid.sum()) > 20


@pytest.mark.requires_cuda
def test_two_launches_give_the_same_bits(dev):
    r = torch.as_tensor(tube_scans(8, 512, 1e-3), dtype=torch.float32,
                        device=dev)
    a = pk.fit_inputs(r, MINR, MAXR, 16, 64, margins={})
    b = pk.fit_inputs(r, MINR, MAXR, 16, 64, margins={})
    for name, x, y in zip(NAMES, a, b):
        assert torch.equal(x, y), name


def _chain(dev, name, B, T, seed):
    """T ticks of the scenario's sim at B worlds on the card: yields each
    tick's scans and the scenario."""
    scn = get_scenario(name)
    params = scn.world_params(device=dev)
    sense = driver.init_sense(params, torch.float32, (B,))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cmds = driver.command_twist(scn, T, device=dev)
    for t in range(T):
        sense, _, _, _, obs = driver.sense_tick(
            scn, params, sense, cmds[t], driver.draw_noise(scn, g, (B,)))
        yield scn, params, obs.scan


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["lidar20_full", "lidar20_tuned"])
def test_eight_ticks_at_wide_batch(dev, name):
    """8 ticks of the scenario at B = 65536 worlds (noise-free scans):
    every tick's fit inputs held to the plain version's, the final
    detections to the plain path's; the range bounds read on the card,
    never on the host."""
    B, T = 65536, 8
    for t, (scn, params, scan) in enumerate(_chain(dev, name, B, T, 21)):
        lo, hi = params.scan_min, params.scan_max
        C, P = scn.max_clusters, scn.max_cluster_points
        got = pk.fit_inputs(scan, lo, hi, C, P)
        want = ld._segment_fit_inputs(scan, lo, hi, C, P)
        _assert_fit_inputs_close(got, want, _clear_circles(scan, lo, hi, C, P),
                                 f"{name} tick {t}")
        del want
        a = ld.detect_landmarks(scan, lo, hi, max_clusters=C, max_points=P)
        with plain_versions():
            b = ld.detect_landmarks(scan, lo, hi, max_clusters=C,
                                    max_points=P)
        _assert_detections_close(a, b, FIT_SWITCH_SHARE, f"{name} tick {t}")
        assert int(a.valid.sum()) > B, f"{name} tick {t}"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["lidar20_full", "lidar20_tuned"])
def test_a_run_launches_the_front_end_once_a_tick(dev, name):
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    T = 4
    front, tail = pk.fit_inputs.launches, cfk.fit_tail.launches
    outs = driver.run_scenario_batch_lanes(get_scenario(name), g, batch=64,
                                           steps=T, device=dev)
    assert pk.fit_inputs.launches - front == T
    assert cfk.fit_tail.launches - tail == T
    assert bool(torch.isfinite(outs.slam_pose).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case,match", [
    ("float64", "scan must be torch.float32"),
    ("strided", "scan must be contiguous"),
    ("too_many_rays", "no launch plan for n=1025"),
    ("bound_on_the_host", "min_range must be a float32 number or "
                          "one-element tensor on cuda"),
])
def test_the_card_never_falls_back(dev, case, match):
    """On the card a scan the kernel does not take raises, through the
    wrapper and through ``detect_landmarks``."""
    r = torch.full((4, 360), 0.5, device=dev)
    lo = MINR
    if case == "float64":
        r = r.double()
    elif case == "strided":
        r = torch.full((4, 720), 0.5, device=dev)[:, ::2]
    elif case == "too_many_rays":
        r = torch.full((4, 1025), 0.5, device=dev)
    else:
        lo = torch.tensor(MINR)
    launches = pk.fit_inputs.launches
    with pytest.raises(ValueError, match=match):
        pk.fit_inputs(r, lo, MAXR, 16, 64)
    with pytest.raises(ValueError, match=match):
        ld.detect_landmarks(r, lo, MAXR)
    assert pk.fit_inputs.launches == launches


@pytest.mark.requires_cuda
def test_the_front_end_never_waits_for_the_device(dev):
    """The kernel's route, margins and card-side bounds included, makes no
    synchronizing call: PyTorch's sync debug mode raises on any."""
    scn, params, scan = next(_chain(dev, "lidar20_full", 256, 1, 3))
    lo, hi = params.scan_min, params.scan_max
    pk.fit_inputs(scan, lo, hi, 16, 64, margins={})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            margins = {}
            out = pk.fit_inputs(scan, lo, hi, 16, 64, margins=margins)
            ld.detect_landmarks(scan, lo, hi, margins={})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(out[5].any()) and bool(torch.isfinite(margins["split"]))
