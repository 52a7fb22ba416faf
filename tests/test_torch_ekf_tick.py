"""The filter tick in one kernel (``ops/kernels/ekf_tick``,
``csrc/ekf_tick.cu``) against the plain ``models/ekf_batch`` tick.

The CPU tests (tier 1) hold the pure launch plan, what the kernel
refuses, and the path ``run_scenario_batch_lanes`` takes. The
card tests (marked ``requires_cuda``; they skip elsewhere) hold the
kernel to the plain tick on the card. The file imports no JAX; on the card run it with

    python -m pytest tests/test_torch_ekf_tick.py -q --noconftest

Tolerance of the card tests: none. The kernel performs the plain tick's
float32 operations one rounding at a time in the plain tick's order
(``__fmul_rn`` / ``__fadd_rn``, no FMA contraction), with the CUDA math
library's ``sinf``, ``cosf``, ``atan2f`` and IEEE ``sqrtf`` and division,
which PyTorch's elementwise kernels use on the card too, and the plain
tick's masked sums read one entry and add zeros. So each world's state is
the plain tick's bits, tick after tick; only a world whose gate margin
came within 1e-4 (relative) of a gate is excused, where a rounding of
another order would be free to decide the other way.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from shermbot_navigation_tpu_torch.models import ekf_batch
from shermbot_navigation_tpu_torch.ops.kernels import _build
from shermbot_navigation_tpu_torch.ops.kernels import ekf_tick
from shermbot_navigation_tpu_torch.pipeline import driver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario

# every scenario the lanes engine runs, with its state size D = 3 + 2N
LANES = {"loop5_known": 13, "stock6": 15, "course12_noisy": 27,
         "course12_tuned": 35, "lidar20_full": 43, "lidar20_tuned": 51}
TIE_REL = 1e-4


def _m(scn) -> int:
    """The scenario's measurements a tick, M (as the lanes engine counts
    them)."""
    return scn.max_clusters if scn.use_lidar else len(scn.tubes)


# ---------------------------------------------------------------------------
# CPU: the launch plan, the path a run takes and its counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LANES))
def test_launch_plan_fits_every_lanes_scenario(name):
    scn = get_scenario(name)
    D = scn.ekf_config().dim
    assert D == LANES[name]
    plan = ekf_tick.launch_plan(D, _m(scn))
    assert plan is not None, name
    assert plan.shared_bytes <= ekf_tick.SHARED_LIMIT == 232_448
    assert plan.worlds == ekf_tick.WORLDS
    assert plan.threads == ekf_tick.SLICES * plan.worlds <= 1024
    # the block's worlds' covariance and mean are in shared memory
    assert plan.shared_bytes >= 4 * plan.worlds * (D * D + D)


def test_launch_plan_is_none_beyond_its_largest_d():
    M = 16
    fits = [D for D in range(5, 201, 2) if ekf_tick.launch_plan(D, M)]
    largest = max(fits)
    assert fits == list(range(5, largest + 1, 2))
    assert largest >= max(LANES.values())
    for D in (largest + 2, largest + 4, 4001):
        assert ekf_tick.launch_plan(D, M) is None
    # no even state, no empty tick, no tick whose measurements overflow
    assert ekf_tick.launch_plan(44, M) is None
    assert ekf_tick.launch_plan(43, 0) is None
    assert ekf_tick.launch_plan(43, 4096) is None


def test_plan_sizes_agree_with_the_source():
    """The constants that size the shared memory are the source's."""
    src = (Path(ekf_tick.__file__).resolve().parents[2] / "csrc"
           / "ekf_tick.cu").read_text()
    for c_name, value in (("kWorlds", ekf_tick.WORLDS),
                          ("kSlices", ekf_tick.SLICES),
                          ("kScalars", ekf_tick.SCALARS),
                          ("kSmemLimit", ekf_tick.SHARED_LIMIT)):
        m = re.search(rf"constexpr int {c_name} = (\d+);", src)
        assert m and int(m.group(1)) == value, c_name
    assert ekf_tick.shared_bytes(43, 16) == 69_184
    assert "W * (D * D + 5 * D + N + 2 * M + kScalars) + 16" in src
    assert "W * (3 + M)" in src and "W * (N + M)" in src


def _no_build(monkeypatch, launch=False):
    def refuse(*a, **k):
        raise AssertionError("the kernel was built or launched")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(ekf_tick, "library", refuse)
    if not launch:
        monkeypatch.setattr(ekf_tick, "_launch", refuse)


@pytest.mark.parametrize("case", ["float64", "padded", "too_wide"])
def test_the_kernel_refuses_what_it_does_not_take(monkeypatch, case):
    """A state the kernel does not take (float64, the dense engine's
    padded state, a D with no launch plan) is refused before any build:
    the wrapper never falls back to the plain tick on its own."""
    _no_build(monkeypatch, launch=True)
    cfg = get_scenario("lidar20_full").ekf_config()
    dtype, match = torch.float32, "no launch plan"
    if case == "float64":
        dtype, match = torch.float64, "cov must be torch.float32"
    elif case == "padded":
        cfg = dataclasses.replace(cfg, pad_state_to=128)
    else:
        cfg = dataclasses.replace(cfg, num_landmarks=200)
        assert ekf_tick.launch_plan(cfg.dim, 16) is None
    B, M = 2, 16
    st = ekf_batch.init(cfg, B, dtype=dtype, device="cpu")
    Q, R = torch.eye(3, dtype=dtype), torch.eye(2, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ekf_tick._launch(cfg, st, torch.zeros((B, 3), dtype=dtype),
                         torch.ones((B, M, 2), dtype=dtype),
                         torch.ones((B, M), dtype=torch.bool), Q, R, None,
                         None)


@pytest.mark.parametrize("name,dtype", [("lidar20_full", torch.float32),
                                        ("loop5_known", torch.float32),
                                        ("course12_noisy", torch.float64)])
def test_cpu_run_takes_the_plain_path_and_never_builds(monkeypatch, name,
                                                       dtype):
    _no_build(monkeypatch)
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    launches = ekf_tick.step.launches
    outs = driver.run_scenario_batch_lanes(get_scenario(name), g, batch=2,
                                           steps=3, dtype=dtype,
                                           device="cpu")
    assert ekf_tick.step.launches == launches
    assert bool(torch.isfinite(outs.slam_pose).all())


def _tick_inputs(name, B, seed, dtype=torch.float32):
    scn = get_scenario(name)
    params = scn.world_params(dtype, "cpu")
    sense = driver.init_sense(params, dtype, (B,))
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    cmds = driver.command_twist(scn, 2, dtype, "cpu")
    for t in range(2):
        sense, twist, zs, valid, _ = driver.sense_tick(
            scn, params, sense, cmds[t], driver.draw_noise(scn, g, (B,),
                                                           dtype))
    return scn, twist, zs, valid


@pytest.mark.parametrize("name", ["lidar20_full", "loop5_known"])
def test_plain_route_is_the_ekf_batch_tick(name):
    """On the CPU the wrapper runs ``ekf_batch``'s own tick: the same
    state, and one margin tensor a measurement on unknown association."""
    B = 3
    scn, twist, zs, valid = _tick_inputs(name, B, 1)
    cfg = scn.ekf_config()
    Q, R = scn.noise_matrices(torch.float32, "cpu")
    st = ekf_batch.init(cfg, B, device="cpu")
    ids = torch.arange(zs.shape[1], dtype=torch.int32).expand(
        B, zs.shape[1]).contiguous() if scn.known_association else None
    got_m, want_m = [], []
    got = ekf_tick.step(cfg, st, twist, zs, valid, Q, R, ids, got_m)
    if ids is None:
        want = ekf_batch.step(cfg, st, twist, zs, valid, Q, R, want_m)
    else:
        want = ekf_batch.known_association_step(cfg, st, twist, zs, valid,
                                                ids, Q, R)
    for k in ("mean", "cov", "n_seen", "seen"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert len(got_m) == len(want_m) == (0 if ids is not None
                                         else zs.shape[1])
    for a, b in zip(got_m, want_m):
        assert torch.equal(a, b)


def test_launch_flags_follow_the_config():
    f = ekf_tick._flags
    assert f(get_scenario("lidar20_full").ekf_config(), False) == \
        ekf_tick.ANALYTIC | ekf_tick.SYMMETRIZE
    assert f(get_scenario("lidar20_tuned").ekf_config(), False) == (
        ekf_tick.NEAREST | ekf_tick.ANALYTIC | ekf_tick.SYMMETRIZE
        | ekf_tick.WRAP)
    plain = dataclasses.replace(get_scenario("loop5_known").ekf_config(),
                                symmetrize=False, analytic_init=False)
    assert f(plain, True) == ekf_tick.KNOWN


# ---------------------------------------------------------------------------
# The card: the kernel against the plain tick
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


def _two_chains(dev, name, B, T, seed, **cfg):
    """Both filters, each on its own state, fed the same ticks of real
    sim and perception output on the card. Yields ``(t, plain, fused,
    tied, margins)`` after each tick, ``tied`` (B,) where a world's gate
    margin came within TIE_REL of a gate at this tick or before, and
    ``margins`` the tick's (plain, fused) smallest gate margin of every
    world on unknown association, else None."""
    scn = get_scenario(name)
    ecfg = dataclasses.replace(scn.ekf_config(), **cfg)
    f32 = torch.float32
    params = scn.world_params(f32, dev)
    Q, R = scn.noise_matrices(f32, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    M = _m(scn)
    ids = torch.arange(M, dtype=torch.int32, device=dev).expand(
        B, M).contiguous() if scn.known_association else None
    cmds = driver.command_twist(scn, T, f32, dev)
    sense = driver.init_sense(params, f32, (B,))
    plain = fused = ekf_batch.init(ecfg, B, device=dev)
    tied = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(T):
        sense, twist, zs, valid, _ = driver.sense_tick(
            scn, params, sense, cmds[t], driver.draw_noise(scn, g, (B,)))
        marg, fmarg = [], []
        plain = ekf_tick.reference_step(ecfg, plain, twist, zs, valid, Q, R,
                                        ids, marg)
        fused = ekf_tick.step(ecfg, fused, twist, zs, valid, Q, R, ids,
                              fmarg)
        margins = None
        if marg:
            assert len(fmarg) == 1
            margins = (torch.stack(marg).amin(0), fmarg[0])
            tied |= margins[0] < TIE_REL
        else:
            assert not fmarg
        yield t, plain, fused, tied, margins


def _assert_equal_untied(plain, fused, tied, where):
    keep = ~tied
    for k in ("mean", "cov", "n_seen", "seen"):
        a, b = getattr(plain, k)[..., keep], getattr(fused, k)[..., keep]
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs()
            bad = int((diff.reshape(-1, a.shape[-1]).amax(0) > 0).sum())
            raise AssertionError(f"{where}: {k} differs in {bad} worlds, "
                                 f"largest {float(diff.max()):.3g}")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,B,cfg", [
    ("lidar20_full", 4096, {}),
    ("lidar20_tuned", 1024, {}),
    ("loop5_known", 1024, {}),
    ("lidar20_full", 1024, {"symmetrize": False, "wrap_innovation": True}),
    ("course12_noisy", 1000, {"analytic_init": False}),
])
def test_kernel_tick_equals_plain_tick(dev, name, B, cfg):
    """8 ticks of real detections: outcomes (``n_seen``, ``seen``), mean
    and covariance are the plain tick's bits in every world that never
    came within 1e-4 of a gate; on unknown association so is the kernel's
    smallest gate margin of the tick, against the ``amin`` of the plain
    tick's per-measurement margins."""
    launches = ekf_tick.step.launches
    T = 8
    for t, plain, fused, tied, margins in _two_chains(dev, name, B, T, 11,
                                                      **cfg):
        _assert_equal_untied(plain, fused, tied, f"{name} tick {t}")
        if margins is not None:
            want, got = (m[~tied] for m in margins)
            assert torch.equal(got, want), (
                f"{name} tick {t}: gate margins differ in "
                f"{int((got != want).sum())} worlds")
        else:
            assert get_scenario(name).known_association
    assert ekf_tick.step.launches - launches == T
    assert int(tied.sum()) <= B // 20, int(tied.sum())
    assert int(plain.n_seen.min()) >= 1 and int(plain.n_seen.max()) >= 3


@pytest.mark.requires_cuda
def test_a_world_that_does_not_act_is_bit_equal(dev):
    """Worlds with no valid measurement in the tick come out as the plain
    predict left them, bit for bit, beside worlds that act."""
    B = 64
    scn = get_scenario("lidar20_full")
    cfg = scn.ekf_config()
    ticks = list(_two_chains(dev, "lidar20_full", B, 2, 5))
    st = ticks[-1][1]
    f32 = torch.float32
    Q, R = scn.noise_matrices(f32, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    twist = 0.05 * torch.randn((B, 3), generator=g, device=dev)
    zs = torch.rand((B, 16, 2), generator=g, device=dev)
    valid = torch.ones((B, 16), dtype=torch.bool, device=dev)
    idle = torch.arange(B, device=dev) % 2 == 1
    valid[idle] = False
    out = ekf_tick.step(cfg, st, twist, zs, valid, Q, R)
    pred = ekf_batch.predict(cfg, st, twist, Q)
    for k in ("mean", "cov", "n_seen", "seen"):
        assert torch.equal(getattr(out, k)[..., idle],
                           getattr(pred, k)[..., idle]), k
    assert not torch.equal(out.mean[..., ~idle], pred.mean[..., ~idle])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B", [37, 40])
def test_batched_worlds_equal_their_own_launches(dev, B):
    """A B-world launch gives each world the bits of its own one-world
    launch (B = 37: the ragged last block and 4-byte copies; B = 40: the
    16-byte copies)."""
    scn = get_scenario("lidar20_full")
    cfg = scn.ekf_config()
    ticks = list(_two_chains(dev, "lidar20_full", B, 3, 7))
    st = ticks[-2][1]
    Q, R = scn.noise_matrices(torch.float32, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    twist = 0.02 * torch.randn((B, 3), generator=g, device=dev)
    zs = torch.stack([0.3 + 0.6 * torch.rand((B, 16), generator=g,
                                             device=dev),
                      6.2 * torch.rand((B, 16), generator=g, device=dev)
                      - 3.1], -1)
    valid = torch.rand((B, 16), generator=g, device=dev) < 0.7
    marg = []
    whole = ekf_tick.step(cfg, st, twist, zs, valid, Q, R, margins=marg)
    for b in range(B):
        one = ekf_batch.BatchState(*(x[..., b:b + 1].contiguous()
                                     for x in st))
        m1 = []
        own = ekf_tick.step(cfg, one, twist[b:b + 1], zs[b:b + 1],
                            valid[b:b + 1], Q, R, margins=m1)
        for k in ("mean", "cov", "n_seen", "seen"):
            assert torch.equal(getattr(whole, k)[..., b:b + 1],
                               getattr(own, k)), (b, k)
        assert torch.equal(marg[0][b:b + 1], m1[0]), b


@pytest.mark.requires_cuda
def test_filter_tick_never_waits_for_the_device(dev):
    """The kernel's tick makes no synchronizing call (no host read of a
    device number): PyTorch's sync debug mode raises on any."""
    scn = get_scenario("lidar20_full")
    cfg = scn.ekf_config()
    B = 256
    ticks = list(_two_chains(dev, "lidar20_full", B, 2, 9))
    st = ticks[-1][2]
    Q, R = scn.noise_matrices(torch.float32, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    twist = 0.02 * torch.randn((B, 3), generator=g, device=dev)
    zs = torch.rand((B, 16, 2), generator=g, device=dev)
    valid = torch.rand((B, 16), generator=g, device=dev) < 0.5
    ekf_tick.step(cfg, st, twist, zs, valid, Q, R)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            marg = []
            st = ekf_tick.step(cfg, st, twist, zs, valid, Q, R,
                               margins=marg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(st.mean).all())


@pytest.mark.requires_cuda
def test_card_run_refuses_float64(dev):
    """On the card the filter's tick launches the kernel or raises: a
    float64 state is refused, never run on the plain tick; so is a
    float64 lanes run (its perception's kernel refuses it first)."""
    scn = get_scenario("lidar20_full")
    cfg = scn.ekf_config()
    f64 = torch.float64
    B, M = 8, 16
    st = ekf_batch.init(cfg, B, dtype=f64, device=dev)
    Q, R = scn.noise_matrices(f64, dev)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    launches = ekf_tick.step.launches
    with pytest.raises(ValueError, match="cov must be torch.float32"):
        ekf_tick.step(cfg, st, torch.zeros((B, 3), dtype=f64, device=dev),
                      torch.ones((B, M, 2), dtype=f64, device=dev),
                      torch.ones((B, M), dtype=torch.bool, device=dev), Q, R)
    with pytest.raises(ValueError, match="must be (torch.)?float32"):
        driver.run_scenario_batch_lanes(scn, g, batch=B, steps=2, dtype=f64,
                                        device=dev)
    assert ekf_tick.step.launches == launches


@pytest.mark.requires_cuda
def test_card_run_launches_once_a_tick(dev):
    """On the card the lanes driver takes the kernel: one launch a tick."""
    launches = ekf_tick.step.launches
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    T = 3
    outs = driver.run_scenario_batch_lanes(get_scenario("lidar20_full"), g,
                                           batch=64, steps=T, device=dev)
    assert ekf_tick.step.launches - launches == T
    assert bool(torch.isfinite(outs.slam_pose).all())
