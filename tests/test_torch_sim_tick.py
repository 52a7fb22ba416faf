"""The simulator's tick in one kernel (``ops/kernels/sim_tick``,
``csrc/sim_tick.cu``): the wrapper's plain route against the chain that
``pipeline/driver.sense_tick`` ran inline, on the CPU.

The plain version (``sim_tick.reference_tick``) and the wrapper on CPU
tensors must be that chain's bits: ``sim_substeps`` calls of
``tube_world.step_dynamics``, ``tube_world.observe``, then the odometry
from the commanded joint states. The checks of the kernel's operands run
before any build, so they are held here too; the card's own tests are in
``tests/test_torch_sim_kernel.py``. The file imports no JAX.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from shermbot_navigation_tpu_torch.ops import diff_drive as dd
from shermbot_navigation_tpu_torch.ops.kernels import _build, sim_tick
from shermbot_navigation_tpu_torch.pipeline import driver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim import tube_world as tw

# (scenario, WorldConfig overrides): both slip modes, the quirk branch, and
# each observation channel alone and together
CASES = [
    ("lidar20_full", {}),
    ("lidar20_tuned", {}),
    ("lidar20_full", {"reference_lidar_quirks": True}),
    ("course12_tuned", {}),
    ("stock6", {}),
    ("stock6", {"compute_scan": True, "reference_lidar_quirks": True}),
    ("lidar20_full", {"compute_scan": False, "compute_fake_sensor": False}),
]
# draws that every term scales: twist, scan noise and both dropouts
NOISY = dict(twist_noise=0.01, scan_noise=0.004, sensor_dropout=0.3,
             scan_dropout=0.2)


def _inline_chain(scn, wcfg, params, state, cmd, noise):
    """The sim block of ``driver.sense_tick`` as it was written inline."""
    world = state.world
    for k in range(scn.sim_substeps):
        world = tw.step_dynamics(wcfg, params, world, cmd, scn.dt,
                                 noise.substep(k))
    obs = tw.observe(wcfg, params, world, noise.obs)
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)
    twist = dd.wheels_to_twist(dparams, obs.joint_states - state.odom.wheels)
    odom = dd.step(dparams, state.odom, obs.joint_states)
    return world, obs, odom, twist


def _params(scn, dtype, noisy):
    params = scn.world_params(dtype, "cpu")
    if noisy:
        params = params._replace(**{k: torch.tensor(v, dtype=dtype)
                                    for k, v in NOISY.items()})
    return params


def _equal(got, want, where):
    assert (got is None) == (want is None), where
    if got is not None:
        assert got.dtype == want.dtype and torch.equal(got, want), where


def _assert_tick_equal(got: sim_tick.SimTick, world, obs, odom, twist, t):
    _equal(got.world.drive.pose, world.drive.pose, f"tick {t}: pose")
    _equal(got.world.drive.wheels, world.drive.wheels, f"tick {t}: wheels")
    _equal(got.world.cmd_wheels, world.cmd_wheels, f"tick {t}: cmd_wheels")
    for f in tw.Observation._fields:
        _equal(getattr(got.obs, f), getattr(obs, f), f"tick {t}: obs.{f}")
    if odom is not None:
        _equal(got.odom.pose, odom.pose, f"tick {t}: odom pose")
        _equal(got.odom.wheels, odom.wheels, f"tick {t}: odom wheels")
        _equal(got.twist, twist, f"tick {t}: twist")
    else:
        assert got.odom is None and got.twist is None


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("name,over", CASES)
def test_plain_tick_is_the_inline_chain(name, over, batch):
    """``reference_tick`` and ``step`` on CPU tensors give the inline
    chain's bits, tick after tick, with every draw in play."""
    scn = get_scenario(name)
    wcfg = dataclasses.replace(scn.world_config(), **over)
    dtype = torch.float64 if name == "course12_tuned" else torch.float32
    params = _params(scn, dtype, noisy=True)
    g = torch.Generator()
    g.manual_seed(5)
    state = driver.init_sense(params, dtype, batch)
    cmds = driver.command_twist(scn, 2, dtype, "cpu")
    launches = sim_tick.step.launches
    for t in range(2):
        noise = tw.draw_tick_noise(g, batch, scn.sim_substeps, wcfg.num_rays,
                                   len(scn.tubes), dtype)
        want = _inline_chain(scn, wcfg, params, state, cmds[t], noise)
        for fn in (sim_tick.reference_tick, sim_tick.step):
            got = fn(wcfg, params, state.world, cmds[t], scn.dt, noise,
                     scn.sim_substeps, state.odom)
            _assert_tick_equal(got, *want, t)
        alone = sim_tick.step(wcfg, params, state.world, cmds[t], scn.dt,
                              noise, scn.sim_substeps)
        _assert_tick_equal(alone, *want[:2], None, None, t)
        state = driver.SenseState(world=want[0], odom=want[2])
    assert sim_tick.step.launches == launches


def _no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel was built or launched")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(sim_tick, "library", refuse)


def _tick_args(dtype=torch.float32, B=2, name="lidar20_full"):
    scn = get_scenario(name)
    params = scn.world_params(dtype, "cpu")
    state = driver.init_sense(params, dtype, (B,))
    g = torch.Generator()
    g.manual_seed(0)
    noise = driver.draw_noise(scn, g, (B,), dtype)
    cmd = driver.command_twist(scn, 1, dtype, "cpu")[0]
    return [scn.world_config(), params, state.world, cmd, scn.dt, noise,
            scn.sim_substeps, state.odom]


def _half(args):
    world = args[2]
    return world._replace(
        drive=dd.DiffDriveState(*(f.half() for f in world.drive)),
        cmd_wheels=world.cmd_wheels.half())


@pytest.mark.parametrize("case,match", [
    ("half", "must be torch.float32 or torch.float64"),
    ("mixed_dtype", "slip must be torch.float32"),
    ("pose_shape", r"pose must be torch.float32 \(2, 3\)"),
    ("odom_batch", r"odom_wheels must be torch.float32 \(2, 2\)"),
    ("scan_rays", r"scan must be torch.float32 \(2, 360\)"),
    ("cmd_shape", r"cmd must be torch.float32 \(2, 3\)"),
    ("too_few_substeps", "the draws hold 5 substeps, the tick runs 6"),
    ("too_many_tubes", "with 1 <= K <= 64"),
    ("tensor_dt", "dt must be a number"),
])
def test_the_kernel_refuses_what_it_does_not_take(monkeypatch, case, match):
    """An operand the kernel does not take is refused before any build:
    the wrapper never falls back to the plain chain on its own."""
    _no_build(monkeypatch)
    args = _tick_args()
    cfg, params, world, cmd, dt, noise, substeps, odom = args
    if case == "half":
        args[2] = _half(args)
    elif case == "mixed_dtype":
        args[5] = noise._replace(slip=noise.slip.double())
    elif case == "pose_shape":
        args[2] = world._replace(drive=world.drive._replace(
            pose=world.drive.pose[:, :2].contiguous()))
    elif case == "odom_batch":
        args[7] = odom._replace(wheels=odom.wheels[:1])
    elif case == "scan_rays":
        args[5] = noise._replace(scan=noise.scan[:, :180])
    elif case == "cmd_shape":
        args[3] = torch.stack([cmd] * 3)
    elif case == "too_few_substeps":
        args[6] = 6
    elif case == "too_many_tubes":
        args[1] = params._replace(tube_locs=torch.zeros(65, 2))
    else:
        args[4] = torch.tensor(dt)
    with pytest.raises(ValueError, match=match):
        sim_tick._launch(*args)


def test_operands_take_what_the_chain_reads():
    """The drivers' operands pass the checks in both dtypes, one batch or
    none, with or without the odometry; a channel that is off does not
    need its draws."""
    for dtype in (torch.float32, torch.float64):
        args = _tick_args(dtype)
        args[0] = dataclasses.replace(args[0], compute_fake_sensor=True)
        ops = sim_tick.operands(*args)
        assert set(ops) == set(sim_tick.IN)
        assert all(t.dtype == dtype for t in ops.values())
        cfg = dataclasses.replace(args[0], compute_scan=False,
                                  compute_fake_sensor=False)
        no_scan = args[5]._replace(scan=None, scan_keep=None,
                                   marker_keep=None)
        ops = sim_tick.operands(cfg, *args[1:5], no_scan, *args[6:7])
        assert {"scan", "scan_keep", "odom_pose", "odom_wheels",
                "marker_keep"}.isdisjoint(ops)
    one = _tick_args(B=1)
    world = tw.WorldState(
        drive=dd.DiffDriveState(one[2].drive.pose[0], one[2].drive.wheels[0]),
        cmd_wheels=one[2].cmd_wheels[0])
    noise = tw.TickNoise(*(f[0] for f in one[5]))
    odom = dd.DiffDriveState(one[7].pose[0], one[7].wheels[0])
    ops = sim_tick.operands(one[0], one[1], world, one[3], one[4], noise,
                            one[6], odom)
    assert ops["pose"].shape == (3,) and ops["scan"].shape == (360,)


def test_launch_flags_follow_the_config():
    f = sim_tick.flags
    assert f(get_scenario("lidar20_full").world_config(), True) == \
        sim_tick.SCAN | sim_tick.ODOM
    assert f(get_scenario("course12_tuned").world_config(), False) == \
        sim_tick.MULTIPLICATIVE | sim_tick.FAKE
    quirks = dataclasses.replace(get_scenario("lidar20_tuned")
                                 .world_config(),
                                 reference_lidar_quirks=True)
    assert f(quirks, True) == (sim_tick.QUIRKS | sim_tick.MULTIPLICATIVE
                               | sim_tick.SCAN | sim_tick.ODOM)


def test_operand_order_and_sizes_agree_with_the_source():
    """The pointer arrays' order is the source's In and Out enums; the
    tube table's size and the flags are the source's."""
    src = (Path(sim_tick.__file__).resolve().parents[2] / "csrc"
           / "sim_tick.cu").read_text()

    def enum(name):
        body = re.search(rf"enum {name} {{(.*?)}};", src, re.S).group(1)
        return [w.strip() for w in body.split(",") if w.strip()][:-1]

    camel = lambda s: "k" + "".join(p.title() for p in s.split("_"))
    noise = {"twist", "slip", "scan", "marker_keep", "scan_keep"}
    assert enum("In") == [camel("n_" + k) if k in noise else camel(k)
                          for k in sim_tick.IN]
    assert enum("Out") == [camel(k) + "O" for k in sim_tick.OUT]
    m = re.search(r"constexpr int kMaxTubes = (\d+);", src)
    assert m and int(m.group(1)) == sim_tick.MAX_TUBES
    for flag in ("QUIRKS", "MULTIPLICATIVE", "SCAN", "FAKE", "ODOM"):
        m = re.search(rf"{camel(flag.lower())} = (\d+)", src)
        assert m and int(m.group(1)) == getattr(sim_tick, flag), flag
    assert _build.SIGNATURES["sim_tick"][0] == "sim_tick"


@pytest.mark.parametrize("name", ["lidar20_full", "loop5_known"])
def test_cpu_runs_take_the_plain_tick_and_never_build(monkeypatch, name):
    """The drivers and the staged producer reach the wrapper; on the CPU
    it runs the plain tick and builds nothing."""
    from shermbot_navigation_tpu_torch.pipeline import staged
    _no_build(monkeypatch)
    launches = sim_tick.step.launches
    calls = []
    plain = sim_tick.reference_tick
    monkeypatch.setattr(sim_tick, "reference_tick",
                        lambda *a: calls.append(a[7]) or plain(*a))
    scn = get_scenario(name)
    g = torch.Generator()
    g.manual_seed(1)
    driver.run_scenario_batch_lanes(scn, g, batch=2, steps=2, device="cpu")
    assert len(calls) == 2 and all(c is not None for c in calls)
    g.manual_seed(1)
    staged.make_staged_reference(scn, device="cpu")(g, 2)
    assert len(calls) == 4 and all(c is None for c in calls[2:])
    assert sim_tick.step.launches == launches


def test_a_compiled_caller_runs_the_launch_as_it_is(monkeypatch):
    """Under ``torch.compile`` (the compile entry) the wrapper leaves its
    launch to run eagerly, a graph break (dynamo cannot trace the ctypes
    call): a stand-in launch runs once a call, untraced, with the plain
    tick's bits."""
    args = _tick_args(B=3)
    traced = []

    def launch(*a):
        traced.append(torch.compiler.is_compiling())
        return sim_tick.reference_tick(*a)

    monkeypatch.setattr(sim_tick, "wants_kernel", lambda x: True)
    monkeypatch.setattr(sim_tick, "_launch", launch)
    want = sim_tick.reference_tick(*args)
    got = torch.compile(sim_tick.step, backend="eager")(*args)
    assert traced == [False]
    _assert_tick_equal(got, *want, 0)


def test_importing_the_drivers_leaves_dynamo_unloaded():
    """``torch._dynamo`` takes seconds to import, and the benchmark's
    set-up imports the drivers: no module on their path may load it."""
    import subprocess
    import sys
    code = ("import sys; import shermbot_navigation_tpu_torch.pipeline."
            "driver, shermbot_navigation_tpu_torch.pipeline.staged; "
            "print('torch._dynamo' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
