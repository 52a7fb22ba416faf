"""Kernel 7, the simulator's tick (``csrc/sim_tick.cu``), against the plain
chain on the card.

Marked ``requires_cuda``: the tests skip where there is no card. On the
card run them with

    python -m pytest tests/test_torch_sim_kernel.py -q --noconftest

Tolerance: none, but for one planted case. The kernel performs the plain
chain's operations one rounding at a time in its order (``__fmul_rn`` /
``__fadd_rn``, no FMA contraction; the CUDA math library's sin, cos,
atan2, IEEE sqrt and division, as PyTorch's elementwise kernels on the
card; a division by a host scalar as a product by its reciprocal, as
PyTorch on the card), so each world's pose, wheels, commanded wheels,
scan, fake sensor, odometry and twist are the plain chain's bits, tick
after tick, in float32 and float64. The exception is a world touching
three or more tubes at once: the kernel adds the collision terms in tube
order, ``torch.sum`` in its own, and a sum of three terms of at most
``collision_nudge`` = 0.02 may round its last bit otherwise (2 ulp of
0.06: 1.5e-8 m in float32). Over one tick's five substeps that stays
within POSE_TOL_3 = 1e-7 m; the scan is then held bit for bit to the
plain ``observe`` at the kernel's own pose.
"""

import dataclasses

import pytest
import torch

from shermbot_navigation_tpu_torch.ops.kernels import sim_tick
from shermbot_navigation_tpu_torch.pipeline import driver, staged
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim import tube_world as tw

NOISY = dict(twist_noise=0.01, scan_noise=0.004, sensor_dropout=0.3,
             scan_dropout=0.2)
POSE_TOL_3 = 1e-7


@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


def _outputs(r: sim_tick.SimTick) -> dict:
    return {"pose": r.world.drive.pose, "wheels": r.world.drive.wheels,
            "cmd_wheels": r.world.cmd_wheels, "scan": r.obs.scan,
            "fake_sensor": r.obs.fake_sensor,
            "fake_sensor_valid": r.obs.fake_sensor_valid,
            "joint_states": r.obs.joint_states, "true_pose": r.obs.true_pose,
            "odom_pose": r.odom.pose, "odom_wheels": r.odom.wheels,
            "twist": r.twist}


def _differs(plain: dict, fused: dict) -> dict:
    out = {}
    for k, a in plain.items():
        b = fused[k]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            d = (a.double() - b.double()).abs() if a.shape == b.shape \
                else torch.tensor(float("inf"))
            out[k] = (int((d > 0).sum()), float(d.max()))
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,B,dtype,over,noisy", [
    ("lidar20_full", 1024, torch.float32, {}, False),
    ("lidar20_full", 512, torch.float32, {}, True),
    ("course12_tuned", 512, torch.float32, {}, False),
    ("stock6", 512, torch.float32, {}, True),
    ("lidar20_full", 512, torch.float32, {"reference_lidar_quirks": True},
     True),
    ("stock6", 256, torch.float32,
     {"compute_scan": True, "reference_lidar_quirks": True}, True),
    ("lidar20_tuned", 512, torch.float64, {}, True),
    ("course12_tuned", 256, torch.float64,
     {"compute_scan": True, "reference_lidar_quirks": True}, True),
])
def test_kernel_tick_is_the_plain_tick(dev, name, B, dtype, over, noisy):
    """Two chains on the card, each on its own state, fed the same 8
    ticks of draws: every output the plain chain's bits after every
    tick."""
    scn = get_scenario(name)
    wcfg = dataclasses.replace(scn.world_config(), **over)
    params = scn.world_params(dtype, dev)
    if noisy:
        params = params._replace(**{k: torch.tensor(v, dtype=dtype,
                                                     device=dev)
                                    for k, v in NOISY.items()})
    g = torch.Generator(device=dev)
    g.manual_seed(B + len(over))
    T = 8
    cmds = driver.command_twist(scn, T, dtype, dev)
    start = driver.init_sense(params, dtype, (B,))
    plain = fused = (start.world, start.odom)
    launches = sim_tick.step.launches
    for t in range(T):
        noise = tw.draw_tick_noise(g, (B,), scn.sim_substeps, wcfg.num_rays,
                                   len(scn.tubes), dtype)
        p = sim_tick.reference_tick(wcfg, params, plain[0], cmds[t],
                                    scn.dt, noise, scn.sim_substeps,
                                    plain[1])
        f = sim_tick.step(wcfg, params, fused[0], cmds[t], scn.dt, noise,
                          scn.sim_substeps, fused[1])
        bad = _differs(_outputs(p), _outputs(f))
        assert not bad, f"tick {t}: (entries, largest) {bad}"
        plain, fused = (p.world, p.odom), (f.world, f.odom)
    assert sim_tick.step.launches - launches == T
    if wcfg.compute_scan:
        assert int((f.obs.scan <= 1.0).sum()) > 0, \
            "no ray met a tube: the test holds nothing"


@pytest.mark.requires_cuda
def test_planted_contacts(dev):
    """Worlds that start touching one, two or three tubes. One and two:
    the plain chain's bits; three: the pose within POSE_TOL_3 and the scan
    the plain ``observe``'s bits at the kernel's own pose."""
    scn = get_scenario("stock6")
    wcfg = dataclasses.replace(scn.world_config(), compute_scan=True)
    tubes = [[0.1, 0.0], [-0.1, 0.02], [0.0, 0.11], [0.6, 0.6]]
    params = scn.world_params(torch.float32, dev)._replace(
        tube_locs=torch.tensor(tubes, device=dev))
    # robots at the origin touch tubes 0-2; shifted ones touch fewer
    start = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.2, 0.0],
                          [0.5, -0.05, 0.07], [-0.2, 0.0, 0.02]], device=dev)
    B = start.shape[0]
    sense = driver.init_sense(params, torch.float32, (B,))
    world = sense.world._replace(drive=sense.world.drive._replace(
        pose=start))
    d = (params.tube_locs[None] - start[:, None, 1:]).norm(dim=-1)
    touching = (d <= 0.0381 + 0.08).sum(-1).tolist()
    assert touching == [3, 1, 2, 3], touching
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    noise = tw.draw_tick_noise(g, (B,), scn.sim_substeps, wcfg.num_rays,
                               len(tubes))
    cmd = driver.command_twist(scn, 1, device=dev)[0]
    p = sim_tick.reference_tick(wcfg, params, world, cmd, scn.dt, noise,
                                scn.sim_substeps, sense.odom)
    f = sim_tick.step(wcfg, params, world, cmd, scn.dt, noise,
                      scn.sim_substeps, sense.odom)
    few = torch.tensor([t < 3 for t in touching], device=dev)
    po, fo = _outputs(p), _outputs(f)
    bad = _differs({k: v[few] for k, v in po.items()},
                   {k: v[few] for k, v in fo.items()})
    assert not bad, f"one or two tubes: {bad}"
    for k in ("pose", "odom_pose", "wheels", "cmd_wheels", "twist"):
        err = float((po[k] - fo[k]).abs().max())
        assert err <= POSE_TOL_3, (k, err)
    again = tw.observe(wcfg, params, f.world, noise.obs)
    assert torch.equal(again.scan, f.obs.scan)


@pytest.mark.requires_cuda
def test_every_driver_launches_once_a_tick(dev):
    """The lanes engine, the dense engine, one world and the staged
    producer each launch kernel 7 once a tick on the card."""
    T = 3
    g = torch.Generator(device=dev)
    runs = [
        lambda: driver.run_scenario_batch_lanes(
            get_scenario("lidar20_full"), g, batch=64, steps=T, device=dev),
        lambda: driver.run_scenario_batch(get_scenario("course12_noisy"), g,
                                          batch=4, steps=T, device=dev),
        lambda: driver.run_scenario(get_scenario("stock6"), g, device=dev,
                                    steps=T),
        lambda: staged.make_staged_rollout(get_scenario("loop5_known"),
                                           device=dev)(g, T),
    ]
    for run in runs:
        g.manual_seed(12)
        launches = sim_tick.step.launches
        outs = run()
        torch.cuda.synchronize(dev)
        assert sim_tick.step.launches - launches == T
        assert bool(torch.isfinite(outs.true_pose).all())


@pytest.mark.requires_cuda
def test_a_float64_run_takes_the_kernel(dev):
    """The dense engine runs the sim in float64 on the card through the
    kernel, each world the plain chain's run."""
    scn = get_scenario("course12_noisy")
    f64 = torch.float64
    seq = [driver.draw_noise(scn, g, (3,), f64)
           for g in [torch.Generator(device=dev).manual_seed(2)]
           for _ in range(4)]
    noise = tw.TickNoise(*(torch.stack(f) for f in zip(*seq)))
    launches = sim_tick.step.launches
    got = driver.run_scenario_batch(scn, noise, batch=3, steps=4, dtype=f64,
                                    device=dev)
    assert sim_tick.step.launches - launches == 4
    from shermbot_navigation_tpu_torch.ops.kernels import plain_versions
    with plain_versions():
        want = driver.run_scenario_batch(scn, noise, batch=3, steps=4,
                                         dtype=f64, device=dev)
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.requires_cuda
def test_a_compiled_caller_launches_the_kernel(dev):
    """``torch.compile`` of a caller (as the compile entry does) leaves the
    launch to run as it is, with the eager call's bits."""
    scn = get_scenario("stock6")
    params = scn.world_params(device=dev)
    sense = driver.init_sense(params, torch.float32, (4,))
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    noise = driver.draw_noise(scn, g, (4,))
    cmd = driver.command_twist(scn, 1, device=dev)[0]
    args = (scn.world_config(), params, sense.world, cmd, scn.dt, noise,
            scn.sim_substeps, sense.odom)
    eager = _outputs(sim_tick.step(*args))
    launches = sim_tick.step.launches
    compiled = torch.compile(sim_tick.step, backend="eager")(*args)
    assert sim_tick.step.launches - launches == 1
    assert not _differs(eager, _outputs(compiled))
