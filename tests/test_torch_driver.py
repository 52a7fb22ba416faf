"""The pipeline driver of the port (``pipeline/driver``) against the JAX
reference on the CPU, f64, tick by tick, with identical noise: the JAX
driver's key tree is replayed with ``jax.random``
(``_torch_parity.replay_tick_noise``) and handed to the port as a
precomputed ``TickNoise`` sequence."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import replay_tick_noise, tick_noise_from_numpy
from shermbot_navigation_tpu.pipeline import driver as jdriver
from shermbot_navigation_tpu.pipeline.config import get_scenario as jget
from shermbot_navigation_tpu_torch.pipeline import driver as tdriver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario as tget
from shermbot_navigation_tpu_torch.sim.tube_world import TickNoise


def _run_both(name, B, T, seed=7, **replace):
    jscn = dataclasses.replace(jget(name), **replace)
    tscn = dataclasses.replace(tget(name), **replace)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    want = jdriver.run_scenario_batch_lanes(jscn, keys, T, jnp.float64)
    noise = replay_tick_noise(np.asarray(keys), T, jscn.sim_substeps, 360,
                              len(jscn.tubes), np.float64)
    got = tdriver.run_scenario_batch_lanes(
        tscn, tick_noise_from_numpy(noise), B, steps=T, dtype=torch.float64,
        device="cpu")
    return got, want


def _run_vmapped_both(name, B, T, seed=7):
    """JAX ``run_scenario_batch`` and the port's on the same replayed
    noise, f64."""
    jscn, tscn = jget(name), tget(name)
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    want = jdriver.run_scenario_batch(jscn, keys, T, jnp.float64)
    noise = replay_tick_noise(np.asarray(keys), T, jscn.sim_substeps, 360,
                              len(jscn.tubes), np.float64)
    got = tdriver.run_scenario_batch(
        tscn, tick_noise_from_numpy(noise), B, steps=T, dtype=torch.float64,
        device="cpu")
    return got, want


def _diff(got, want, field):
    return float(np.abs(getattr(got, field).numpy()
                        - np.asarray(getattr(want, field))).max())


def test_lidar20_full_lanes_matches_jax_tick_by_tick():
    """The slice as a whole: ``lidar20_full``, B=3, T=40. The simulator,
    odometry and the landmark counts match exactly. The SLAM pose and NEES
    are held to 1e-4: this scenario's lidar is noise-free, so a fully seen
    tube gives an exactly rank-deficient moment matrix (smallest eigenvalue
    ~1e-24, at the fit's 1e-12 singular-value threshold), where the fit
    turns ulp differences between XLA's and ATen's atan2/sin/cos into
    centimetres on a rare cluster (1 fit of 461 on these scans moves by
    4.5 cm; the reference's cross-engine record is 1 of 481). Measured:
    pose 2.8e-6, NEES 5.7e-5. The next test removes the degeneracy and
    holds the same pipeline to 1e-10."""
    got, want = _run_both("lidar20_full", 3, 40)
    assert got.true_pose.shape == (3, 40, 3) and got.nees.shape == (3, 40)
    assert _diff(got, want, "true_pose") <= 1e-12
    assert _diff(got, want, "odom_pose") <= 1e-12
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    assert int(got.n_seen[:, -1].min()) >= 8
    assert _diff(got, want, "slam_pose") <= 1e-4
    assert _diff(got, want, "nees") <= 1e-4 * max(
        1.0, float(np.abs(np.asarray(want.nees)).max()))


def test_lidar20_with_range_noise_matches_jax_tightly():
    """``lidar20_full`` with 0.1 mm of lidar range noise (replayed from the
    JAX keys like every other draw): full-rank moment matrices, and the
    whole chain -- sim, clustering, circle fit, first-hit association,
    filter -- agrees with JAX to 1e-10 at every tick."""
    got, want = _run_both("lidar20_full", 3, 30, scan_noise=1e-4)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _diff(got, want, f) <= 1e-10, f
    np.testing.assert_allclose(got.nees.numpy(), want.nees, rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("name", ["loop5_known", "course12_noisy"])
def test_configs_1_and_2_lanes_match_jax(name):
    """Configs 1 and 2 run through the same driver: one short f64 run
    each (known association without noise; unknown association with twist
    noise, slip and the fake sensor)."""
    got, want = _run_both(name, 3, 25)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _diff(got, want, f) <= 1e-12, f
    np.testing.assert_allclose(got.nees.numpy(), want.nees, rtol=1e-9,
                               atol=1e-12)
    assert int(got.n_seen[0, -1]) == len(tget(name).tubes)


def test_course12_tuned_lanes_matches_jax():
    """The tuned quality mode of config 2 (nearest-neighbour gating,
    wrapped innovations, multiplicative slip) through the lanes driver."""
    got, want = _run_both("course12_tuned", 3, 25)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _diff(got, want, f) <= 1e-12, f
    np.testing.assert_allclose(got.nees.numpy(), want.nees, rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["loop5_known", "course12_noisy"])
def test_run_scenario_batch_matches_jax(name):
    """``run_scenario_batch`` (the dense engine under ``torch.func.vmap``)
    against the JAX ``run_scenario_batch`` (``jax.vmap``), f64, B=3."""
    got, want = _run_vmapped_both(name, 3, 25)
    assert got.slam_pose.shape == (3, 25, 3) and got.n_seen.shape == (3, 25)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _diff(got, want, f) <= 1e-12, f
    np.testing.assert_allclose(got.nees.numpy(), want.nees, rtol=1e-9,
                               atol=1e-12)
    assert int(got.n_seen[0, -1]) == len(tget(name).tubes)


@pytest.mark.parametrize("name", ["course12_noisy", "loop5_known"])
def test_run_scenario_batch_matches_lanes(name):
    """The port's two batched engines on the same noise, f64, T=40 (the
    port's copy of the JAX package's ``test_driver_lanes_matches_vmapped``,
    at its tolerances). Under ``torch.func.vmap`` no op may fall back to a
    loop over the worlds (functorch warns of a "performance drop" when one
    does): such a loop would launch B times a tick on the card."""
    scn = tget(name)
    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    seq = TickNoise(*(torch.stack(f) for f in zip(*(
        tdriver.draw_noise(scn, g, (4,), torch.float64) for _ in range(40)))))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        a = tdriver.run_scenario_batch(scn, seq, 4, steps=40,
                                       dtype=torch.float64, device="cpu")
    b = tdriver.run_scenario_batch_lanes(scn, seq, 4, steps=40,
                                         dtype=torch.float64, device="cpu")
    assert torch.equal(a.n_seen, b.n_seen)
    assert torch.equal(a.true_pose, b.true_pose)
    np.testing.assert_allclose(a.slam_pose.numpy(), b.slam_pose.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(a.nees.numpy(), b.nees.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_run_scenario_batch_takes_a_generator_and_refuses_bad_noise():
    scn = tget("loop5_known")
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    outs = tdriver.run_scenario_batch(scn, g, 2, steps=3, device="cpu:0")
    assert outs.slam_pose.shape == (2, 3, 3)
    assert outs.slam_pose.dtype == torch.float32
    assert torch.isfinite(outs.slam_pose).all()
    with pytest.raises(TypeError, match="Generator or a TickNoise"):
        tdriver.run_scenario_batch(tget("loop5_known"), 0, 2, steps=1,
                                   device="cpu")


@pytest.mark.parametrize("name,T", [("lidar20_full", 12), ("stock6", 12)])
def test_run_scenario_single_world_matches_jax(name, T):
    """``run_scenario`` (one world, the dense engine): lidar perception
    with unknown association, and the fake sensor with unknown
    association. The lidar run gets 0.1 mm of range noise (see above)."""
    over = dict(steps=T)
    if name == "lidar20_full":
        over["scan_noise"] = 1e-4
    jscn = dataclasses.replace(jget(name), **over)
    tscn = dataclasses.replace(tget(name), **over)
    key = jax.random.PRNGKey(11)
    want = jdriver.run_scenario(jscn, key, jnp.float64)
    noise = replay_tick_noise(np.asarray(key)[None], T, jscn.sim_substeps,
                              360, len(jscn.tubes), np.float64)
    seq = TickNoise(*(f[:, 0] for f in tick_noise_from_numpy(noise)))
    got = tdriver.run_scenario(tscn, seq, dtype=torch.float64, device="cpu")
    assert got.slam_pose.shape == (T, 3)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    assert int(got.n_seen[-1]) >= 3
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _diff(got, want, f) <= 1e-10, f
    np.testing.assert_allclose(got.nees.numpy(), want.nees, rtol=1e-8,
                               atol=1e-10)


def test_batch_world_equals_single_world_run():
    """World b of a batched run on the batch-trailing engine equals a
    single-world run on the dense engine with the same noise (the two
    engines agree to rounding; the decisions are equal)."""
    scn = dataclasses.replace(tget("course12_noisy"), steps=15)
    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    seq = TickNoise(*(torch.stack(f) for f in zip(*(
        tdriver.draw_noise(scn, g, (2,), torch.float64)
        for _ in range(15)))))
    lanes = tdriver.run_scenario_batch_lanes(scn, seq, 2, dtype=torch.float64,
                                             device="cpu")
    for b in range(2):
        one = tdriver.run_scenario(scn, TickNoise(*(f[:, b] for f in seq)),
                                   dtype=torch.float64, device="cpu")
        assert torch.equal(one.n_seen, lanes.n_seen[b])
        np.testing.assert_allclose(one.slam_pose.numpy(),
                                   lanes.slam_pose[b].numpy(), atol=1e-9)
        assert torch.equal(one.true_pose, lanes.true_pose[b])


def test_generator_runs_are_reproducible_and_checked():
    scn = tget("lidar20_full")
    outs = []
    for _ in range(2):
        g = torch.Generator(device="cpu")
        g.manual_seed(9)
        seen = []
        outs.append(tdriver.run_scenario_batch_lanes(
            scn, g, 2, steps=4, device="cpu", margins=(m := {}),
            on_tick=lambda t, obs, zs, valid: seen.append(obs.scan.shape)))
        assert seen == [(2, 360)] * 4
        assert set(m) == {"split", "std", "gate"}
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert outs[0].slam_pose.dtype == torch.float32
    with pytest.raises(TypeError, match="Generator or a TickNoise"):
        tdriver.run_scenario_batch_lanes(scn, 0, 2, steps=1, device="cpu")


def test_gate_trace_gives_each_worlds_margin_every_tick():
    """The lanes driver's ``gate_trace``: one (B,) tensor a tick, each
    world's smallest relative gate margin; its minimum is the run's
    ``margins["gate"]``."""
    scn = tget("course12_noisy")
    g = torch.Generator(device="cpu")
    g.manual_seed(4)
    trace, margins = [], {}
    tdriver.run_scenario_batch_lanes(scn, g, 3, steps=12, device="cpu",
                                     margins=margins, gate_trace=trace)
    assert len(trace) == 12 and all(t.shape == (3,) for t in trace)
    trace = torch.stack(trace)
    assert torch.isfinite(trace[-1]).all() and (trace > 0).all()
    assert float(trace.min()) == float(margins["gate"])


def test_any_cpu_spelling_runs_the_lanes_driver():
    """``pipeline/driver``'s noise source compares its generator's device
    with the run's, both resolved: a ``cpu`` generator runs under
    ``device="cpu:0"``, a generator on another device is refused."""
    scn = tget("loop5_known")
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    outs = tdriver.run_scenario_batch_lanes(scn, g, 2, steps=3,
                                            device="cpu:0")
    assert outs.slam_pose.shape == (2, 3, 3)
    assert outs.slam_pose.device.type == "cpu"
    assert torch.isfinite(outs.slam_pose).all()
    with pytest.raises(ValueError, match="generator on cpu"):
        tdriver.run_scenario_batch_lanes(scn, g, 2, steps=1, device="meta")


def test_command_twist_and_init_pipeline_match_jax():
    jscn, tscn = jget("lidar20_full"), tget("lidar20_full")
    want = jdriver.command_twist(jscn, jnp.arange(5), jnp.float64)
    got = tdriver.command_twist(tscn, 5, torch.float64, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    jst = jdriver.init_pipeline(jscn, jnp.float64)
    tst = tdriver.init_pipeline(tscn, torch.float64, "cpu")
    np.testing.assert_array_equal(tst.filt.cov.numpy(), jst.filt.cov)
    np.testing.assert_array_equal(tst.world.cmd_wheels.numpy(),
                                  jst.world.cmd_wheels)
    bad = dataclasses.replace(tscn, command=("square", 1.0))
    with pytest.raises(ValueError, match="unknown command kind"):
        tdriver.command_twist(bad, 3, device="cpu")
