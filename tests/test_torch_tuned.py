"""Config 3's quality mode, ``lidar20_tuned`` (nearest-neighbour
association, chi-square gates, wrapped innovations, multiplicative slip;
the JAX README's headline quality row), through both batched engines of
the port against the JAX reference on the CPU, f64, tick by tick, on the
JAX key tree's draws (``_torch_parity.replay_tick_noise``)."""

import dataclasses

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
from test_torch_driver import _diff, _run_both

B, T = 3, 60
NOISY = dict(scan_noise=1e-4)       # 0.1 mm of lidar range noise


@pytest.fixture(scope="module")
def noisy():
    """The JAX lanes run of ``lidar20_tuned`` with range noise (B, T) and
    the port's scenario and replayed draws for the same worlds."""
    jscn = dataclasses.replace(jget("lidar20_tuned"), **NOISY)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want = jdriver.run_scenario_batch_lanes(jscn, keys, T, jnp.float64)
    noise = replay_tick_noise(np.asarray(keys), T, jscn.sim_substeps, 360,
                              len(jscn.tubes), np.float64)
    return (want, dataclasses.replace(tget("lidar20_tuned"), **NOISY),
            tick_noise_from_numpy(noise))


def _held_tightly(got, want):
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    for f in ("true_pose", "odom_pose", "slam_pose", "nees"):
        assert _diff(got, want, f) <= 1e-10, f
    assert int(got.n_seen[:, -1].min()) >= 8


@pytest.mark.parametrize("engine", ["lanes", "vmapped"])
def test_lidar20_tuned_with_scan_noise_matches_jax(noisy, engine):
    """Both engines with range noise, B=3, T=60, against the JAX lanes
    run: the noise keeps every tube's moment matrix full rank, and the
    whole chain -- sim, clustering, circle fit, nearest association,
    filter -- agrees within 1e-10 at every tick (measured 2.4e-15 m; the
    JAX vmapped run is the JAX lanes run within 7.8e-16 m here, as the JAX
    package's own ``test_driver_lanes_matches_vmapped`` holds it).
    ``vmapped`` is the dense engine under ``torch.func.vmap``
    (``run_scenario_batch``)."""
    want, scn, noise = noisy
    run = (tdriver.run_scenario_batch_lanes if engine == "lanes"
           else tdriver.run_scenario_batch)
    _held_tightly(run(scn, noise, B, steps=T, dtype=torch.float64,
                      device="cpu"), want)


def test_lidar20_tuned_lanes_noise_free_matches_jax_for_40_ticks():
    """The scenario as registered (a noise-free lidar), B=3, T=40:
    simulator and odometry within 1e-12, ``n_seen`` equal at every tick,
    the SLAM pose within 1e-5 m (measured 3.1e-7 m). Not longer: a fully
    seen tube of a noise-free scan gives a moment matrix whose smallest
    eigenvalue is 0 up to rounding, so the fit turns ulp differences
    between XLA's and ATen's libm into centimetres on a rare cluster
    (``test_torch_driver.test_lidar20_full_lanes_matches_jax_tick_by_tick``),
    and nearest association carries such a fit into the map: at 200 ticks
    the SLAM poses are 0.106 m apart with ``n_seen`` still equal at every
    tick, while with range noise they stay within 6e-14 m."""
    got, want = _run_both("lidar20_tuned", 3, 40)
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    assert _diff(got, want, "true_pose") <= 1e-12
    assert _diff(got, want, "odom_pose") <= 1e-12
    assert _diff(got, want, "slam_pose") <= 1e-5
    assert int(got.n_seen[:, -1].min()) >= 8
