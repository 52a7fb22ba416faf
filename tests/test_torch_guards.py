"""The port's NaN/inf tripwire (``utils/guards``) against the JAX
package's (``tests/test_guards.py``), on the CPU.

The tripwire is an observer: a checked run equals the unchecked one bit
for bit; a NaN planted in the process noise trips and names the EKF
field; a poisoned blocked tick on a 1 x 2 map mesh is named
(``mean_r``). The checked run against JAX's ``run_scenario_checked`` on
replayed noise, f64: poses within 1e-10 (``tests/test_torch_driver.py``'s
bound for the same run unchecked), ``n_seen`` exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import replay_tick_noise, tick_noise_from_numpy
from shermbot_navigation_tpu.pipeline.config import get_scenario as jget
from shermbot_navigation_tpu.utils import guards as jguards
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.parallel import blocked_ekf
from shermbot_navigation_tpu_torch.parallel import mesh as tmesh
from shermbot_navigation_tpu_torch.pipeline import driver, metrics
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim.tube_world import TickNoise
from shermbot_navigation_tpu_torch.utils import guards


def _gen(seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def test_checked_scenario_clean_run_matches_unchecked():
    scn = get_scenario("loop5_known")
    checked = guards.run_scenario_checked(scn, _gen(), device="cpu")
    raw = driver.run_scenario(scn, _gen(), device="cpu")
    for f in checked._fields:
        assert torch.equal(getattr(checked, f), getattr(raw, f)), f
    ate = float(metrics.ate(checked.slam_pose[:, 1:],
                            checked.true_pose[:, 1:]))
    assert ate < 0.06


def test_checked_scenario_nan_noise_trips_and_names_field():
    scn = dataclasses.replace(get_scenario("loop5_known"),
                              q_diag=(float("nan"), 0.1, 0.1))
    with pytest.raises(guards.NonFiniteError, match="ekf\\."):
        guards.run_scenario_checked(scn, _gen(), device="cpu", steps=20)


def test_check_finite_needs_a_checked_call():
    with pytest.raises(RuntimeError, match="checked"):
        guards.check_finite(torch.ones(2), "x")
    err, out = guards.checked(lambda x: (guards.check_finite(
        {"not": "a tensor"}, "d"), x + 1)[1])(torch.ones(2))
    err.throw()
    assert err.get() is None and torch.equal(out, torch.full((2,), 2.0))


def test_checked_blocked_tick_clean_and_poisoned():
    """N=32, M=4 on a 1 x 2 ``MapMesh`` (two local shards): a healthy
    tick passes and inits M slots; a NaN in the robot pose is named."""
    N, M, B = 32, 4, 1
    mesh = tmesh.make_mesh(data=1, map_=2, local_shards=2, device="cpu")
    cfg = EKFConfig(num_landmarks=N)
    step = blocked_ekf.make_sequential_step(cfg, M, "cpu", mesh=mesh)
    tick = guards.checked_blocked_tick(step)
    state = blocked_ekf.shard_state(blocked_ekf.init(cfg, B, device="cpu"),
                                    mesh)
    Q = torch.diag(torch.tensor([1e-4] * 3))
    R = torch.diag(torch.tensor([1e-3] * 2))
    tw = torch.zeros((B, 3))
    zs = torch.full((B, M, 2), 0.5)
    valid = torch.ones((B, M), dtype=torch.bool)
    ids = torch.arange(M, dtype=torch.int32).expand(B, M)

    bad = state._replace(mean_r=state.mean_r.clone(),
                         cov_mm=state.cov_mm.clone())
    bad.mean_r[:, 0, 0] = float("nan")
    err, out = tick(state, tw, zs, valid, ids, Q, R)
    err.throw()                                    # clean: no raise
    assert int(out.n_seen[0, 0]) == M
    err, _ = tick(bad, tw, zs, valid, ids, Q, R)
    with pytest.raises(guards.NonFiniteError, match="blocked.mean_r"):
        err.throw()


def test_checked_run_matches_jax_run_scenario_checked():
    """``course12_noisy`` (twist and slip noise, unknown association) for
    15 ticks on the JAX key tree replayed, f64."""
    T = 15
    jscn = dataclasses.replace(jget("course12_noisy"), steps=T)
    tscn = dataclasses.replace(get_scenario("course12_noisy"), steps=T)
    key = jax.random.PRNGKey(7)
    want = jguards.run_scenario_checked(jscn, key, jnp.float64)
    noise = replay_tick_noise(np.asarray(key)[None], T, jscn.sim_substeps,
                              360, len(jscn.tubes), np.float64)
    seq = TickNoise(*(f[:, 0] for f in tick_noise_from_numpy(noise)))
    got = guards.run_scenario_checked(tscn, seq, torch.float64, "cpu")
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    assert int(got.n_seen[-1]) >= 3
    for f in ("true_pose", "odom_pose", "slam_pose"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-10, err_msg=f)
