"""The port's staged pipeline (``pipeline/staged``) against the JAX
package's, on the CPU.

The JAX staged programs walk their own key tree (``staged.py``: each tick
``key, k_sub = split(key)``, then ``k_obs, *subkeys = split(k_sub, S +
1)``; each substep key splits in two inside ``step_dynamics``, ``k_obs``
in three inside ``observe``), which differs from ``sense_tick``'s tree
that ``_torch_parity.replay_tick_noise`` walks; :func:`replay_staged_noise`
walks it with ``jax.random`` itself and hands the port the same draws.

Tolerances: the sequential oracle in f64 against JAX's at 1e-10 on every
pose and NEES, ``n_seen`` exactly (``tests/test_torch_driver.py``'s
bounds for the same stages unstaged; ``lidar20_full`` with 0.1 mm of
range noise, as there, so every moment matrix has full rank); the staged
rollout against its oracle bit for bit (on the CPU the stages run in
order: the same operations on the same inputs); the latency and tracking
checks are ``tests/test_staged.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import tick_noise_from_numpy
from shermbot_navigation_tpu.pipeline import staged as jstaged
from shermbot_navigation_tpu.pipeline.config import get_scenario as jget
from shermbot_navigation_tpu_torch.pipeline import driver, staged
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim.tube_world import TickNoise


def replay_staged_noise(key, ticks, substeps, num_rays, num_tubes,
                        dtype=np.float64) -> dict:
    """The draws of the JAX staged programs from ``key`` over ``ticks``,
    as numpy arrays with a leading T in the layout of ``TickNoise``."""
    jdt = jnp.dtype(dtype)

    def tick(key, _):
        key, k_sub = jax.random.split(key)
        k_obs, *sub = jax.random.split(k_sub, substeps + 1)
        pairs = [jax.random.split(k, 2) for k in sub]
        k_lidar, k_drop_m, k_drop_s = jax.random.split(k_obs, 3)
        return key, dict(
            twist=jnp.stack([jax.random.normal(p[0], (2,), jdt)
                             for p in pairs]),
            slip=jnp.stack([jax.random.normal(p[1], (2,), jdt)
                            for p in pairs]),
            scan=jax.random.normal(k_lidar, (num_rays,), jdt),
            marker_keep=jax.random.uniform(k_drop_m, (num_tubes,)
                                           ).astype(jdt),
            scan_keep=jax.random.uniform(k_drop_s, (num_rays,)).astype(jdt))

    out = jax.jit(lambda k: jax.lax.scan(tick, k, None, length=ticks)[1])(
        key)
    return {k: np.asarray(v) for k, v in out.items()}


def _scenarios(name):
    over = {"scan_noise": 1e-4} if name == "lidar20_full" else {}
    return (dataclasses.replace(jget(name), **over),
            dataclasses.replace(get_scenario(name), **over))


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("name", ["lidar20_full", "loop5_known"])
def test_staged_reference_matches_jax(name):
    T = 15
    jscn, tscn = _scenarios(name)
    key = jax.random.PRNGKey(3)
    want = jstaged.staged_reference(jscn, key, T, jnp.float64)
    noise = tick_noise_from_numpy(replay_staged_noise(
        key, T, jscn.sim_substeps, jscn.world_config().num_rays,
        len(jscn.tubes)))
    got = staged.staged_reference(tscn, noise, T, torch.float64, "cpu")
    np.testing.assert_array_equal(got.n_seen.numpy(), want.n_seen)
    assert int(got.n_seen[-1]) >= 5
    for f in ("true_pose", "odom_pose", "slam_pose", "nees"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-10, err_msg=f)


@pytest.mark.parametrize("name", ["lidar20_full", "loop5_known"])
def test_staged_rollout_equals_its_oracle(name):
    scn = get_scenario(name)
    got = staged.make_staged_rollout(scn, device="cpu")(_gen(3), 15)
    ref = staged.staged_reference(scn, _gen(3), 15, device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    # a precomputed sequence gives the generator's run
    g = _gen(3)
    ticks = [driver.draw_noise(scn, g) for _ in range(15)]
    seq = TickNoise(*(torch.stack(f) for f in zip(*ticks)))
    again = staged.make_staged_rollout(scn, device="cpu")(seq, 15)
    assert torch.equal(again.slam_pose, got.slam_pose)


def test_two_stages_only():
    with pytest.raises(ValueError, match="2-stage"):
        staged.make_staged_rollout(get_scenario("loop5_known"), stages=3,
                                   device="cpu")


def test_one_tick_topic_latency():
    """The consumer's first tick takes the EMPTY packet: no landmarks,
    and tick t pairs the estimate with the truth at production time
    t - 1."""
    scn = get_scenario("loop5_known")
    out = staged.make_staged_rollout(scn, device="cpu")(_gen(0), 10)
    ref = staged.staged_reference(scn, _gen(0), 10, device="cpu")
    assert int(out.n_seen[0]) == 0
    assert int(out.n_seen[2]) > 0
    assert float(out.true_pose[0].abs().max()) == 0.0
    assert float(out.true_pose[2].abs().max()) > 0.0
    # tick t's truth is the oracle's tick-t packet: the pose produced at
    # t - 1, which the unstaged driver reports at t - 1
    fused = driver.run_scenario(scn, _gen(0), device="cpu", steps=10)
    assert torch.equal(out.true_pose[1:], fused.true_pose[:-1])
    assert torch.equal(ref.true_pose, out.true_pose)


def test_staged_estimates_track_truth():
    scn = get_scenario("loop5_known")
    out = staged.make_staged_rollout(scn, device="cpu")(_gen(1), 120)
    err = np.linalg.norm(out.slam_pose[20:, 1:].numpy()
                         - out.true_pose[20:, 1:].numpy(), axis=-1)
    assert np.isfinite(err).all()
    assert err.mean() < 0.25, err.mean()
