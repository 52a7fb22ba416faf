"""The tube-world simulator of the port (``sim/tube_world``) against the
JAX reference on the CPU, f64, atol 1e-12. The port takes its noise as
explicit standard draws; each test replays the JAX function's own key tree
with ``jax.random`` and hands the port the same numbers. The port is
batch-first: a batch of worlds goes through it at once and through
``jax.vmap`` of the JAX function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.sim import tube_world as jtw
from shermbot_navigation_tpu_torch.sim import tube_world as ttw
from shermbot_navigation_tpu_torch.utils import convert

ATOL = 1e-12
TUBES = [[0.5, 0.5], [-0.5, -0.5], [1.0, 1.0], [-1.0, -1.0], [-0.75, 0.75],
         [0.75, -0.75], [0.3, -0.1]]
NOISY = dict(twist_noise=0.01, scan_noise=0.004, sensor_dropout=0.3,
             scan_dropout=0.2, slip_min=0.9, slip_max=1.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(**over):
    return (jtw.default_params(TUBES, jnp.float64, **over),
            ttw.default_params(TUBES, torch.float64, "cpu", **over))


def _step_noise(keys):
    """The draws of JAX ``step_dynamics`` from each key of ``keys``."""
    kk = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    draw = jax.vmap(lambda k: jax.random.normal(k, (2,), jnp.float64))
    return ttw.StepNoise(twist=_t(draw(kk[:, 0])), slip=_t(draw(kk[:, 1])))


def _obs_noise(keys, n, K):
    """The draws of JAX ``observe`` from each key of ``keys``."""
    kk = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    return ttw.ObsNoise(
        scan=_t(jax.vmap(lambda k: jax.random.normal(
            k, (n,), jnp.float64))(kk[:, 0])),
        marker_keep=_t(jax.vmap(lambda k: jax.random.uniform(k, (K,)))(
            kk[:, 1])),
        scan_keep=_t(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
            kk[:, 2])))


def _states(B, seed):
    """B random world states as a vmapped JAX tree and the port's."""
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.uniform(-3, 3, (B, 1)),
                           rng.uniform(-1.2, 1.2, (B, 2))], -1)
    pose[0, 1:] = [0.5 + 0.1, 0.5]        # inside a tube's contact radius
    pose[1, 1:] = [0.3, -0.1 + 0.118]     # on the contact threshold
    wheels = rng.normal(size=(B, 2))
    cmd = wheels + rng.normal(scale=0.01, size=(B, 2))
    jst = jtw.WorldState(
        drive=jtw.dd.DiffDriveState(pose=jnp.asarray(pose),
                                    wheels=jnp.asarray(wheels)),
        cmd_wheels=jnp.asarray(cmd))
    return jst, convert.world_state_from_numpy(jax_to_numpy(jst), "cpu")


def _assert_state(got, want):
    w = convert.world_state_to_numpy(got)
    np.testing.assert_allclose(w["drive"]["pose"], want.drive.pose, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(w["drive"]["wheels"], want.drive.wheels,
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(w["cmd_wheels"], want.cmd_wheels, rtol=0,
                               atol=ATOL)


def _assert_obs(got, want):
    for f in ("joint_states", "fake_sensor", "scan", "true_pose"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f), rtol=0, atol=ATOL,
                                   err_msg=f)
    np.testing.assert_array_equal(got.fake_sensor_valid.numpy(),
                                  want.fake_sensor_valid)


def test_default_params_match_jax_in_both_dtypes():
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jp = jtw.default_params(dtype=jdt, tube_var=0.002)
        tp = ttw.default_params(dtype=tdt, device="cpu", tube_var=0.002)
        for k in jp._fields:
            g = getattr(tp, k)
            assert g.dtype == tdt
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(jp, k)), k)
    assert dataclasses.asdict(ttw.WorldConfig()) == dataclasses.asdict(
        jtw.WorldConfig())


@pytest.mark.parametrize("slip_mode", ["reference", "multiplicative"])
def test_step_dynamics_matches_jax(slip_mode):
    """Twist noise, the slip quirk, the collision slide (two worlds start
    in or on a tube's contact radius), both slip modes."""
    B = 6
    jp, tp = _params(**NOISY)
    jcfg = jtw.WorldConfig(slip_mode=slip_mode)
    tcfg = ttw.WorldConfig(slip_mode=slip_mode)
    jst, tst = _states(B, 0)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    cmd = np.array([0.3, 0.1, 0.0])
    for i in range(3):
        kk = jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
        jst = jax.vmap(lambda s, k: jtw.step_dynamics(
            jcfg, jp, s, jnp.asarray(cmd), 0.02, k))(jst, kk)
        tst = ttw.step_dynamics(tcfg, tp, tst, _t(cmd), 0.02,
                                _step_noise(kk))
        _assert_state(tst, jst)


def test_collision_nudge_fires_and_matches():
    jp, tp = _params()
    jst, tst = _states(4, 0)
    cfg = ttw.WorldConfig()
    moved = ttw._resolve_collisions(cfg, tp, tst.drive)
    want = jax.vmap(lambda d: jtw._resolve_collisions(jtw.WorldConfig(), jp,
                                                      d))(jst.drive)
    np.testing.assert_allclose(moved.pose.numpy(), want.pose, atol=ATOL)
    shift = (moved.pose - tst.drive.pose).abs().sum(-1)
    assert float(shift[0]) > 0.01 and float(shift[3]) == 0.0


@pytest.mark.parametrize("quirks", [False, True])
def test_observe_matches_jax_both_lidar_branches(quirks):
    """Fake sensor with dropout, lidar with noise and dropout, in the
    geometrically correct branch and in ``reference_lidar_quirks``."""
    B = 8
    jp, tp = _params(**NOISY)
    jcfg = jtw.WorldConfig(reference_lidar_quirks=quirks)
    tcfg = ttw.WorldConfig(reference_lidar_quirks=quirks)
    jst, tst = _states(B, 3)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    want = jax.jit(jax.vmap(lambda s, k: jtw.observe(jcfg, jp, s, k)))(
        jst, keys)
    got = ttw.observe(tcfg, tp, tst, _obs_noise(keys, 360, len(TUBES)))
    _assert_obs(got, want)
    hits = (got.scan <= 1.0).sum()
    assert int(hits) > 20                      # tubes were seen
    assert int((got.scan == 2.0).sum()) > 100  # and misses hold the sentinel


def test_observe_quirk_branch_sees_other_rays_than_the_correct_one():
    _, tp = _params()
    _, tst = _states(8, 3)
    z = ttw.ObsNoise(scan=torch.zeros(8, 360, dtype=torch.float64),
                     marker_keep=torch.ones(8, 7, dtype=torch.float64),
                     scan_keep=torch.ones(8, 360, dtype=torch.float64))
    a = ttw.observe(ttw.WorldConfig(), tp, tst, z).scan
    b = ttw.observe(ttw.WorldConfig(reference_lidar_quirks=True), tp, tst,
                    z).scan
    assert not torch.equal(a, b)


def test_observe_gated_channels_are_zero():
    jp, tp = _params()
    jst, tst = _states(3, 4)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    for kw in (dict(compute_scan=False), dict(compute_fake_sensor=False)):
        want = jax.vmap(lambda s, k: jtw.observe(jtw.WorldConfig(**kw), jp,
                                                 s, k))(jst, keys)
        got = ttw.observe(ttw.WorldConfig(**kw), tp, tst,
                          _obs_noise(keys, 360, len(TUBES)))
        _assert_obs(got, want)


def test_step_and_rollout_match_jax_single_world():
    """``step`` splits its key into a dynamics key and an observation key;
    ``rollout`` splits its key into one per step. One world, no batch."""
    jp, tp = _params(**NOISY)
    jcfg, tcfg = jtw.WorldConfig(), ttw.WorldConfig()
    T = 5
    rng = np.random.default_rng(5)
    cmds = np.concatenate([rng.uniform(-0.5, 0.5, (T, 1)),
                           rng.uniform(0, 0.2, (T, 1)), np.zeros((T, 1))],
                          -1)
    key = jax.random.PRNGKey(4)
    jfinal, jobs = jtw.rollout(jcfg, jp, jtw.init_state(jp, jnp.float64),
                               jnp.asarray(cmds), 0.02, key)
    kk = jax.vmap(lambda k: jax.random.split(k, 2))(jax.random.split(key, T))
    sn = _step_noise(kk[:, 0])
    on = _obs_noise(kk[:, 1], 360, len(TUBES))
    noise = ttw.TickNoise(twist=sn.twist[:, None], slip=sn.slip[:, None],
                          scan=on.scan, marker_keep=on.marker_keep,
                          scan_keep=on.scan_keep)
    tfinal, tobs = ttw.rollout(tcfg, tp, ttw.init_state(tp, torch.float64),
                               _t(cmds), 0.02, noise)
    _assert_state(tfinal, jfinal)
    _assert_obs(tobs, jobs)
    # and one step on its own
    js, jo = jtw.step(jcfg, jp, jtw.init_state(jp, jnp.float64),
                      jnp.asarray(cmds[0]), 0.02, jax.random.split(key, T)[0])
    first = ttw.TickNoise(*(f[0] for f in noise))
    ts, to = ttw.step(tcfg, tp, ttw.init_state(tp, torch.float64),
                      _t(cmds[0]), 0.02, first.substep(0), first.obs)
    _assert_state(ts, js)
    _assert_obs(to, jo)


def test_draw_tick_noise_shapes_and_generator():
    g = torch.Generator(device="cpu")
    g.manual_seed(3)
    a = ttw.draw_tick_noise(g, (4,), 5, 360, 20, torch.float64)
    g.manual_seed(3)
    b = ttw.draw_tick_noise(g, (4,), 5, 360, 20, torch.float64)
    assert [tuple(f.shape) for f in a] == [(4, 5, 2), (4, 5, 2), (4, 360),
                                           (4, 20), (4, 360)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(f.dtype == torch.float64 for f in a)
    assert 0.0 <= float(a.scan_keep.min()) and float(a.scan_keep.max()) < 1.0
    assert tuple(a.substep(2).slip.shape) == (4, 2)


def test_world_state_round_trips_through_numpy():
    jst, tst = _states(3, 6)
    back = convert.world_state_to_numpy(tst)
    want = jax_to_numpy(jst)
    np.testing.assert_array_equal(back["cmd_wheels"], want["cmd_wheels"])
    np.testing.assert_array_equal(back["drive"]["pose"],
                                  np.asarray(jst.drive.pose))
