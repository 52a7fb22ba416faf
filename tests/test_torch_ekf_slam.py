"""The port's dense EKF engine (models/ekf_slam.py) against the JAX
reference's, in f64 on the CPU: the same numpy inputs through both.

Tolerances: the two f64 implementations differ only in summation order
(the five-term ``Sigma H^T`` combinations, 3-term matmuls), so states agree
to rtol 1e-12 with atol 1e-12 (the unseen-landmark priors are INT_MAX =
2.1e9, so entries span 20 orders of magnitude and a relative bound is the
honest one); association decisions (outcome, slot, ``seen``, ``n_seen``)
must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.utils import convert

RTOL, ATOL = 1e-12, 1e-12
Q3 = np.diag([1e-3, 2e-3, 1.5e-3])
R2 = np.diag([1e-3, 1e-3])


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _states_close(got, want: dict, rtol=RTOL, atol=ATOL):
    for k, w in want.items():
        g = getattr(got, k).numpy()
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            _close(g, w, rtol, atol, k)


def _both(state: dict):
    """A numpy state as (JAX EKFState, port EKFState)."""
    return (jekf.EKFState(**{k: jnp.asarray(v) for k, v in state.items()}),
            convert.ekf_state_from_numpy(state, "cpu"))


def _served(N, n_init, seed=1, pad=0):
    """A JAX f64 dense state with ``n_init`` landmarks initialized through
    ``step_measurement`` at random points, and a few predicts so the
    robot block correlates with the map; as numpy fields."""
    cfg = jekf.EKFConfig(num_landmarks=N, pad_state_to=pad)
    rng = np.random.default_rng(seed)
    st = jekf.init(cfg, jnp.array([0.1, 0.2, -0.1]), dtype=jnp.float64)
    for _ in range(n_init):
        st = jekf.predict(cfg, st, jnp.asarray(rng.uniform(-0.1, 0.1, 3)),
                          jnp.asarray(Q3))
        z = jnp.asarray(rng.uniform([0.5, -3], [2.0, 3]))
        st, _ = jekf.step_measurement(cfg, st, z, jnp.bool_(True),
                                      jnp.bool_(False), jnp.asarray(R2))
    return jax_to_numpy(st)


@pytest.mark.parametrize("twist", [[0.3, 0.2, 0.0], [0.0, 0.2, 0.0]])
def test_predict_matches_jax_and_dense_oracle(twist):
    """Both the arc and the dth == 0 branch; the strip form equals the
    literal dense A Sigma A^T + Qbar (both packages)."""
    N = 5
    cfg_j, cfg_t = jekf.EKFConfig(num_landmarks=N), tekf.EKFConfig(
        num_landmarks=N)
    js, ts = _both(_served(N, 3))
    want = jax_to_numpy(jekf.predict(cfg_j, js, jnp.asarray(twist),
                                     jnp.asarray(Q3)))
    tw, Q = torch.tensor(twist, dtype=torch.float64), torch.from_numpy(Q3)
    got = tekf.predict(cfg_t, ts, tw, Q)
    _states_close(got, want)
    oracle = tekf.predict_dense(cfg_t, ts, tw, Q)
    _states_close(oracle, jax_to_numpy(jekf.predict_dense(
        cfg_j, js, jnp.asarray(twist), jnp.asarray(Q3))))
    _close(got.cov.numpy(), oracle.cov.numpy(), rtol=1e-12, atol=1e-15)
    assert not torch.equal(ts.cov, got.cov)          # the input is untouched


def test_update_off_matches_jax_and_dense_oracle():
    """``pallas_update='off'`` against JAX for each seen slot, the port's
    sparse update against its literal dense oracle, and the innovation."""
    N = 6
    for sym in (True, False):
        cfg_j = jekf.EKFConfig(num_landmarks=N, pallas_update="off",
                               symmetrize=sym)
        cfg_t = tekf.EKFConfig(num_landmarks=N, pallas_update="off",
                               symmetrize=sym)
        state = _served(N, 4, seed=3)
        js, ts = _both(state)
        for j in np.flatnonzero(state["seen"]):
            z = np.array([1.1, 0.4 - 0.3 * j])
            want = jax_to_numpy(jekf.update(cfg_j, js, jnp.asarray(z), j,
                                            jnp.asarray(R2)))
            got = tekf.update(cfg_t, ts, torch.from_numpy(z), int(j),
                              torch.from_numpy(R2))
            _states_close(got, want)
            dense = tekf.update_dense(cfg_t, ts, torch.from_numpy(z),
                                      int(j), torch.from_numpy(R2))
            _close(dense.mean.numpy(), got.mean.numpy(), 1e-9, 1e-12)
            _close(jax_to_numpy(jekf.update_dense(
                cfg_j, js, jnp.asarray(z), j, jnp.asarray(R2)))["cov"],
                dense.cov.numpy(), 1e-9, 1e-12)
            for g, w in zip(tekf.innovation(cfg_t, ts, torch.from_numpy(z),
                                            int(j), torch.from_numpy(R2)),
                            jekf.innovation(cfg_j, js, jnp.asarray(z), j,
                                            jnp.asarray(R2))):
                _close(g.numpy(), w)
            _close(tekf.predicted_measurement(ts, int(j)).numpy(),
                   jekf.predicted_measurement(js, j))


def test_update_apply_flag_is_an_exact_select():
    """``apply=False`` returns the input state bitwise, ``apply=True`` the
    plain update, on both routes (the 'on' route's plain version here)."""
    N = 6
    state = _served(N, 3, seed=4, pad=128)
    for mode in ("off", "on"):
        cfg = tekf.EKFConfig(num_landmarks=N, pad_state_to=128,
                             pallas_update=mode)
        ts = convert.ekf_state_from_numpy(
            {k: v.astype(np.float32) if v.dtype == np.float64 else v
             for k, v in state.items()}, "cpu")
        z, R = torch.tensor([1.0, 0.5]), torch.from_numpy(R2).float()
        off = tekf.update(cfg, ts, z, 1, R, apply=torch.tensor(False))
        assert torch.equal(off.mean, ts.mean) and torch.equal(off.cov, ts.cov)
        on = tekf.update(cfg, ts, z, 1, R, apply=torch.tensor(True))
        ref = tekf.update(cfg, ts, z, 1, R)
        assert torch.equal(on.mean, ref.mean) and torch.equal(on.cov, ref.cov)


@pytest.mark.parametrize("N", [6, 300])
def test_init_landmark_and_analytic_init_cov(N):
    """D = 15 and D = 603, on both sides of the JAX package's
    ``_ONEHOT_MAX_D = 512`` branch (one-hot rewrite below, slice writes
    above): the port's slice writes match both, slot by slot."""
    cfg_j, cfg_t = jekf.EKFConfig(num_landmarks=N), tekf.EKFConfig(
        num_landmarks=N)
    assert (cfg_t.dim <= 512) == (N == 6)
    js, ts = _both(_served(N, 3, seed=5))
    z = np.array([0.9, -0.7])
    for j in (0, 3, N // 2, N - 1):
        want_mean = jekf.init_landmark(cfg_j, js, jnp.asarray(z), j).mean
        got = tekf.init_landmark(cfg_t, ts, torch.from_numpy(z), j)
        _close(got.mean.numpy(), want_mean)
        want = jekf._analytic_init_cov(
            jekf.init_landmark(cfg_j, js, jnp.asarray(z), j),
            jnp.asarray(z), j, jnp.asarray(R2))
        cov = tekf._analytic_init_cov(got, torch.from_numpy(z), j,
                                      torch.from_numpy(R2))
        _close(cov.numpy(), want)
    assert torch.equal(ts.cov, convert.ekf_state_from_numpy(
        jax_to_numpy(js), "cpu").cov)              # the input is untouched
    _close(tekf._slot_cols(ts.cov, torch.tensor(2)).numpy(),
           jekf._slot_cols(js.cov, 2, jekf._slot_onehot(cfg_j.dim, 2,
                                                         jnp.float64)))


def _assoc_state(N, n_seen):
    """``n_seen`` landmarks initialized at well-separated points."""
    cfg = jekf.EKFConfig(num_landmarks=N)
    st = jekf.init(cfg, jnp.array([0.0, 0.0, 0.0]), dtype=jnp.float64)
    for k in range(n_seen):
        z = jnp.array([1.0 + 0.5 * k, -2.0 + 1.3 * k])
        st, _ = jekf.step_measurement(cfg, st, z, jnp.bool_(True),
                                      jnp.bool_(False), jnp.asarray(R2))
    return jax_to_numpy(st)


ASSOC_CASES = {
    # exact revisit of landmark 1 -> match at slot 1
    "match": (4, 3, [1.5, -0.7], jekf.ASSOC_MATCH, 1),
    # landmark 1 seen 4 cm long -> between the gates
    "skip": (4, 3, [1.54, -0.7], jekf.ASSOC_SKIP, 3),
    # far from every landmark -> new at slot n_seen
    "new": (4, 3, [0.8, 2.5], jekf.ASSOC_NEW, 3),
    # the same far point on a full map -> overflow
    "overflow": (3, 3, [0.8, 2.5], jekf.ASSOC_OVERFLOW, 2),
    # nothing seen yet -> new at slot 0
    "empty": (3, 0, [0.8, 2.5], jekf.ASSOC_NEW, 0),
}


@pytest.mark.parametrize("mode", ["first_hit", "nearest"])
@pytest.mark.parametrize("case", list(ASSOC_CASES))
def test_associate_matches_jax(mode, case):
    N, n_seen, z, outcome, index = ASSOC_CASES[case]
    state = _assoc_state(N, n_seen)
    js, ts = _both(state)
    cfg_j = jekf.EKFConfig(num_landmarks=N, assoc_mode=mode)
    cfg_t = tekf.EKFConfig(num_landmarks=N, assoc_mode=mode)
    want = jekf.associate(cfg_j, js, jnp.asarray(z), jnp.asarray(R2))
    got = tekf.associate(cfg_t, ts, torch.tensor(z, dtype=torch.float64),
                         torch.from_numpy(R2))
    assert (int(got.outcome), int(got.index)) == (int(want.outcome),
                                                  int(want.index))
    assert (int(got.outcome), int(got.index)) == (outcome, index)
    assert got.outcome.dtype == got.index.dtype == torch.int32
    _close(got.distances.numpy(), want.distances, rtol=1e-10, atol=1e-12)


def _tick_inputs(T, M, seed):
    rng = np.random.default_rng(seed)
    twists = rng.uniform(-0.05, 0.05, (T, 3))
    zs = np.stack([rng.uniform(0.3, 1.0, (T, M)),
                   rng.uniform(-3, 3, (T, M))], axis=-1)
    valid = rng.uniform(size=(T, M)) < 0.85
    return twists, zs, valid


def test_known_association_step_matches_jax_with_sticky_stop():
    """Ticks with a negative id (a plain no-op) and an id >= N (stops the
    rest of its tick, valid or not), checked tick by tick."""
    N, M, T = 6, 4, 5
    twists, zs, valid = _tick_inputs(T, M, seed=7)
    ids = np.array([[0, 1, 2, 3], [4, -1, 1, 5], [2, N, 0, 3],
                    [N + 3, 1, 2, 4], [5, 3, -2, 0]], np.int32)
    cfg_j, cfg_t = jekf.EKFConfig(num_landmarks=N), tekf.EKFConfig(
        num_landmarks=N)
    js = jekf.init(cfg_j, jnp.array([0.1, 0.2, -0.1]), dtype=jnp.float64)
    ts = tekf.init(cfg_t, [0.1, 0.2, -0.1], dtype=torch.float64,
                   device="cpu")
    for t in range(T):
        args = (twists[t], zs[t], valid[t], ids[t], Q3, R2)
        js = jekf.known_association_step(cfg_j, js, *map(jnp.asarray, args))
        before = ts
        ts = tekf.known_association_step(cfg_t, ts, *map(torch.from_numpy,
                                                          args))
        _states_close(ts, jax_to_numpy(js), rtol=1e-10, atol=1e-12)
        if t == 3:
            # stopped at its first measurement: the map is as before
            assert torch.equal(ts.mean[3:], before.mean[3:])
            assert torch.equal(ts.seen, before.seen)


def test_step_unknown_matches_jax_with_overflow():
    """Unknown association over ticks that match, skip, create and -- with
    N=4 and more distinct points than slots -- overflow (sticky stop)."""
    N, M, T = 4, 3, 5
    rng = np.random.default_rng(11)
    world = rng.uniform(-1, 1, (7, 2))
    twists = rng.uniform(-0.02, 0.02, (T, 3))
    zs = np.zeros((T, M, 2))
    for t in range(T):
        for k in range(M):
            p = world[(2 * t + k) % 7] + rng.normal(0, 1e-4, 2)
            zs[t, k] = [np.hypot(*p), np.arctan2(p[1], p[0])]
    valid = np.ones((T, M), bool)
    valid[1, 2] = False
    cfg_j, cfg_t = jekf.EKFConfig(num_landmarks=N), tekf.EKFConfig(
        num_landmarks=N)
    js = jekf.init(cfg_j, jnp.zeros(3), dtype=jnp.float64)
    ts = tekf.init(cfg_t, [0.0, 0.0, 0.0], dtype=torch.float64,
                   device="cpu")
    for t in range(T):
        args = (twists[t], zs[t], valid[t], Q3, R2)
        js = jekf.step(cfg_j, js, *map(jnp.asarray, args))
        ts = tekf.step(cfg_t, ts, *map(torch.from_numpy, args))
        _states_close(ts, jax_to_numpy(js), rtol=1e-10, atol=1e-12)
    assert int(ts.n_seen) == N                   # the map filled up


def test_step_measurement_outputs_match_jax():
    """One measurement at a time, with the stop flag in and out."""
    N = 3
    state = _assoc_state(N, 3)
    js, ts = _both(state)
    cfg_j, cfg_t = jekf.EKFConfig(num_landmarks=N), tekf.EKFConfig(
        num_landmarks=N)
    for z, stopped in (([1.5, -0.7], False), ([0.8, 2.5], False),
                       ([1.5, -0.7], True)):
        a, sa = jekf.step_measurement(cfg_j, js, jnp.asarray(z),
                                      jnp.bool_(True), jnp.bool_(stopped),
                                      jnp.asarray(R2))
        b, sb = tekf.step_measurement(
            cfg_t, ts, torch.tensor(z, dtype=torch.float64), True, stopped,
            torch.from_numpy(R2))
        assert bool(sa) == bool(sb)
        _states_close(b, jax_to_numpy(a))
    assert bool(sb) and torch.equal(b.cov, ts.cov)   # stopped: inert


def test_pallas_update_mode_routing():
    cfg = tekf.EKFConfig(num_landmarks=6, pallas_update="on")
    with pytest.raises(ValueError, match="D % 128"):
        tekf._pallas_update_mode(cfg, cfg.dim, torch.float32)
    pad = tekf.EKFConfig(num_landmarks=6, pad_state_to=128,
                         pallas_update="on")
    with pytest.raises(ValueError, match="f32"):
        tekf._pallas_update_mode(pad, pad.dim, torch.float64)
    assert tekf._pallas_update_mode(pad, pad.dim, torch.float32) == "fused"
    for mode in ("off", "auto"):
        c = tekf.EKFConfig(num_landmarks=6, pad_state_to=128,
                           pallas_update=mode)
        assert tekf._pallas_update_mode(c, c.dim, torch.float32) is None


def test_padded_dense_state_crosses_both_ways():
    """A padded f32 dense state at the serving size (N=2048, D=4224)
    crosses ``utils/convert`` unchanged, and the serving re-layout drops
    and restores the padded tail exactly."""
    from shermbot_navigation_tpu_torch.pipeline import serving
    N, D = 2048, 4224
    cfg = tekf.EKFConfig(num_landmarks=N, pad_state_to=D)
    want = jax_to_numpy(jekf.init(jekf.EKFConfig(num_landmarks=N,
                                                 pad_state_to=D),
                                  jnp.array([0.1, 0.2, -0.1]),
                                  dtype=jnp.float32))
    st = convert.ekf_state_from_numpy(want, "cpu")
    assert st.cov.shape == (D, D) and st.cov.dtype == torch.float32
    _states_close(st, want, 0, 0)
    _states_close(tekf.init(cfg, [0.1, 0.2, -0.1], device="cpu"), want, 0,
                  0)
    back = convert.ekf_state_to_numpy(st)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        assert back[k].dtype == want[k].dtype
    again = serving.state_to_dense(cfg, serving.state_from_dense(cfg, st))
    _states_close(again, want, 0, 0)
