"""The batch-trailing engine of the port (``models/ekf_batch``) against the
JAX reference's ``models/ekf_batch`` on the CPU: the same random states
(the reference's own, ``tests/test_ekf_batch.py``), f64 at 1e-12 per
phase, decisions equal; the f32 gated-off pin; an f32 long horizon."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_state_close, jax_to_numpy
from shermbot_navigation_tpu.models import ekf_batch as jeb
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu_torch.models import ekf_batch as teb
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.utils import convert

N = 8
B = 16
Q3 = np.diag([0.01, 0.01, 0.01])
R2 = np.diag([0.001, 0.001])


def _t(x):
    return torch.from_numpy(np.array(x))


def _states(seed=0, n_seen=4, dtype=np.float64, **cfg_kw):
    """B random dense states, batch-trailing, in both packages."""
    rng = np.random.default_rng(seed)
    jcfg = jekf.EKFConfig(num_landmarks=N, **cfg_kw)
    tcfg = tekf.EKFConfig(num_landmarks=N, **cfg_kw)
    D = jcfg.dim
    mean = np.zeros((D, B))
    cov = np.zeros((D, D, B))
    k = 3 + 2 * n_seen
    for b in range(B):
        mean[:3, b] = rng.uniform(-1, 1, 3)
        mean[3:k, b] = rng.uniform(-2, 2, k - 3)
        A = rng.normal(size=(k, k)) * 0.05
        cov[:, :, b] = np.diag([0.0] * 3 + [jcfg.init_cov] * (2 * N))
        cov[:k, :k, b] = A @ A.T + 0.01 * np.eye(k)
    arrays = dict(mean=mean.astype(dtype), cov=cov.astype(dtype),
                  n_seen=np.full(B, n_seen, np.int32),
                  seen=np.broadcast_to((np.arange(N) < n_seen)[:, None],
                                       (N, B)).copy())
    jst = jeb.BatchState(**{k_: jnp.asarray(v) for k_, v in arrays.items()})
    return jcfg, tcfg, jst, convert.batch_state_from_numpy(arrays, "cpu")


def test_init_and_relayout_match_jax():
    jcfg, tcfg, jst, tst = _states()
    for pose in (None, [0.1, 0.2, -0.3]):
        want = jeb.init(jcfg, 5, None if pose is None else jnp.asarray(pose),
                        dtype=jnp.float64)
        got = teb.init(tcfg, 5, pose, dtype=torch.float64, device="cpu")
        assert_state_close(got, jax_to_numpy(want), 0)
    v = teb.to_vmapped(tst)
    assert_state_close(v, jax_to_numpy(jeb.to_vmapped(jst)), 0)
    back = teb.from_vmapped(v)
    assert all(torch.equal(a, b) for a, b in zip(back, tst))
    assert convert.batch_state_to_numpy(tst)["cov"].shape == (19, 19, B)


def test_predict_matches_jax():
    jcfg, tcfg, jst, tst = _states()
    tw = np.random.default_rng(1).uniform(-0.05, 0.05, (B, 3))
    tw[0, 0] = 0.0                                  # the dth == 0 branch
    want = jeb.predict(jcfg, jst, jnp.asarray(tw), jnp.asarray(Q3))
    got = teb.predict(tcfg, tst, _t(tw), _t(Q3))
    assert_state_close(got, jax_to_numpy(want), 1e-12)
    assert torch.equal(tst.cov, _t(np.asarray(jst.cov)))  # input untouched


@pytest.mark.parametrize("symmetrize,wrap", [(True, False), (False, True)])
def test_update_matches_jax(symmetrize, wrap):
    jcfg, tcfg, jst, tst = _states(symmetrize=symmetrize,
                                   wrap_innovation=wrap)
    rng = np.random.default_rng(2)
    j = rng.integers(0, 4, B).astype(np.int32)
    z = rng.uniform([0.3, -2], [1.5, 2], (B, 2))
    want = jeb.update(jcfg, jst, jnp.asarray(z), jnp.asarray(j),
                      jnp.asarray(R2))
    got = teb.update(tcfg, tst, _t(z), _t(j), _t(R2))
    assert_state_close(got, jax_to_numpy(want), 1e-12)


@pytest.mark.parametrize("mode", ["first_hit", "nearest"])
def test_associate_matches_jax(mode):
    """Random measurements (mostly NEW / SKIP) and exact revisits of seen
    landmarks (MATCH), against JAX: outcome and index equal."""
    gates = dict(match_gate=0.2, new_gate=60.0) if mode == "nearest" else {}
    jcfg, tcfg, jst, tst = _states(assoc_mode=mode, **gates)
    rng = np.random.default_rng(3)
    z = rng.uniform([0.3, -2], [1.5, 2], (B, 2))
    mean = np.asarray(jst.mean)
    for b in range(0, B, 2):                        # exact revisit of slot b%4
        s = b % 4
        dx = mean[3 + 2 * s, b] - mean[1, b]
        dy = mean[4 + 2 * s, b] - mean[2, b]
        a = np.arctan2(dy, dx) - mean[0, b]
        z[b] = [np.hypot(dx, dy), np.arctan2(np.sin(a), np.cos(a))]
    want = jeb.associate(jcfg, jst, jnp.asarray(z), jnp.asarray(R2))
    got = teb.associate(tcfg, tst, _t(z), _t(R2))
    np.testing.assert_array_equal(got.outcome.numpy(), want.outcome)
    np.testing.assert_array_equal(got.index.numpy(), want.index)
    wd = np.asarray(want.distances)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(got.distances.numpy()), fin)
    np.testing.assert_allclose(got.distances.numpy()[fin], wd[fin],
                               rtol=1e-10)
    assert len(set(np.asarray(want.outcome).tolist())) >= 2


def test_associate_empty_and_full_maps():
    for n_seen in (0, N):
        jcfg, tcfg, jst, tst = _states(n_seen=n_seen)
        z = np.full((B, 2), 50.0)
        want = jeb.associate(jcfg, jst, jnp.asarray(z), jnp.asarray(R2))
        got = teb.associate(tcfg, tst, _t(z), _t(R2))
        np.testing.assert_array_equal(got.outcome.numpy(), want.outcome)
        np.testing.assert_array_equal(got.index.numpy(), want.index)


def test_init_landmark_and_cov_match_jax():
    jcfg, tcfg, jst, tst = _states()
    rng = np.random.default_rng(4)
    j = np.full(B, 5, np.int32)                     # an unseen slot
    z = rng.uniform([0.3, -2], [1.5, 2], (B, 2))
    ji = jeb.init_landmark(jcfg, jst, jnp.asarray(z), jnp.asarray(j))
    ti = teb.init_landmark(tcfg, tst, _t(z), _t(j))
    np.testing.assert_allclose(ti.mean.numpy(), ji.mean, rtol=0, atol=1e-12)
    want = jeb._analytic_init_cov(ji, jnp.asarray(z), jnp.asarray(j),
                                  jnp.asarray(R2))
    got = teb._analytic_init_cov(ti, _t(z), _t(j), _t(R2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("analytic", [True, False])
def test_tick_matches_jax(known, analytic):
    """Three ticks of the reference's random workload (ids up to the
    capacity, 10% invalid), both association modes, both init modes,
    decisions equal. With the analytic init the states agree to 1e-10. The
    reference-mode init (analytic_init=False) updates a new landmark
    against its INT_MAX prior: ``cov - K SHt`` cancels 2e9 down to ~1e-3,
    which leaves an absolute rounding of 2e9 * 1e-16 = 2e-7 in the new
    block (2e-4 of its size), and the next gains carry that into the mean
    (1.3e-4 measured between the two packages). That is why the JAX
    package made the analytic init its default; the bounds for the
    reference mode are 1e-3 on the mean and 1e-5 on the covariance."""
    jcfg, tcfg, jst, tst = _states(analytic_init=analytic)
    rng = np.random.default_rng(5)
    M = 3
    for _ in range(3):
        tw = rng.uniform(-0.05, 0.05, (B, 3))
        zs = np.stack([rng.uniform(0.3, 1.2, (B, M)),
                       rng.uniform(-3, 3, (B, M))], axis=-1)
        valid = rng.uniform(size=(B, M)) < 0.9
        if known:
            ids = rng.integers(-1, N + 1, (B, M)).astype(np.int32)
            jst = jeb.known_association_step(
                jcfg, jst, jnp.asarray(tw), jnp.asarray(zs),
                jnp.asarray(valid), jnp.asarray(ids), jnp.asarray(Q3),
                jnp.asarray(R2))
            tst = teb.known_association_step(
                tcfg, tst, _t(tw), _t(zs), _t(valid), _t(ids), _t(Q3),
                _t(R2))
        else:
            jst = jeb.step(jcfg, jst, jnp.asarray(tw), jnp.asarray(zs),
                           jnp.asarray(valid), jnp.asarray(Q3),
                           jnp.asarray(R2))
            tst = teb.step(tcfg, tst, _t(tw), _t(zs), _t(valid), _t(Q3),
                           _t(R2))
    want = jax_to_numpy(jst)
    mean_tol, cov_tol = (1e-10, 1e-10) if analytic else (1e-3, 1e-5)
    assert_state_close(tst, want, mean_tol,
                       fields=("mean", "n_seen", "seen"))
    np.testing.assert_allclose(tst.cov.numpy(), want["cov"], rtol=1e-12,
                               atol=cov_tol)
    assert int(want["n_seen"].max()) > 4


def test_gated_off_world_stays_finite_f32():
    """The reference's pin (``test_gated_off_world_stays_finite_f32``): a
    gated-off world whose slot is an unseen INT_MAX-prior landmark on top
    of the robot overflows psi in the unused branch; the select form must
    discard it."""
    cfg = tekf.EKFConfig(num_landmarks=2)
    st = teb.init(cfg, 2, dtype=torch.float32, device="cpu")
    out = teb.known_association_step(
        cfg, st, torch.zeros(2, 3), torch.full((2, 1, 2), 0.5),
        torch.tensor([[True], [False]]),
        torch.zeros((2, 1), dtype=torch.int32),
        torch.eye(3) * 1e-4, torch.eye(2) * 1e-3)
    assert bool(torch.isfinite(out.mean).all())
    assert bool(torch.isfinite(out.cov).all())
    assert out.n_seen.tolist() == [1, 0]


def test_f32_long_horizon_asymmetry_matches_jax():
    """200 f32 ticks of known-association updates on one landmark set: the
    covariance stays symmetric to the same degree as the JAX engine's, and
    the states agree to f32 accumulation."""
    jcfg = jekf.EKFConfig(num_landmarks=4)
    tcfg = tekf.EKFConfig(num_landmarks=4)
    Bw, M = 3, 4
    rng = np.random.default_rng(7)
    lm = rng.uniform(-2, 2, (4, 2))
    jst = jeb.init(jcfg, Bw, dtype=jnp.float32)
    tst = teb.init(tcfg, Bw, dtype=torch.float32, device="cpu")
    Q = (np.eye(3) * 1e-4).astype(np.float32)
    R = (np.eye(2) * 1e-3).astype(np.float32)
    ids = np.broadcast_to(np.arange(M, dtype=np.int32), (Bw, M)).copy()
    valid = np.ones((Bw, M), bool)
    import jax
    jtick = jax.jit(lambda s, tw, zs: jeb.known_association_step(
        jcfg, s, tw, zs, jnp.asarray(valid), jnp.asarray(ids),
        jnp.asarray(Q), jnp.asarray(R)))
    th = np.zeros(Bw)
    for t in range(200):
        th = th + 0.01
        pos = np.stack([np.sin(th), 1 - np.cos(th)], -1)
        d = lm[None] - pos[:, None]
        zs = np.stack([np.hypot(d[..., 0], d[..., 1]),
                       np.arctan2(d[..., 1], d[..., 0]) - th[:, None]], -1)
        zs = (zs + rng.normal(0, 0.01, zs.shape)).astype(np.float32)
        tw = np.broadcast_to(np.array([0.01, 0.01, 0.0], np.float32),
                             (Bw, 3)).copy()
        jst = jtick(jst, jnp.asarray(tw), jnp.asarray(zs))
        tst = teb.known_association_step(tcfg, tst, _t(tw), _t(zs),
                                         _t(valid), _t(ids), _t(Q), _t(R))
    jc, tc = np.asarray(jst.cov), tst.cov.numpy()
    asym = lambda c: np.abs(c - c.transpose(1, 0, 2)).max()
    assert asym(tc) <= max(2 * asym(jc), 1e-7)
    np.testing.assert_allclose(tst.mean.numpy(), jst.mean, atol=2e-4)
    np.testing.assert_allclose(tc, jc, atol=2e-5)
