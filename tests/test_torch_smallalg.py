"""Leaf math of the port against the JAX reference on the CPU:
``ops/smallalg``, ``ops/se2``, ``ops/diff_drive``, ``pipeline/odometry``
and ``pipeline/metrics``. The same numpy-seeded inputs go through both;
f64, atol 1e-12 unless a reason is written beside a looser bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.ops import diff_drive as jdd
from shermbot_navigation_tpu.ops import se2 as jse2
from shermbot_navigation_tpu.ops import smallalg as jsa
from shermbot_navigation_tpu.pipeline import metrics as jmetrics
from shermbot_navigation_tpu.pipeline import odometry as jodom
from shermbot_navigation_tpu_torch.ops import diff_drive as tdd
from shermbot_navigation_tpu_torch.ops import se2 as tse2
from shermbot_navigation_tpu_torch.ops import smallalg as tsa
from shermbot_navigation_tpu_torch.pipeline import metrics as tmetrics
from shermbot_navigation_tpu_torch.pipeline import odometry as todom

ATOL = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("n,fn", [(2, "inv2"), (3, "solve3"), (4, "solve4")])
def test_solves_match_jax_and_numpy(n, fn):
    """The reference's cases (tests/test_smallalg.py): random batched
    systems, against JAX and against numpy's LAPACK solve."""
    rng = np.random.default_rng(n)
    M = rng.normal(size=(6, 5, n, n)) + 3.0 * np.eye(n)
    v = rng.normal(size=(6, 5, n))
    if fn == "inv2":
        got = tsa.inv2(_t(M))
        _close(got, jsa.inv2(jnp.asarray(M)))
        _close(got, np.linalg.inv(M), 1e-10)
    else:
        got = getattr(tsa, fn)(_t(M), _t(v))
        _close(got, getattr(jsa, fn)(jnp.asarray(M), jnp.asarray(v)))
        _close(got, np.linalg.solve(M, v[..., None])[..., 0], 1e-10)


def test_solve4_c_matches_jax():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(7, 4, 4)) + 3.0 * np.eye(4)
    v = rng.normal(size=(7, 4))
    want = jsa.solve4_c([[jnp.asarray(M[:, i, j]) for j in range(4)]
                         for i in range(4)],
                        [jnp.asarray(v[:, i]) for i in range(4)])
    got = tsa.solve4_c([[_t(M[:, i, j]) for j in range(4)]
                        for i in range(4)], [_t(v[:, i]) for i in range(4)])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("eps", [0.0, 1e-30])
def test_singular_systems_take_the_floored_determinant(eps):
    M = np.zeros((2, 2)) + eps
    _close(tsa.inv2(_t(M)), jsa.inv2(jnp.asarray(M)))


def test_eigh4_matches_jax_and_lapack():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(40, 4, 4))
    A = A + A.transpose(0, 2, 1)
    lam, V = tsa.eigh4_jacobi(_t(A))
    jl, jV = jsa.eigh4_jacobi(jnp.asarray(A))
    _close(lam, jl, 1e-13)
    _close(V, jV, 1e-13)
    _close(lam, np.linalg.eigvalsh(A), 1e-10)
    recon = torch.einsum("bij,bj,bkj->bik", V, lam, V)
    _close(recon, A, 1e-10)


def test_eigh4_near_degenerate_picks_jax_eigenvectors():
    """Near-equal eigenvalues: the rotation order decides the basis, so
    the port must land on the JAX package's vectors, not merely on some
    valid basis."""
    rng = np.random.default_rng(1)
    Qm, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    A = Qm @ np.diag([1.0, 1.0 + 1e-9, 2.0, 2.0 + 1e-9]) @ Qm.T
    comps = [A[i, j] for i in range(4) for j in range(4)]
    lam, V = tsa.eigh4_jacobi_c([_t(c) for c in comps])
    jl, jV = jsa.eigh4_jacobi_c([jnp.asarray(c) for c in comps])
    for i in range(4):
        _close(lam[i], jl[i], 1e-13)
        for j in range(4):
            # vectors of a 1e-9 gap amplify ulps by 1e9
            _close(V[i][j], jV[i][j], 1e-5)


def test_eigh4_f32_matches_jax_f32():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(20, 4, 4)).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    lam, V = tsa.eigh4_jacobi(_t(A))
    jl, jV = jsa.eigh4_jacobi(jnp.asarray(A))
    # two f32 libms (atan2/sin/cos) through 48 rotations
    _close(lam, jl, 2e-5)
    _close(V, jV, 2e-5)


# ---------------------------------------------------------------------------
# se2
# ---------------------------------------------------------------------------

def _transforms(rng, *shape):
    th = rng.uniform(-4, 4, shape)
    return np.stack([np.cos(th), np.sin(th), rng.normal(size=shape),
                     rng.normal(size=shape)], -1)


@pytest.mark.parametrize("fn", ["inv", "to_pose", "angle"])
def test_se2_unary(fn):
    T = _transforms(np.random.default_rng(0), 5, 3)
    _close(getattr(tse2, fn)(_t(T)), getattr(jse2, fn)(jnp.asarray(T)))


@pytest.mark.parametrize("fn", ["from_pose", "integrate_twist"])
def test_se2_from_three(fn):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 4, 3))
    x[0, 0, 0] = 0.0          # the dth == 0 branch
    x[0, 1, 0] = 1e-9
    _close(getattr(tse2, fn)(_t(x)), getattr(jse2, fn)(jnp.asarray(x)))


def test_se2_binary_and_constructors():
    rng = np.random.default_rng(2)
    Ta, Tb = _transforms(rng, 7), _transforms(rng, 7)
    v = rng.normal(size=(7, 2))
    tw = rng.normal(size=(7, 3))
    a = rng.uniform(-9, 9, 7)
    _close(tse2.compose(_t(Ta), _t(Tb)),
           jse2.compose(jnp.asarray(Ta), jnp.asarray(Tb)))
    _close(tse2.apply(_t(Ta), _t(v)), jse2.apply(jnp.asarray(Ta),
                                                 jnp.asarray(v)))
    _close(tse2.adjoint_twist(_t(Ta), _t(tw)),
           jse2.adjoint_twist(jnp.asarray(Ta), jnp.asarray(tw)))
    _close(tse2.from_translation(_t(v)), jse2.from_translation(v))
    _close(tse2.from_rotation(_t(a)), jse2.from_rotation(a))
    _close(tse2.from_parts(_t(v), _t(a)), jse2.from_parts(v, a))
    _close(tse2.normalize_angle(_t(a)), jse2.normalize_angle(a))
    _close(tse2.deg2rad(_t(a)), jse2.deg2rad(a))
    _close(tse2.rad2deg(_t(a)), jse2.rad2deg(a))
    _close(tse2.identity(torch.float64, "cpu"), jse2.identity(jnp.float64))


def test_se2_group_laws():
    """The reference's own identities (tests/test_se2.py)."""
    rng = np.random.default_rng(3)
    T = _t(_transforms(rng, 9))
    eye = tse2.identity(torch.float64, "cpu")
    _close(tse2.compose(T, tse2.inv(T)), eye.expand(9, 4), 1e-12)
    v = _t(rng.normal(size=(9, 2)))
    _close(tse2.apply(tse2.inv(T), tse2.apply(T, v)), v, 1e-12)


# ---------------------------------------------------------------------------
# diff_drive, odometry
# ---------------------------------------------------------------------------

def _dd_params():
    return (jdd.DiffDriveParams(jnp.float64(0.16), jnp.float64(0.033)),
            tdd.DiffDriveParams(torch.tensor(0.16, dtype=torch.float64),
                                torch.tensor(0.033, dtype=torch.float64)))


def test_diff_drive_conversions():
    jp, tp = _dd_params()
    rng = np.random.default_rng(0)
    tw = rng.normal(size=(5, 3))
    dw = rng.normal(size=(5, 2))
    _close(tdd.twist_to_wheels(tp, _t(tw)),
           jdd.twist_to_wheels(jp, jnp.asarray(tw)))
    _close(tdd.wheels_to_twist(tp, _t(dw)),
           jdd.wheels_to_twist(jp, jnp.asarray(dw)))
    # round trip (the reference's test_diff_drive.py): dy is dropped
    back = tdd.wheels_to_twist(tp, tdd.twist_to_wheels(tp, _t(tw)))
    _close(back[:, :2], tw[:, :2], 1e-12)


def test_diff_drive_step_nudge_teleport_and_odometry():
    jp, tp = _dd_params()
    rng = np.random.default_rng(1)
    js = jdd.init_state(0.3, 0.1, -0.2, dtype=jnp.float64)
    ts = tdd.init_state(0.3, 0.1, -0.2, dtype=torch.float64, device="cpu")
    for _ in range(6):
        w = np.asarray(js.wheels) + rng.normal(scale=0.3, size=2)
        js2, jo = jodom.update(jp, js, jnp.asarray(w))
        ts2, to = todom.update(tp, ts, _t(w))
        js, ts = jdd.step(jp, js, jnp.asarray(w)), tdd.step(tp, ts, _t(w))
        _close(ts.pose, js.pose)
        _close(ts2.pose, js2.pose)
        _close(to.twist, jo.twist)
    jn = jdd.nudge(js, jnp.float64(0.01), jnp.float64(-0.02))
    tn = tdd.nudge(ts, torch.tensor(0.01, dtype=torch.float64),
                   torch.tensor(-0.02, dtype=torch.float64))
    _close(tn.pose, jn.pose)
    jt, tt = jodom.set_pose(js, 1.0, 2.0, 3.0), todom.set_pose(ts, 1.0, 2.0,
                                                              3.0)
    _close(tt.pose, jt.pose)
    _close(tt.wheels, jt.wheels)


def test_diff_drive_batch_first_equals_per_world():
    _, tp = _dd_params()
    rng = np.random.default_rng(2)
    st = tdd.init_state(dtype=torch.float64, device="cpu", batch=(4,))
    w = _t(rng.normal(size=(4, 2)))
    out = tdd.step(tp, st, w)
    for b in range(4):
        one = tdd.step(tp, tdd.init_state(dtype=torch.float64, device="cpu"),
                       w[b])
        _close(out.pose[b], one.pose.numpy(), 0)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    est = rng.normal(size=(40, 3))
    tru = est + rng.normal(scale=0.05, size=(40, 3))
    A = rng.normal(size=(40, 3, 3))
    cov = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)
    B2 = rng.normal(size=(40, 2, 2))
    psi = B2 @ B2.transpose(0, 2, 1) + 0.1 * np.eye(2)
    dz = rng.normal(size=(40, 2))
    j, t = jnp.asarray, _t
    _close(tmetrics.ate(t(est[:, 1:]), t(tru[:, 1:])),
           jmetrics.ate(j(est[:, 1:]), j(tru[:, 1:])))
    _close(tmetrics.max_te(t(est[:, 1:]), t(tru[:, 1:])),
           jmetrics.max_te(j(est[:, 1:]), j(tru[:, 1:])))
    _close(tmetrics.heading_rmse(t(est[:, 0]), t(tru[:, 0])),
           jmetrics.heading_rmse(j(est[:, 0]), j(tru[:, 0])))
    _close(tmetrics.rpe(t(est), t(tru), 5), jmetrics.rpe(j(est), j(tru), 5))
    _close(tmetrics.nis(t(dz), t(psi)), jmetrics.nis(j(dz), j(psi)), 1e-10)
    _close(tmetrics.nees(t(est), t(tru), t(cov)),
           jmetrics.nees(j(est), j(tru), j(cov)), 1e-10)
