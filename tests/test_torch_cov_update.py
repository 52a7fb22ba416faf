"""The port's fused Kalman update (ops/kernels/cov_update.py) and the dense
engine's padded ``pallas_update='on'`` route, against the JAX reference.

On the CPU the wrapper runs its plain version; the CUDA kernel is held to
it on the card by tests/test_torch_cuda.py and chip_smoke.py. Tolerances
are the JAX package's own for the same comparisons
(tests/test_pallas_kernels.py): the padded f32 trajectory against the
unpadded one to 1e-5 (mean) and 1e-4 (covariance), the padded tail
exactly 0; the plain version against the JAX kernel in interpret mode in
f32 to 1e-5 of the covariance's unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu.ops.pallas import cov_update as jcu
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.ops.kernels import cov_update as tcu


def _operands(D, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(D, D)).astype(np.float32)
    return (a @ a.T / D, rng.normal(size=(D, 2)).astype(np.float32),
            np.array([[2.0, -0.3], [-0.3, 1.5]], np.float32),
            rng.normal(size=2).astype(np.float32),
            rng.normal(size=D).astype(np.float32))


@pytest.mark.parametrize("D", [128, 256])
def test_reference_matches_jax_kernel_interpret(D):
    ops = _operands(D, seed=D)
    want_cov, want_mean = jcu.fused_kalman_update(
        *map(jnp.asarray, ops), tile=128, interpret=True)
    got_cov, got_mean = tcu.reference_kalman_update(*map(torch.from_numpy,
                                                         ops))
    np.testing.assert_allclose(got_cov.numpy(), want_cov, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_mean.numpy(), want_mean, rtol=0,
                               atol=1e-5)
    # and the JAX package's own XLA reference
    ref_cov, _ = jcu.reference_kalman_update(*map(jnp.asarray, ops))
    np.testing.assert_allclose(got_cov.numpy(), ref_cov, rtol=0, atol=1e-5)


def test_wrapper_routes_cpu_to_plain_and_applies_flag():
    ops = [torch.from_numpy(x) for x in _operands(128)]
    before = tcu.fused_kalman_update.launches
    for flag in (None, True, False):
        apply = None if flag is None else torch.tensor(flag)
        got = tcu.fused_kalman_update(*ops, apply=apply)
        want = tcu.reference_kalman_update(*ops)
        if flag is False:
            want = (ops[0], ops[4])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert tcu.fused_kalman_update.launches == before


def _known_trajectory(pkg, cfg, dtype, T=5, M=3, N=6):
    """The JAX package's padded-route test inputs (tests/
    test_pallas_kernels.py::test_ekf_update_kernel_path_matches_xla)."""
    rng = np.random.default_rng(9)
    twists = rng.uniform(-0.05, 0.05, (T, 3)).astype(np.float32)
    zs = np.stack([rng.uniform(0.3, 1.0, (T, M)),
                   rng.uniform(-3, 3, (T, M))], axis=-1).astype(np.float32)
    valid = np.ones((T, M), bool)
    ids = np.array([[(t + k) % N for k in range(M)] for t in range(T)],
                   np.int32)
    Q = np.diag([1e-3] * 3).astype(np.float32)
    R = np.diag([1e-3] * 2).astype(np.float32)
    if pkg is jekf:
        st = jekf.init(cfg, jnp.zeros(3, jnp.float32))
        conv = jnp.asarray
    else:
        st = tekf.init(cfg, [0.0, 0.0, 0.0], dtype=dtype, device="cpu")
        conv = torch.from_numpy
    for t in range(T):
        st = pkg.known_association_step(
            cfg, st, *map(conv, (twists[t], zs[t], valid[t], ids[t], Q, R)))
    return st


def test_padded_on_route_matches_unpadded_and_jax():
    """N=6 padded to 128 through the fused route equals the unpadded
    'off' trajectory on the logical slots, the padded tail stays exactly
    0, and both equal the JAX package's runs of the same two configs (the
    JAX 'on' route runs its Pallas kernel in interpret mode)."""
    N, D = 6, 15
    off = tekf.EKFConfig(num_landmarks=N, pallas_update="off")
    on = tekf.EKFConfig(num_landmarks=N, pad_state_to=128,
                        pallas_update="on")
    a = _known_trajectory(tekf, off, torch.float32)
    b = _known_trajectory(tekf, on, torch.float32)
    assert b.mean.shape == (128,)
    np.testing.assert_allclose(a.mean.numpy(), b.mean[:D].numpy(), atol=1e-5)
    np.testing.assert_allclose(a.cov.numpy(), b.cov[:D, :D].numpy(),
                               atol=1e-4)
    assert not b.mean[D:].any() and not b.cov[D:, :].any()
    assert not b.cov[:, D:].any()
    assert torch.equal(a.seen, b.seen) and int(a.n_seen) == int(b.n_seen)

    ja = jax_to_numpy(_known_trajectory(
        jekf, jekf.EKFConfig(num_landmarks=N, pallas_update="off"), None))
    jb = jax_to_numpy(_known_trajectory(
        jekf, jekf.EKFConfig(num_landmarks=N, pad_state_to=128,
                             pallas_update="on"), None))
    np.testing.assert_allclose(a.mean.numpy(), ja["mean"], atol=1e-5)
    np.testing.assert_allclose(a.cov.numpy(), ja["cov"], atol=1e-4)
    np.testing.assert_allclose(b.mean.numpy(), jb["mean"], atol=1e-5)
    np.testing.assert_allclose(b.cov.numpy(), jb["cov"], atol=1e-4)
    np.testing.assert_array_equal(b.seen.numpy(), jb["seen"])


def test_on_route_raises_off_its_shapes():
    cfg = tekf.EKFConfig(num_landmarks=6, pallas_update="on")
    with pytest.raises(ValueError, match="pad_state_to"):
        _known_trajectory(tekf, cfg, torch.float32, T=1)
    cfg = tekf.EKFConfig(num_landmarks=6, pad_state_to=128,
                         pallas_update="on")
    with pytest.raises(ValueError, match="f32"):
        _known_trajectory(tekf, cfg, torch.float64, T=1)


def test_on_route_under_vmap_equals_a_per_world_loop():
    """The dense engine under ``torch.func.vmap`` with ``'on'`` reaches
    the op's vmap rule, which hands the B worlds to one call (one launch
    on the card; here the plain version, no launch): every world equals
    its own one-world run bit for bit, f32, N=6 padded to 128, 3 worlds
    that differ, 4 ticks of known association."""
    cfg = tekf.EKFConfig(num_landmarks=6, pad_state_to=128,
                         pallas_update="on")
    rng = np.random.default_rng(4)
    Bw, T, M = 3, 4, 3
    twists = torch.from_numpy(rng.uniform(-0.05, 0.05, (T, Bw, 3))
                              .astype(np.float32))
    zs = torch.from_numpy(np.stack([rng.uniform(0.3, 1.0, (T, Bw, M)),
                                    rng.uniform(-3, 3, (T, Bw, M))], -1)
                          .astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(T, Bw, M)) < 0.8)
    ids = torch.tensor([[0, 2, 4]] * Bw, dtype=torch.int32)
    Q = torch.eye(3) * 1e-3
    R = torch.eye(2) * 1e-3
    one = tekf.init(cfg, [0.0, 0.0, 0.0], device="cpu")
    batched = tekf.EKFState(*(f.expand(Bw, *f.shape).clone() for f in one))
    step = torch.func.vmap(lambda s, tw, z, v, i: tekf.known_association_step(
        cfg, s, tw, z, v, i, Q, R))
    worlds = [one] * Bw
    before = tcu.fused_kalman_update.launches
    for t in range(T):
        batched = step(batched, twists[t], zs[t], valid[t], ids)
        worlds = [tekf.known_association_step(cfg, w, twists[t, b], zs[t, b],
                                              valid[t, b], ids[b], Q, R)
                  for b, w in enumerate(worlds)]
    assert tcu.fused_kalman_update.launches == before
    assert batched.mean.shape == (Bw, 128)
    for b, w in enumerate(worlds):
        for f in tekf.EKFState._fields:
            assert torch.equal(getattr(batched, f)[b], getattr(w, f)), (b, f)
