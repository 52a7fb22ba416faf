"""The circle-fit moment front end (``ops/kernels/circle_moments``) and
``ops/circle_fit`` against the JAX reference on the CPU. The wrapper runs
its plain version here (CPU tensors); the JAX Pallas kernel runs in
interpret mode, as in the JAX package's own tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.ops import circle_fit as jcf
from shermbot_navigation_tpu.ops import clustering as jcl
from shermbot_navigation_tpu.ops.pallas.circle_moments import (
    circle_moments_raw as j_moments_raw,
    reference_circle_moments as j_reference_moments)
from shermbot_navigation_tpu_torch.ops import circle_fit as tcf
from shermbot_navigation_tpu_torch.ops import clustering as tcl
from shermbot_navigation_tpu_torch.ops.kernels import circle_moments as tcm
from shermbot_navigation_tpu_torch.utils import convert


def _clusters(C, P, seed, dtype, counts=None, junk=False):
    """Noisy tube-sized arcs (the JAX kernel test's workload); ``counts``
    overrides the per-cluster counts; ``junk`` fills the rows at and past
    each count with large finite values instead of zeros."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((C, P, 2), dtype)
    n = rng.integers(4, P, C)
    for c in range(C):
        th = rng.uniform(0, 2 * np.pi, P)
        r = 0.04 + rng.normal(0, 1e-3, P)
        ctr = rng.uniform(-1, 1, 2)
        pts[c, :, 0] = ctr[0] + r * np.cos(th)
        pts[c, :, 1] = ctr[1] + r * np.sin(th)
    counts = n if counts is None else np.asarray(counts)
    for c in range(C):
        pts[c, counts[c]:] = 1e3 if junk else 0.0
    return pts, counts.astype(np.int32)


# counts 0, < 4, = P and > P (the clustering keeps the full count of a
# cluster that overflowed its P rows)
EDGE_COUNTS = [0, 1, 2, 3, 16, 16 + 9, 5, 16]


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12),
                                        (np.float32, 1e-4)])
def test_plain_version_matches_jax_reference(dtype, atol):
    """f64: the same sums in another order, 1e-12. f32: the JAX package's
    own kernel pin (rtol 1e-5, atol 1e-4 on M)."""
    pts, counts = _clusters(8, 16, 0, dtype, EDGE_COUNTS)
    M, cent, zbar = tcm.reference_circle_moments(torch.from_numpy(pts),
                                                 torch.from_numpy(counts))
    jM, jcent, jzbar = j_reference_moments(jnp.asarray(pts),
                                           jnp.asarray(counts))
    rtol = 0 if dtype is np.float64 else 1e-5
    np.testing.assert_allclose(M.numpy(), jM, rtol=rtol, atol=atol)
    np.testing.assert_allclose(cent.numpy(), jcent, rtol=rtol,
                               atol=min(atol, 1e-6))
    np.testing.assert_allclose(zbar.numpy(), jzbar, rtol=rtol,
                               atol=min(atol, 1e-6))


def test_wrapper_on_cpu_matches_pallas_interpret():
    """The wrapper (plain version on CPU tensors) against the TPU kernel in
    interpret mode, f32, counts 0 / < 4 / = P / > P; the JAX package's pin
    for its kernel against its oracle."""
    pts, counts = _clusters(8, 16, 1, np.float32, EDGE_COUNTS)
    before = tcm.circle_moments_raw.launches
    m16, cent, zbar = tcm.circle_moments_raw(torch.from_numpy(pts),
                                             torch.from_numpy(counts))
    assert tcm.circle_moments_raw.launches == before   # no kernel on the CPU
    jm, jcent, jzbar = j_moments_raw(jnp.asarray(pts), jnp.asarray(counts),
                                     interpret=True)
    np.testing.assert_allclose(m16.numpy(), jm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cent.numpy(), jcent, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(zbar.numpy(), jzbar, rtol=1e-5, atol=1e-6)
    M, _, _ = tcm.circle_moments(torch.from_numpy(pts),
                                 torch.from_numpy(counts))
    assert torch.equal(M.reshape(8, 16), m16)


def test_overflowed_count_divides_by_the_full_count():
    pts, counts = _clusters(2, 8, 2, np.float64, [8, 20])
    pts[1] = pts[0]
    M, cent, zbar = tcm.reference_circle_moments(torch.from_numpy(pts),
                                                 torch.from_numpy(counts))
    assert float(M[1, 3, 3]) == 8.0                    # sum of w = P
    np.testing.assert_allclose(cent[1].numpy(), cent[0].numpy() * 8 / 20,
                               atol=1e-15)


def test_rows_past_count_are_ignored_and_batch_dims_flatten():
    pts, counts = _clusters(6, 16, 3, np.float64)
    junk, _ = _clusters(6, 16, 3, np.float64, junk=True)
    a = tcm.circle_moments_raw(torch.from_numpy(pts),
                               torch.from_numpy(counts))
    b = tcm.circle_moments_raw(torch.from_numpy(junk),
                               torch.from_numpy(counts))
    c = tcm.circle_moments_raw(torch.from_numpy(junk).reshape(2, 3, 16, 2),
                               torch.from_numpy(counts).reshape(2, 3))
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y)
        assert torch.equal(x, z.reshape(x.shape))


def test_use_kernel_true_needs_cuda_tensors():
    pts, counts = _clusters(2, 8, 4, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tcm.circle_moments_raw(torch.from_numpy(pts),
                               torch.from_numpy(counts), use_kernel=True)


# ---------------------------------------------------------------------------
# ops/circle_fit
# ---------------------------------------------------------------------------

def _both(pts, counts, valid=None):
    valid = np.ones(len(counts), bool) if valid is None else valid
    arrays = dict(points=pts, counts=counts, valid=valid)
    return (jcl.Clusters(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            convert.clusters_from_numpy(arrays, "cpu"))


def test_fit_circles_matches_pallas_interpret_route():
    """``fit_circles(use_kernel=False)`` against JAX
    ``fit_circles(use_pallas=True, interpret=True)`` in f32: ``valid``
    equal, centre and radius at the JAX package's kernel-vs-XLA pin."""
    pts, counts = _clusters(16, 64, 5, np.float32)
    jc, tc = _both(pts, counts)
    want = jcf.fit_circles(jc, use_pallas=True, interpret=True)
    got = tcf.fit_circles(tc, use_kernel=False)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.center.numpy(), want.center, atol=1e-4)
    np.testing.assert_allclose(got.radius.numpy(), want.radius, atol=1e-4)


@pytest.mark.parametrize("componentized", [True, False])
def test_fit_circles_f64_matches_jax(componentized):
    """The reference's random clusters (clean arcs, noisy arcs,
    near-collinear sets, blobs; tests/test_perception.py). The moments
    agree to 1e-12; the eigen-chain amplifies that on the ill-conditioned
    kinds, so centre and radius are held to 1e-8, the bound the JAX
    package holds its own two tails to."""
    rng = np.random.default_rng(0)
    C, P = 16, 32
    buf = np.zeros((C, P, 2))
    counts = np.zeros(C, np.int32)
    for c in range(C):
        kind = c % 4
        n = int(rng.integers(2, P))
        if kind == 0:
            th = np.sort(rng.uniform(0, 2.5, n))
            buf[c, :n] = rng.uniform(-3, 3, 2) + rng.uniform(0.2, 2.0) \
                * np.stack([np.cos(th), np.sin(th)], -1)
        elif kind == 1:
            th = np.sort(rng.uniform(0, 1.5, n))
            buf[c, :n] = rng.uniform(-2, 2, 2) + np.stack(
                [np.cos(th), np.sin(th)], -1) + rng.normal(0, 0.02, (n, 2))
        elif kind == 2:
            t = np.sort(rng.uniform(0, 1, n))
            buf[c, :n] = np.stack([t, 0.5 * t + rng.normal(0, 1e-4, n)], -1)
        else:
            buf[c, :n] = rng.uniform(-1, 1, (n, 2))
        counts[c] = n
    jc, tc = _both(buf, counts, counts >= 3)
    want = jcf.fit_circles(jc, componentized=componentized)
    got = tcf.fit_circles(tc, componentized=componentized)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_allclose(got.center.numpy()[v],
                               np.asarray(want.center)[v], atol=1e-8)
    np.testing.assert_allclose(got.radius.numpy()[v],
                               np.asarray(want.radius)[v], atol=1e-8)


@pytest.mark.parametrize("pts,center,radius,atol", [
    ([[1, 7], [2, 6], [5, 8], [7, 7], [9, 5], [3, 7]],
     [4.615482, 2.807354], 4.827575, 1e-4),
    ([[-1, 0], [-0.3, -0.06], [0.3, 0.1], [1, 0]],
     [0.4908357, -22.15212], 22.17979, 1e-3),
])
def test_fit_points_golden_vectors(pts, center, radius, atol):
    """The reference's only numeric fixtures (nuslam/tests/circle_tests.cpp),
    at the JAX tests' tolerances, and against JAX itself."""
    c, r = tcf.fit_points(torch.tensor(pts, dtype=torch.float64))
    np.testing.assert_allclose(c.numpy(), center, atol=1e-4)
    np.testing.assert_allclose(float(r), radius, atol=atol)
    jc, jr = jcf.fit_points(jnp.asarray(pts, jnp.float64))
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-9)
    np.testing.assert_allclose(float(r), float(jr), atol=1e-9)


def test_undersized_cluster_invalid_and_batch_first():
    buf = np.zeros((1, 8, 2))
    buf[0, :3] = [[0, 0], [1, 1], [2, 0]]
    _, tc = _both(buf, np.array([3], np.int32))
    assert not bool(tcf.fit_circles(tc).valid[0])
    # leading batch dimensions: (2, 3, P, 2) equals the flat (6, P, 2)
    pts, counts = _clusters(6, 16, 7, np.float64)
    _, flat = _both(pts, counts)
    nested = tcl.Clusters(points=flat.points.reshape(2, 3, 16, 2),
                          counts=flat.counts.reshape(2, 3),
                          valid=flat.valid.reshape(2, 3))
    a, b = tcf.fit_circles(flat), tcf.fit_circles(nested)
    assert torch.equal(a.center, b.center.reshape(6, 2))
    assert torch.equal(a.valid, b.valid.reshape(6))
