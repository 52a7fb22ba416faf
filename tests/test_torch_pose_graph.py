"""The pose graph (models/pose_graph.py) against the JAX reference, on the
CPU in f64.

The same numpy graph -- config 5's drifted loop with its loop-closure
edge, plus a padded edge of weight 0 -- goes through both packages.
Tolerances: residuals, Jacobians and the gauge projection 1e-12 (the same
formulas, ulps apart: ``torch.func.jacfwd`` against ``jax.jacfwd``); a GN
step, dense or CG, and ``optimize`` 1e-10 (summation order in the
scatter-adds and the solve); ``chi2`` 1e-12 relative; ``optimize_host``
bit for bit (the same numpy code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import pose_graph as jpg
from shermbot_navigation_tpu.parallel import megamap as jmm
from shermbot_navigation_tpu_torch.models import pose_graph as tpg
from shermbot_navigation_tpu_torch.utils import convert

F64 = torch.float64


def _graph(seed=0, T=24):
    """Numpy fields of config 5's pose graph at T keyframes (odometry chain
    and the loop closure) with one more edge, padded: weight 0."""
    g = jax_to_numpy(jmm.synthesize(64, T, 4, seed=seed,
                                    dtype=jnp.float64).graph)
    rng = np.random.default_rng(seed + 10)
    pad = {"edge_i": np.array([3], np.int32), "edge_j": np.array([7],
                                                                  np.int32),
           "meas": rng.normal(size=(1, 3)), "info": np.eye(3)[None] * 50.0,
           "weight": np.zeros(1)}
    for k, v in pad.items():
        g[k] = np.concatenate([g[k], v])
    return g


def _both(g):
    return (jpg.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}),
            convert.pose_graph_from_numpy(g, "cpu"))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_and_jacobians_match_jax(seed):
    jg, tg = _both(_graph(seed))
    for got, want in zip(tpg.residuals(tg), jpg.residuals(jg)):
        _close(got, want, 1e-12)


def test_edge_residual_wraps_like_jax():
    """Headings far outside (-pi, pi], the Jacobians through the wrap."""
    rng = np.random.default_rng(3)
    xi, xj, z = (rng.uniform(-9, 9, (40, 3)) for _ in range(3))
    want = jax.vmap(lambda a, b, c: (
        jpg.edge_residual(a, b, c),
        jax.jacfwd(jpg.edge_residual, argnums=0)(a, b, c),
        jax.jacfwd(jpg.edge_residual, argnums=1)(a, b, c)))(xi, xj, z)
    got = tpg._res_and_jac(*(torch.from_numpy(a) for a in (xi, xj, z)))
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_chi2_matches_jax():
    jg, tg = _both(_graph())
    want = float(jpg.chi2(jg))
    assert abs(float(tpg.chi2(tg)) - want) <= 1e-12 * want


@pytest.mark.parametrize("solve", ["dense", "cg"])
def test_gauss_newton_step_matches_jax(solve):
    jg, tg = _both(_graph())
    _close(tpg.gauss_newton_step(tg, solve=solve, cg_iters=60).poses,
           jpg.gauss_newton_step(jg, solve=solve, cg_iters=60).poses, 1e-10)


@pytest.mark.parametrize("solve", ["dense", "cg"])
def test_optimize_matches_jax(solve):
    jg, tg = _both(_graph(1))
    _close(tpg.optimize(tg, iters=5, solve=solve, cg_iters=40).poses,
           jpg.optimize(jg, iters=5, solve=solve, cg_iters=40).poses, 1e-10)


def test_dense_normal_matrix_is_the_mixed_index_scatter():
    """``H[e_a, :, e_b, :] += H_ab`` (advanced indices around slices, as
    JAX's ``.at[ei, :, ej, :].add`` reads them), repeated indices summed:
    the port's flattened scatter against numpy's ``add.at``."""
    g = _graph()
    tg = convert.pose_graph_from_numpy(g, "cpu")
    _, Ji, Jj = tpg.residuals(tg)
    T = g["poses"].shape[0]
    want = np.zeros((T, 3, T, 3))
    ei, ej = g["edge_i"], g["edge_j"]
    for (a, b), blk in zip(((ei, ei), (ei, ej), (ej, ei), (ej, ej)),
                           tpg._block_products(tg, Ji, Jj)):
        np.add.at(want, (a, slice(None), b, slice(None)), blk.numpy())
    want[0, :, 0, :] += 1e6 * np.eye(3)
    want = want.reshape(3 * T, 3 * T) + 1e-6 * np.eye(3 * T)
    got = tpg._dense_normal(tg, Ji, Jj, 1e6, 1e-6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-9)


@pytest.mark.parametrize("with_landmarks", [False, True])
def test_gauge_project_matches_jax(with_landmarks):
    """A target heading outside (-pi, pi] still comes back exactly."""
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(16, 3)) * [3.0, 5.0, 5.0]
    target = np.array([4.0, 1.5, -2.0])
    lms = rng.normal(size=(10, 2)) * 4 if with_landmarks else None
    want = jpg.gauge_project(jnp.asarray(poses), jnp.asarray(target),
                             None if lms is None else jnp.asarray(lms))
    got = tpg.gauge_project(torch.from_numpy(poses),
                            torch.from_numpy(target),
                            None if lms is None else torch.from_numpy(lms))
    if not with_landmarks:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)
    assert torch.equal(got[0][0], torch.from_numpy(target))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_optimize_host_is_bit_equal_to_jax(dtype):
    g = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
         for k, v in _graph().items()}
    want = jpg.optimize_host(jpg.PoseGraph(**g), iters=4).poses
    got = tpg.optimize_host(tpg.PoseGraph(**g), iters=4).poses
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_graph_helpers_match_jax():
    """``odometry_edges`` and ``build_graph`` on a noisy trajectory with a
    loop closure; the converters round-trip exactly."""
    rng = np.random.default_rng(5)
    odo = np.cumsum(rng.normal(size=(12, 3)) * 0.3, axis=0)
    info = np.diag([100.0, 50.0, 50.0])
    lc = (np.array([11], np.int32), np.array([0], np.int32),
          rng.normal(size=(1, 3)), np.eye(3)[None] * 1e4)
    je = jpg.odometry_edges(jnp.asarray(odo), jnp.asarray(info))
    te = tpg.odometry_edges(torch.from_numpy(odo), torch.from_numpy(info))
    for g, w in zip(te, je):
        _close(g, w, 1e-12)
    jg = jpg.build_graph(jnp.asarray(odo), [je, tuple(map(jnp.asarray, lc))])
    tg = tpg.build_graph(torch.from_numpy(odo),
                         [te, tuple(map(torch.from_numpy, lc))])
    for k, w in jax_to_numpy(jg).items():
        assert getattr(tg, k).numpy().dtype == w.dtype, k
        _close(getattr(tg, k), w, 1e-12)
    back = convert.pose_graph_to_numpy(tg)
    again = convert.pose_graph_from_numpy(back, "cpu")
    for k in tg._fields:
        assert torch.equal(getattr(again, k), getattr(tg, k)), k


def test_loop_closure_reduces_error():
    """The port alone, on the JAX test's loop: the closure pulls chi2 down
    by 10x and halves the end-pose error."""
    from test_refinement import make_loop
    truth, odo, rels = (np.array(a) for a in make_loop())
    T = truth.shape[0]
    t = torch.from_numpy
    ei = torch.arange(T - 1, dtype=torch.int32)
    odo_edges = (ei, ei + 1, t(rels),
                 (torch.eye(3, dtype=F64) * 100.0).expand(T - 1, 3, 3))
    z_loop = tpg.edge_residual(t(truth[-1]), t(truth[0]),
                               torch.zeros(3, dtype=F64))[None]
    lc = (torch.tensor([T - 1], dtype=torch.int32),
          torch.tensor([0], dtype=torch.int32), z_loop,
          (torch.eye(3, dtype=F64) * 1e4)[None])
    g = tpg.build_graph(t(odo), [odo_edges, lc])
    g2 = tpg.optimize(g, iters=10)
    assert float(tpg.chi2(g2)) < 0.1 * float(tpg.chi2(g))
    err = [np.linalg.norm(p[-1, 1:] - truth[-1, 1:])
           for p in (odo, g2.poses.numpy())]
    assert err[1] < 0.5 * err[0]
