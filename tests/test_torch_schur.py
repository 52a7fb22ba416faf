"""Schur refinement (models/schur.py) and its map-sharded form
(parallel/schur_dist.py) against the JAX reference, on the CPU in f64.

The problem is ``test_refinement.TestSchur._problem``'s (a drifted loop,
landmarks seen from every pose within 1.6 m), built once in numpy and
handed to both packages. The JAX sharded step runs under ``shard_map`` on
a mesh of the virtual CPU devices, the port's on one device with a
leading shard axis. Tolerances: observation residuals and Jacobians
1e-12; a GN step, ``optimize`` and the sharded step 1e-10 against JAX at
the same shard count (summation order); ``total_cost`` 1e-12 relative;
the sharded step 1e-8 against the port's own single-shard
``schur.gauss_newton_step`` (the JAX package's ``test_sharded_matches_
single`` bound); ``partition_problem`` bit for bit; the gauge anchor
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import schur as jschur
from shermbot_navigation_tpu.parallel import mesh as mesh_lib
from shermbot_navigation_tpu.parallel import schur_dist as jsd
from shermbot_navigation_tpu_torch.models import schur as tschur
from shermbot_navigation_tpu_torch.parallel import mesh as tmesh
from shermbot_navigation_tpu_torch.parallel import schur_dist as tsd
from shermbot_navigation_tpu_torch.utils import convert
from test_refinement import TestSchur as _JaxSchurTests


def _problem(T=30, N=12, seed=1) -> dict:
    prob, _, _ = _JaxSchurTests()._problem(T=T, N=N, dtype=jnp.float64,
                                           seed=seed)
    return jax_to_numpy(prob)


def _both(p: dict):
    return (jschur.BundleProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
            convert.bundle_from_numpy(p, "cpu"))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_observation_terms_match_jax():
    jp, tp = _both(_problem())
    want = jschur._obs_rj(jp.poses[jp.obs_t], jp.landmarks[jp.obs_j],
                          jp.obs_z)
    got = tschur._obs_rj(tp.poses[tp.obs_t], tp.landmarks[tp.obs_j],
                         tp.obs_z)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_gauss_newton_step_matches_jax():
    jp, tp = _both(_problem())
    want = jschur.gauss_newton_step(jp, cg_iters=64)
    got = tschur.gauss_newton_step(tp, cg_iters=64)
    _close(got.poses, want.poses, 1e-10)
    _close(got.landmarks, want.landmarks, 1e-10)


def test_optimize_matches_jax_and_recovers_truth():
    jp, tp = _both(_problem())
    want = jschur.optimize(jp, iters=8)
    got = tschur.optimize(tp, iters=8)
    _close(got.poses, want.poses, 1e-10)
    _close(got.landmarks, want.landmarks, 1e-10)
    c0, c1 = float(tschur.total_cost(tp)), float(tschur.total_cost(got))
    assert c1 < 0.05 * c0


@pytest.mark.parametrize("refined", [False, True])
def test_total_cost_matches_jax(refined):
    jp, tp = _both(_problem())
    if refined:
        jp, tp = (jschur.optimize(jp, iters=2),
                  tschur.optimize(tp, iters=2))
    want = float(jschur.total_cost(jp))
    assert abs(float(tschur.total_cost(tp)) - want) <= 1e-12 * want


def _sharded_problem():
    """``test_schur_dist``'s problem (T=24, N=16, seed 7)."""
    return _problem(T=24, N=16, seed=7)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_problem_is_bit_equal(n_shards):
    p = _sharded_problem()
    want = jax_to_numpy(jsd.partition_problem(_both(p)[0], n_shards))
    got = tsd.partition_problem(convert.bundle_from_numpy(p, "cpu"),
                                n_shards)
    for k, w in want.items():
        g = getattr(got, k).numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _sharded(n_shards, cg_iters=80, gn_steps=1):
    p = _sharded_problem()
    jpart = jsd.partition_problem(_both(p)[0], n_shards)
    tpart = tsd.partition_problem(convert.bundle_from_numpy(p, "cpu"),
                                  n_shards)
    T, N, M = (tpart.poses.shape[0], tpart.landmarks.shape[0],
               tpart.obs_t.shape[0])
    mesh = mesh_lib.make_mesh(jax.devices()[:n_shards], data=1,
                              map_=n_shards)
    jstep = jsd.make_sharded_gn(mesh, T=T, N=N, M=M, cg_iters=cg_iters,
                                gn_steps=gn_steps)
    tstep = tsd.make_sharded_gn(n_shards, T=T, N=N, M=M, cg_iters=cg_iters,
                                gn_steps=gn_steps, device="cpu")
    return jstep(jpart), tstep(tpart), tpart


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_gn_matches_jax_and_the_single_shard_step(n_shards):
    want, got, part = _sharded(n_shards)
    _close(got.poses, want.poses, 1e-10)
    _close(got.landmarks, want.landmarks, 1e-10)
    single = tschur.gauss_newton_step(
        convert.bundle_from_numpy(_sharded_problem(), "cpu"), cg_iters=80)
    _close(got.poses, single.poses.numpy(), 1e-8)
    _close(got.landmarks, single.landmarks.numpy(), 1e-8)
    assert torch.equal(got.obs_t, part.obs_t)


def test_sharded_gn_steps_match_jax():
    """Three GN steps in one step call."""
    want, got, _ = _sharded(4, cg_iters=40, gn_steps=3)
    _close(got.poses, want.poses, 1e-10)
    _close(got.landmarks, want.landmarks, 1e-10)


def test_gauge_anchor_holds_exactly():
    """Pose 0 comes back bit for bit after every step."""
    part = tsd.partition_problem(
        convert.bundle_from_numpy(_sharded_problem(), "cpu"), 2)
    step = tsd.make_sharded_gn(2, T=part.poses.shape[0],
                               N=part.landmarks.shape[0],
                               M=part.obs_t.shape[0], cg_iters=40,
                               device="cpu")
    out = part
    for _ in range(4):
        out = step(out)
        assert torch.equal(out.poses[0], part.poses[0])


def test_shard_sum_is_the_psum_over_the_shard_axis():
    x = torch.arange(24, dtype=torch.float64).view(4, 2, 3)
    mesh = tmesh.make_mesh(map_=4, local_shards=4, device="cpu")
    assert torch.equal(mesh.psum(x), x[0] + x[1] + x[2] + x[3])


def test_sharded_gn_refuses_shapes_it_was_not_built_for():
    part = tsd.partition_problem(
        convert.bundle_from_numpy(_sharded_problem(), "cpu"), 2)
    with pytest.raises(ValueError, match="divide"):
        tsd.make_sharded_gn(3, T=24, N=16, M=part.obs_t.shape[0],
                            device="cpu")
    step = tsd.make_sharded_gn(2, T=24, N=16, M=part.obs_t.shape[0] + 2,
                               device="cpu")
    with pytest.raises(ValueError, match="built for"):
        step(part)
