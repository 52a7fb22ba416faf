"""Config-5 workload: a huge landmark map refined in two stages (port of
``shermbot_navigation_tpu.parallel.megamap``).

BASELINE.json: "50,000-landmark map partitioned across 2+ hosts,
distributed Schur-complement refinement + pose-graph loop closure". A dense
covariance at that scale is out of reach (a (2N)^2 float32 Sigma is
40 GB), so the large-map estimator takes the information/batch form, the
classic two-stage pipeline:

1. **pose-graph loop closure** (``models/pose_graph.optimize_host``, dense
   Gauss-Newton on the host in float64): drifted keyframe odometry and a
   loop-closure edge give globally consistent keyframes;
2. **map-sharded Schur bundle refinement** (``parallel/schur_dist``, on
   the device): jointly polish all keyframes and landmarks, the landmarks
   and their observations split into map shards, a process holding its
   shards on a leading axis (``parallel/mesh.py``).

:func:`synthesize` builds the workload in numpy from ``default_rng(seed)``
with the JAX package's very code, so both packages refine the same arrays.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from ..models import pose_graph as pg
from ..models import schur
from . import schur_dist
from .mesh import MapMesh


class MegaMapProblem(NamedTuple):
    truth_poses: np.ndarray    # (T, 3)
    truth_lms: np.ndarray      # (N, 2)
    graph: pg.PoseGraph        # odometry + loop-closure edges, drifted init
    bundle: schur.BundleProblem


def _numpy_dtype(dtype) -> np.dtype:
    """A torch or numpy float dtype as the numpy dtype."""
    return np.dtype({torch.float32: np.float32,
                     torch.float64: np.float64}.get(dtype, dtype))


def synthesize(N: int, T: int, obs_per_pose: int, seed: int = 0,
               drift: float = 0.002, meas_noise: float = 1e-3,
               dtype=torch.float32) -> MegaMapProblem:
    """Build a loop trajectory over an N-landmark grid with drifted odometry,
    one loop-closure edge, and a sweep observation schedule covering every
    landmark (host-side numpy, once). Every array is numpy, in ``dtype``
    (torch or numpy) for the floats."""
    rng = np.random.default_rng(seed)
    side = math.ceil(math.sqrt(N))
    ii = np.arange(N)
    extent = max(side, 4) * 1.0
    lms = np.stack([(ii % side + 0.5 - side / 2) * (extent / side) * 2,
                    (ii // side + 0.5 - side / 2) * (extent / side) * 2],
                   axis=-1)

    th = np.linspace(0, 2 * np.pi, T, endpoint=False)
    radius = extent * 0.5
    truth = np.stack([th + np.pi / 2,
                      radius * np.cos(th), radius * np.sin(th)], -1)

    def np_wrap(a):
        return np.arctan2(np.sin(a), np.cos(a))

    def np_rel(a, b):
        """to_pose(inv(T_a) @ T_b) for pose rows [th, x, y]."""
        c, s = np.cos(a[..., 0]), np.sin(a[..., 0])
        dx = b[..., 1] - a[..., 1]
        dy = b[..., 2] - a[..., 2]
        return np.stack([np_wrap(b[..., 0] - a[..., 0]),
                         c * dx + s * dy, -s * dx + c * dy], axis=-1)

    rel = np_rel(truth[:-1], truth[1:])                      # (T-1, 3)
    rels = rel + np.stack(
        [drift + rng.normal(0, drift / 4, T - 1),
         rng.normal(0, drift / 4, T - 1),
         rng.normal(0, drift / 4, T - 1)], axis=-1)
    # accumulate the drifted chain: odo_{t+1} = odo_t o rels_t
    odo_th = np.concatenate([[truth[0, 0]],
                             truth[0, 0] + np.cumsum(rels[:, 0])])
    c, s = np.cos(odo_th[:-1]), np.sin(odo_th[:-1])
    steps = np.stack([c * rels[:, 1] - s * rels[:, 2],
                      s * rels[:, 1] + c * rels[:, 2]], axis=-1)
    odo_xy = np.concatenate(
        [truth[0:1, 1:3], truth[0, 1:3] + np.cumsum(steps, axis=0)], axis=0)
    odo = np.concatenate([odo_th[:, None], odo_xy], axis=-1)

    # pose graph: odometry chain + one loop closure (last -> first, truth)
    ei = np.arange(T - 1, dtype=np.int32)
    info_odo = np.eye(3) * (1.0 / drift) ** 2
    z_loop = np_rel(truth[-1], truth[0])
    npdt = _numpy_dtype(dtype)
    graph = pg.PoseGraph(
        poses=odo.astype(npdt),
        edge_i=np.concatenate([ei, np.array([T - 1], np.int32)]),
        edge_j=np.concatenate([ei + 1, np.array([0], np.int32)]),
        meas=np.concatenate([rels, z_loop[None]]).astype(npdt),
        info=np.concatenate(
            [np.broadcast_to(info_odo, (T - 1, 3, 3)),
             (np.eye(3) * 1e6)[None]]).astype(npdt),
        weight=np.ones(T, npdt),
    )

    # observations: every landmark is seen from THREE poses spread around
    # the loop (t, t+T/3, t+2T/3): the landmark-level loop closures a real
    # survey has; with only adjacent-pose sightings the bundle would be
    # gauge-soft and refinement could not recover the true geometry
    t_base = np.repeat(np.arange(T), obs_per_pose)          # (T*OBS,)
    j_base = np.arange(T * obs_per_pose) % N
    offsets = np.array([0, T // 3, (2 * T) // 3])
    tt = ((t_base[:, None] + offsets[None, :]) % T).reshape(-1)
    jj = np.broadcast_to(j_base[:, None], (len(j_base), 3)).reshape(-1)
    dxy = lms[jj] - truth[tt, 1:3]
    rr = np.hypot(dxy[:, 0], dxy[:, 1])
    brg = np.arctan2(dxy[:, 1], dxy[:, 0]) - truth[tt, 0]
    obs_z = np.stack(
        [rr + rng.normal(0, meas_noise, rr.shape),
         np.arctan2(np.sin(brg), np.cos(brg))
         + rng.normal(0, meas_noise, rr.shape)], axis=-1)
    M = len(tt)

    bundle = schur.BundleProblem(
        poses=odo.astype(npdt),            # replaced by stage-1 output
        landmarks=(lms + rng.normal(0, 0.05, lms.shape)).astype(npdt),
        odo_meas=rels.astype(npdt),
        odo_info=info_odo.astype(npdt),
        obs_t=np.asarray(tt, np.int32),
        obs_j=np.asarray(jj, np.int32),
        obs_z=obs_z.astype(npdt),
        obs_info=(np.eye(2) / meas_noise ** 2).astype(npdt),
        obs_w=np.ones(M, npdt),
        anchor_w=np.asarray(1e8, npdt),
    )
    return MegaMapProblem(
        truth_poses=truth.astype(npdt),
        truth_lms=lms.astype(npdt),
        graph=graph, bundle=bundle)


def run_megamap(N: int = 1024, T: int = 64, obs_per_pose: int = 16,
                mesh=1, pg_iters: int = 8, gn_iters: int = 4,
                cg_iters: int = 48, dtype=torch.float32, device=None):
    """Two-stage refinement; returns (problem, refined BundleProblem).

    Stage 1 (loop closure) runs on the host in float64; stage 2 (the
    Schur refinement) over ``mesh``'s map shards: a ``MapMesh`` (on its
    device; the refined problem holds this process's shards' landmarks
    and observations), or a shard count for one process on ``device``
    (``None``: the card, and raise where there is none). The synthesized
    arrays reach the device once, when stage 2 takes them."""
    if not isinstance(mesh, MapMesh):
        mesh = MapMesh(int(mesh), resolve(device))
    prob = synthesize(N, T, obs_per_pose, dtype=dtype)
    # stage 1: loop closure on the pose graph, on the host in f64
    g = pg.optimize_host(prob.graph, iters=pg_iters)
    # stage 2: map-sharded Schur bundle refinement from the closed poses
    part = schur_dist.partition_problem(prob.bundle._replace(poses=g.poses),
                                        mesh.shards)
    step = schur_dist.make_sharded_gn(
        mesh, T=T, N=N, M=part.obs_t.shape[0], cg_iters=cg_iters,
        gn_steps=gn_iters)
    return prob, step(part)
