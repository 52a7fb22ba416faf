"""Write the JAX reference's golden fixtures for ``chip_smoke.py``.

All four come from the JAX package's XLA paths (no Pallas kernel; the CPU
backend) in f32, at full width:

- ``serving_n2048_golden.json`` (``known``): config-4 serving,
  ``bigmap.run_bigmap`` at N=2048 landmarks, M=8 measurements a tick,
  T=320 ticks, Q = diag(1e-4), R = diag(1e-3). T exceeds N/M = 256, so
  the last ticks run the update branch on a full map.
- ``serving_unknown_n2048_golden.json`` (``unknown``): the same sweep
  through ``bigmap.make_unknown_runner`` -- the ids are dropped and every
  measurement goes through the first-hit Mahalanobis gates. It also keeps
  ``n_seen`` after every tick (the association decisions), the robot mean
  after every tick, and sums over the seen slots only.
- ``dense_n2048_golden.json`` (``dense``): the dense engine on
  ``benchmarks/bench_dense_serving.py``'s workload -- a converged map of
  N=2048 seen landmarks (D = 3+2N = 4099) with covariance diag 0.01, ids
  ``[tM, tM+M) mod N``, exact measurements, twist 0, Q = 1e-6 I,
  R = 1e-3 I, ``symmetrize=False``, ``pallas_update='off'``, 32 ticks.

- ``loop5_golden.json`` (``loop5``): config 1, scenario ``loop5_known``
  (5 tubes, known association, no noise: every draw is scaled by zero, so
  every world is the same), 600 ticks of 5 sim substeps, through
  ``pipeline/driver.run_scenario_batch_lanes`` for 4 keys. It holds
  ``n_seen`` at every tick, the three poses every 5th tick and each
  world's ATE over all 600 ticks.
- ``course12_golden.json`` (``course12``): config 2, scenario
  ``course12_noisy`` (12 tubes, unknown association at the reference's
  first-hit gates, twist noise 0.001, slip 0.9-1.0), 600 ticks, through
  ``run_scenario_batch_lanes`` for 8 worlds: 7 noisy ones from fixed
  keys, and a deterministic one (``twist_noise=0``, ``slip_min = slip_max
  = 0.95``, the C++ ``--deterministic`` setup), which is the same scenario
  with every draw at zero. It holds the twist and slip normals the JAX key
  tree draws for the noisy worlds (the only draws this scenario scales by
  something other than zero; little-endian f32, base64), ``n_seen`` at
  every tick, the three poses at every tick (f32, base64) and each world's
  ATE.
- ``lidar20_golden.json`` (``lidar20``): config 3, scenario
  ``lidar20_full`` (20 tubes, 360 rays, 16 clusters of 64 points, unknown
  association at the reference's first-hit gates, slip 0.95-1.0, 600 ticks
  of 5 sim substeps) through ``pipeline/driver.run_scenario_batch_lanes``
  for 8 worlds: 7 noisy ones from fixed keys, and a deterministic one
  (slip 0.975, no noise), which is the same scenario with every slip draw
  at zero. It holds the standard slip normals the JAX key tree draws for
  the noisy worlds (the only draws this scenario scales by something other
  than zero; little-endian f32, base64), the number of valid detections
  and ``n_seen`` at every tick, the three poses every 10th tick, and each
  world's final ATE.

    python tests/fixtures/make_serving_golden.py [known] [unknown] [dense] [lidar20] [loop5] [course12]

(no argument: all six). The first three files hold a few KB: final robot
mean and covariance, landmark and covariance sums, and covariance entries
at seeded sample positions; ``lidar20`` ~0.4 MB, most of it noise;
``loop5`` ~0.1 MB; ``course12`` ~0.7 MB, most of it noise and poses.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

N, M, T = 2048, 8, 320
T_DENSE = 32
N_SAMPLES = 32
SAMPLE_SEED = 7
HERE = Path(__file__).resolve().parent
OUT = {"known": HERE / "serving_n2048_golden.json",
       "unknown": HERE / "serving_unknown_n2048_golden.json",
       "dense": HERE / "dense_n2048_golden.json",
       "lidar20": HERE / "lidar20_golden.json",
       "loop5": HERE / "loop5_golden.json",
       "course12": HERE / "course12_golden.json"}
LIDAR_KEYS_SEED = 20      # PRNGKey(seed) split into the noisy worlds' keys
LIDAR_NOISY = 7
LIDAR_POSE_EVERY = 10
LOOP5_KEYS_SEED, LOOP5_WORLDS, LOOP5_POSE_EVERY = 0, 4, 5
COURSE12_KEYS_SEED, COURSE12_NOISY = 12, 7


def sample_positions(n: int, k: int, seed: int):
    """Grid sample positions (p, q, row, col): half on own 2x2 blocks,
    half anywhere."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pq = rng.integers(0, 2, (k, 2))
    rows = rng.integers(0, n, k)
    cols = np.where(np.arange(k) % 2 == 0, rows, rng.integers(0, n, k))
    return [[int(a), int(b), int(r), int(c)]
            for (a, b), r, c in zip(pq, rows, cols)]


def dense_sample_positions(n_updated: int, k: int, seed: int):
    """Dense covariance sample positions (row, col) in the logical
    3+2N block: a quarter on the robot rows, a quarter on the own 2x2
    blocks of landmarks the run updated, a quarter between two updated
    landmarks, a quarter anywhere."""
    import numpy as np
    rng = np.random.default_rng(seed)
    D = 3 + 2 * N
    out = []
    for i in range(k):
        lm = 3 + 2 * rng.integers(0, n_updated, 2) + rng.integers(0, 2, 2)
        kind = i % 4
        if kind == 0:
            rc = (rng.integers(0, 3), lm[1])
        elif kind == 1:
            rc = (lm[0], 3 + 2 * ((lm[0] - 3) // 2) + rng.integers(0, 2))
        elif kind == 2:
            rc = (lm[0], lm[1])
        else:
            rc = tuple(rng.integers(0, D, 2))
        out.append([int(rc[0]), int(rc[1])])
    return out


def _blocked_summary(st, true, extra=None):
    import numpy as np
    pos = sample_positions(N, N_SAMPLES, SAMPLE_SEED)
    out = {
        "N": N, "M": M, "T": T, "Q_diag": 1e-4, "R_diag": 1e-3,
        "mean_r": st["mean_r"].tolist(),
        "true_pose": true.tolist(),
        "pose_err": float(np.hypot(*(st["mean_r"][1:] - true[1:]))),
        "n_seen": int(st["n_seen"]),
        "cov_rr": st["cov_rr"].reshape(-1).tolist(),
        "sum_mean_m": float(st["mean_m"].astype(np.float64).sum()),
        "sum_abs_mean_m": float(np.abs(st["mean_m"].astype(np.float64)).sum()),
        "sum_diag4": float(st["diag4"].astype(np.float64).sum()),
        "sum_cov_mm": float(st["cov_mm"].astype(np.float64).sum()),
        "grid_samples": {"positions": pos,
                         "values": [float(st["cov_mm"][a, b, r, c])
                                    for a, b, r, c in pos]},
    }
    out.update(extra or {})
    return out


def known_golden(jax, jnp, np):
    from shermbot_navigation_tpu.parallel import bigmap
    state, wl = bigmap.run_bigmap(N=N, T=T, M=M, dtype=jnp.float32)
    jax.block_until_ready(state)
    st = {k: np.asarray(v)[0] for k, v in state._asdict().items()}
    true = np.asarray(bigmap._true_pose(wl.cmd, jnp.float32(T),
                                        jnp.float32))
    return {"source": "shermbot_navigation_tpu.parallel.bigmap.run_bigmap, "
                      "XLA deferred path, CPU, float32",
            **_blocked_summary(st, true)}


def unknown_golden(jax, jnp, np):
    from jax.sharding import NamedSharding
    from shermbot_navigation_tpu.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu.parallel import bigmap, blocked_ekf
    from shermbot_navigation_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(jax.devices()[:1], data=1)
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    run = bigmap.make_unknown_runner(cfg, mesh, 1, M, donate=True)
    state = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        blocked_ekf.init(cfg, 1, dtype=jnp.float32),
        blocked_ekf.state_sharding(mesh))
    Q = jnp.diag(jnp.array([1e-4] * 3, jnp.float32))
    R = jnp.diag(jnp.array([1e-3] * 2, jnp.float32))
    n_seen, mean_r = [], []
    for t in range(T):
        state = run(state, wl, Q, R, jnp.int32(t), 1)
        n_seen.append(int(state.n_seen[0]))
        mean_r.append(np.asarray(state.mean_r[0]).tolist())
    st = {k: np.asarray(v)[0] for k, v in state._asdict().items()}
    true = np.asarray(bigmap._true_pose(wl.cmd, jnp.float32(T),
                                        jnp.float32))
    # slots fill in order; sums over the seen ones (the unseen hold the
    # INT_MAX prior, which would swamp a whole-grid sum)
    ns = int(st["n_seen"])
    return {"source": "shermbot_navigation_tpu.parallel.bigmap."
                      "make_unknown_runner, XLA deferred path, CPU, float32",
            **_blocked_summary(st, true, {
                "n_seen_per_tick": n_seen, "mean_r_per_tick": mean_r,
                "sum_diag4_seen": float(
                    st["diag4"][:, :ns].astype(np.float64).sum()),
                "sum_cov_mm_seen": float(
                    st["cov_mm"][:, :, :ns, :ns].astype(np.float64).sum()),
                "sum_cov_rm_seen": float(
                    st["cov_rm"][:, :ns].astype(np.float64).sum())})}


def dense_golden(jax, jnp, np):
    from benchmarks import bench_dense_serving as bench
    from shermbot_navigation_tpu.models.ekf_slam import EKFConfig
    assert (bench.N, bench.M) == (N, M)
    cfg = EKFConfig(num_landmarks=N, pallas_update="off", symmetrize=False)
    st0, lms = bench.make_seeded_state(cfg)
    st = bench.make_dense_runner(cfg, lms, T_DENSE)(st0)
    jax.block_until_ready(st)
    mean, cov = np.asarray(st.mean), np.asarray(st.cov)
    mean0 = np.asarray(st0.mean)
    pos = dense_sample_positions(min(N, T_DENSE * M), 64, SAMPLE_SEED)
    return {
        "source": "shermbot_navigation_tpu.models.ekf_slam."
                  "known_association_step on benchmarks/"
                  "bench_dense_serving.py's workload, pallas_update='off', "
                  "symmetrize=False, CPU, float32",
        "N": N, "M": M, "T": T_DENSE, "D": int(cfg.dim), "Q_diag": 1e-6,
        "R_diag": 1e-3, "cov_diag0": 0.01,
        "n_seen": int(st.n_seen),
        "mean_r": mean[:3].tolist(),
        "max_abs_mean_shift": float(np.abs(mean - mean0).max()),
        "sum_mean_m": float(mean[3:].astype(np.float64).sum()),
        "cov_rr": cov[:3, :3].reshape(-1).tolist(),
        "sum_diag": float(np.diag(cov).astype(np.float64).sum()),
        "sum_cov": float(cov.astype(np.float64).sum()),
        "cov_samples": {"positions": pos,
                        "values": [float(cov[r, c]) for r, c in pos]},
    }


def _lidar_run(jax, jnp, np, scn, keys):
    """``run_scenario_batch_lanes`` outputs plus the number of valid
    detections per tick (the sense chain alone, replayed beside it)."""
    from shermbot_navigation_tpu.pipeline import driver
    outs = driver.run_scenario_batch_lanes(scn, keys, None, jnp.float32)
    params = scn.world_params(jnp.float32)
    cmds = driver.command_twist(scn, jnp.arange(scn.steps), jnp.float32)

    def one(key):
        st = driver.init_pipeline(scn, jnp.float32)._replace(key=key)

        def body(sense, cmd):
            sense, _, _, valid, _ = driver.sense_tick(scn, params, sense, cmd)
            return sense, jnp.sum(valid)

        return jax.lax.scan(body, driver.SenseState(st.world, st.odom,
                                                    st.key), cmds)[1]

    n_det = jax.jit(jax.vmap(one))(keys)
    return ({k: np.asarray(v) for k, v in outs._asdict().items()},
            np.asarray(n_det))


def lidar20_golden(jax, jnp, np):
    import base64
    import dataclasses
    sys.path.insert(0, str(HERE.parent))
    from _torch_parity import replay_tick_noise
    from shermbot_navigation_tpu.pipeline.config import get_scenario
    scn = get_scenario("lidar20_full")
    det = dataclasses.replace(scn, slip_min=0.975, slip_max=0.975)
    keys = jax.random.split(jax.random.PRNGKey(LIDAR_KEYS_SEED), LIDAR_NOISY)
    outs, n_det = _lidar_run(jax, jnp, np, scn, keys)
    douts, dn_det = _lidar_run(jax, jnp, np, det, keys[:1])
    outs = {k: np.concatenate([outs[k], douts[k]]) for k in outs}
    n_det = np.concatenate([n_det, dn_det])
    noise = replay_tick_noise(np.asarray(keys), scn.steps, scn.sim_substeps,
                              360, len(scn.tubes), np.float32)
    slip = np.ascontiguousarray(noise["slip"], "<f4")       # (T, 7, S, 2)
    d = outs["slam_pose"][:, :, 1:].astype(np.float64) \
        - outs["true_pose"][:, :, 1:].astype(np.float64)
    ate = np.sqrt(np.mean(np.sum(d * d, axis=-1), axis=-1))
    ev = slice(LIDAR_POSE_EVERY - 1, None, LIDAR_POSE_EVERY)
    return {
        "source": "shermbot_navigation_tpu.pipeline.driver."
                  "run_scenario_batch_lanes(lidar20_full), XLA, CPU, "
                  "float32; ATE over all 600 ticks, positions [x, y]",
        "scenario": "lidar20_full", "T": scn.steps, "B": LIDAR_NOISY + 1,
        "noisy_worlds": LIDAR_NOISY, "keys_seed": LIDAR_KEYS_SEED,
        "deterministic_world": "last; slip_min = slip_max = 0.975, i.e. "
                               "every slip normal zero",
        "slip_normals_shape": list(slip.shape),
        "slip_normals_f32_b64": base64.b64encode(slip.tobytes()).decode(),
        "n_detections": n_det.tolist(),
        "n_seen": outs["n_seen"].tolist(),
        "pose_every": LIDAR_POSE_EVERY,
        "true_pose": outs["true_pose"][:, ev].tolist(),
        "odom_pose": outs["odom_pose"][:, ev].tolist(),
        "slam_pose": outs["slam_pose"][:, ev].tolist(),
        "ate": ate.tolist(),
    }


def _lanes_run(jnp, np, scn, keys):
    """``run_scenario_batch_lanes`` outputs (numpy) and each world's ATE
    over all ticks, positions [x, y], in f64."""
    from shermbot_navigation_tpu.pipeline import driver
    outs = driver.run_scenario_batch_lanes(scn, keys, None, jnp.float32)
    outs = {k: np.asarray(v) for k, v in outs._asdict().items()}
    d = outs["slam_pose"][:, :, 1:].astype(np.float64) \
        - outs["true_pose"][:, :, 1:].astype(np.float64)
    return outs, np.sqrt(np.mean(np.sum(d * d, axis=-1), axis=-1))


def _b64(np, a):
    import base64
    return base64.b64encode(np.ascontiguousarray(a, "<f4").tobytes()
                            ).decode()


def loop5_golden(jax, jnp, np):
    from shermbot_navigation_tpu.pipeline.config import get_scenario
    scn = get_scenario("loop5_known")
    keys = jax.random.split(jax.random.PRNGKey(LOOP5_KEYS_SEED),
                            LOOP5_WORLDS)
    outs, ate = _lanes_run(jnp, np, scn, keys)
    ev = slice(LOOP5_POSE_EVERY - 1, None, LOOP5_POSE_EVERY)
    return {
        "source": "shermbot_navigation_tpu.pipeline.driver."
                  "run_scenario_batch_lanes(loop5_known), XLA, CPU, "
                  "float32; ATE over all 600 ticks, positions [x, y]",
        "scenario": "loop5_known", "T": scn.steps, "B": LOOP5_WORLDS,
        "keys_seed": LOOP5_KEYS_SEED,
        "note": "no noise: every draw is scaled by zero, so every world "
                "is the same",
        "n_seen": outs["n_seen"].tolist(),
        "pose_every": LOOP5_POSE_EVERY,
        "true_pose": outs["true_pose"][:, ev].tolist(),
        "odom_pose": outs["odom_pose"][:, ev].tolist(),
        "slam_pose": outs["slam_pose"][:, ev].tolist(),
        "ate": ate.tolist(),
    }


def course12_golden(jax, jnp, np):
    import dataclasses
    sys.path.insert(0, str(HERE.parent))
    from _torch_parity import replay_tick_noise
    from shermbot_navigation_tpu.pipeline.config import get_scenario
    scn = get_scenario("course12_noisy")
    det = dataclasses.replace(scn, twist_noise=0.0, slip_min=0.95,
                              slip_max=0.95)
    keys = jax.random.split(jax.random.PRNGKey(COURSE12_KEYS_SEED),
                            COURSE12_NOISY)
    outs, ate = _lanes_run(jnp, np, scn, keys)
    douts, date = _lanes_run(jnp, np, det, keys[:1])
    outs = {k: np.concatenate([outs[k], douts[k]]) for k in outs}
    ate = np.concatenate([ate, date])
    noise = replay_tick_noise(np.asarray(keys), scn.steps, scn.sim_substeps,
                              360, len(scn.tubes), np.float32)
    poses = {f"{f}_f32_b64": _b64(np, outs[f])
             for f in ("true_pose", "odom_pose", "slam_pose")}
    return {
        "source": "shermbot_navigation_tpu.pipeline.driver."
                  "run_scenario_batch_lanes(course12_noisy), XLA, CPU, "
                  "float32; ATE over all 600 ticks, positions [x, y]",
        "scenario": "course12_noisy", "T": scn.steps,
        "B": COURSE12_NOISY + 1, "noisy_worlds": COURSE12_NOISY,
        "keys_seed": COURSE12_KEYS_SEED,
        "deterministic_world": "last; twist_noise = 0, slip_min = "
                               "slip_max = 0.95, i.e. every twist and slip "
                               "normal zero",
        "normals_shape": list(noise["twist"].shape),
        "twist_normals_f32_b64": _b64(np, noise["twist"]),
        "slip_normals_f32_b64": _b64(np, noise["slip"]),
        "n_seen": outs["n_seen"].tolist(),
        "pose_shape": list(outs["slam_pose"].shape),
        **poses,
        "ate": ate.tolist(),
    }


def main(which):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(HERE.parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    makers = {"known": known_golden, "unknown": unknown_golden,
              "dense": dense_golden, "lidar20": lidar20_golden,
              "loop5": loop5_golden, "course12": course12_golden}
    for name in which:
        t0 = time.perf_counter()
        golden = makers[name](jax, jnp, np)
        OUT[name].write_text(json.dumps(golden, indent=1) + "\n")
        print(f"wrote {OUT[name]} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main(sys.argv[1:] or ["known", "unknown", "dense", "lidar20", "loop5",
                          "course12"])
