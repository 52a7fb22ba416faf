"""Write the JAX reference's golden fixtures for ``chip_smoke.py``.

All three come from the JAX package's XLA paths (no Pallas kernel; the CPU
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

    python tests/fixtures/make_serving_golden.py [known] [unknown] [dense]

(no argument: all three). Each file holds a few KB: final robot mean and
covariance, landmark and covariance sums, and covariance entries at seeded
sample positions.
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
       "dense": HERE / "dense_n2048_golden.json"}


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


def main(which):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(HERE.parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    makers = {"known": known_golden, "unknown": unknown_golden,
              "dense": dense_golden}
    for name in which:
        t0 = time.perf_counter()
        golden = makers[name](jax, jnp, np)
        OUT[name].write_text(json.dumps(golden, indent=1) + "\n")
        print(f"wrote {OUT[name]} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main(sys.argv[1:] or ["known", "unknown", "dense"])
