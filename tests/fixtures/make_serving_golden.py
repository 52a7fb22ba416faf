"""Write ``serving_n2048_golden.json``: the JAX reference's final state of
the config-4 serving workload at full width, for ``chip_smoke.py``.

Runs the JAX package's XLA deferred path (no Pallas kernel; the CPU
backend) in f32 at N=2048 landmarks, M=8 measurements a tick, T=320 ticks,
with ``run_bigmap``'s Q = diag(1e-4) and R = diag(1e-3). T exceeds
N/M = 256, so the last ticks run the update branch on a full map.

    python tests/fixtures/make_serving_golden.py

The file holds a few KB: the final robot mean and covariance, ``n_seen``,
the pose error against the closed-form trajectory, sums of the landmark
means, the own-block diagonal and the grid planes, and grid entries at
seeded sample positions.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

N, M, T = 2048, 8, 320
N_SAMPLES = 32
SAMPLE_SEED = 7
OUT = Path(__file__).with_name("serving_n2048_golden.json")


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


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from shermbot_navigation_tpu.parallel import bigmap

    t0 = time.perf_counter()
    state, wl = bigmap.run_bigmap(N=N, T=T, M=M, dtype=jnp.float32)
    jax.block_until_ready(state)
    seconds = time.perf_counter() - t0
    st = {k: np.asarray(v)[0] for k, v in state._asdict().items()}
    true = np.asarray(bigmap._true_pose(wl.cmd, jnp.float32(T),
                                        jnp.float32))
    pos = sample_positions(N, N_SAMPLES, SAMPLE_SEED)
    golden = {
        "source": "shermbot_navigation_tpu.parallel.bigmap.run_bigmap, "
                  "XLA deferred path, CPU, float32",
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
    OUT.write_text(json.dumps(golden, indent=1) + "\n")
    print(f"wrote {OUT} ({seconds:.1f} s)")


if __name__ == "__main__":
    main()
