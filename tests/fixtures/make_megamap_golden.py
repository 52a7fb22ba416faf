"""Write ``megamap_golden.json``: the JAX package's config-5 refinement at
full size, the reference that ``chip_smoke.py`` holds the port's run on
the card to.

BASELINE config 5 at ``benchmarks/bench_megamap.py``'s budget:
``parallel.megamap.run_megamap(N=50000, T=512, obs_per_pose=97,
pg_iters=5, gn_iters=12, cg_iters=64)`` on one CPU device (one map
shard), in f32 and in f64. For each dtype the file holds

- ``stage1_poses``: the host float64 loop closure's poses
  (``pose_graph.optimize_host(prob.graph, iters=5)``, cast to the dtype;
  plain numpy, so the port's copy must give the same bits), (T, 3);
- ``poses``: the refined poses, (T, 3);
- ``landmarks_strided``: every ``landmark_stride``-th refined landmark,
  (N / stride, 2);
- ``ate_m`` and ``landmark_rmse_m``: the refined poses' RMS position
  error and the landmarks' RMS error against the truth, in f64 from the
  arrays.

Arrays are little-endian in the run's dtype, base64. ~80 KB.

    python tests/fixtures/make_megamap_golden.py

Takes ~1 min on a CPU (JAX compiles the sharded step for each dtype).
"""

from __future__ import annotations

import base64
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "megamap_golden.json"
CONFIG = {"N": 50000, "T": 512, "obs_per_pose": 97, "pg_iters": 5,
          "gn_iters": 12, "cg_iters": 64}
LANDMARK_STRIDE = 50


def _b64(np, a, dtype):
    return base64.b64encode(
        np.ascontiguousarray(a, np.dtype(dtype).newbyteorder("<")).tobytes()
    ).decode()


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(HERE.parents[1]))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from shermbot_navigation_tpu.models import pose_graph as pg
    from shermbot_navigation_tpu.parallel import megamap

    out = {"config": dict(CONFIG, n_shards=1, seed=0),
           "landmark_stride": LANDMARK_STRIDE}
    c = CONFIG
    for name, dtype in (("f32", jnp.float32), ("f64", jnp.float64)):
        prob, ref = megamap.run_megamap(dtype=dtype, **c)
        stage1 = np.asarray(pg.optimize_host(prob.graph,
                                             iters=c["pg_iters"]).poses)
        poses = np.asarray(ref.poses)
        lms = np.asarray(ref.landmarks)
        pe = poses[:, 1:].astype(np.float64) - prob.truth_poses[:, 1:]
        le = lms.astype(np.float64) - prob.truth_lms
        out["observations"] = int(ref.obs_t.shape[0])
        out[name] = {
            "stage1_poses_b64": _b64(np, stage1, stage1.dtype),
            "poses_b64": _b64(np, poses, poses.dtype),
            "landmarks_strided_b64": _b64(np, lms[::LANDMARK_STRIDE],
                                          lms.dtype),
            "ate_m": float(np.sqrt(np.mean(np.sum(pe ** 2, -1)))),
            "landmark_rmse_m": float(np.sqrt(np.mean(np.sum(le ** 2, -1)))),
        }
        print(name, out[name]["ate_m"], out[name]["landmark_rmse_m"],
              flush=True)
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
