"""Config-5 benchmark of the port: pose-graph loop closure and map-sharded
Schur bundle refinement on a 50,000-landmark map, on one CUDA card (the
port's counterpart of ``benchmarks/bench_megamap.py``).

    python -m shermbot_navigation_tpu_torch.bench_megamap [--N 50000]
        [--T 512] [--obs 97] [--gn 12] [--cg 64] [--shards 1]
        [--device cpu]

Prints ONE JSON line with ``bench_megamap.py``'s keys -- ``metric``,
``N_landmarks``, ``keyframes``, ``observations``, ``gn_steps``,
``cg_iters``, ``end_to_end_s``, ``posegraph_5iters_s``, ``partition_s``,
``schur_stage2_s``, ``schur_gn_step_s``, ``refined_pose_ate_m``,
``refined_landmark_rmse_m``, ``synthesize_s`` -- unrounded, plus
``n_shards``, ``device`` (the card's name and power limit as
``nvidia-smi`` reports them) and ``execution`` (``"eager"``: one launch an
op, no graph capture).

The run is f32, as the JAX bench's. The stages: ``megamap.synthesize``
(host numpy), the loop closure ``pose_graph.optimize_host`` (5
iterations, host float64), the partition into map shards (host numpy),
and stage 2 (``schur_dist.make_sharded_gn`` on the device, ``--gn`` GN
steps of ``--cg`` CG iterations, the problem's arrays copied to the device
when the step takes them). Stage 2 is timed on
its second run, the first warming the allocator, with the card
synchronized before the clock stops; ``end_to_end_s`` is the sum of the
four stages. ``--obs`` defaults to the JAX bench's ``max(1, 2N // T //
2)``: 97 at N=50000, T=512.

There is no C++ row: the shared C++ engine (``native/``) has no
refinement, so config 5 has no CPU baseline.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import card_name
from .device import resolve
from .models import pose_graph as pg
from .parallel import megamap, schur_dist

PG_ITERS = 5


def rms_errors(prob: megamap.MegaMapProblem, out) -> tuple[float, float]:
    """(pose ATE, landmark RMSE) in m: RMS position errors against the
    truth, in f64."""
    pe = out.poses[:, 1:].double().cpu().numpy() - prob.truth_poses[:, 1:]
    le = out.landmarks.double().cpu().numpy() - prob.truth_lms
    return (float(np.sqrt(np.mean(np.sum(pe ** 2, -1)))),
            float(np.sqrt(np.mean(np.sum(le ** 2, -1)))))


def measure(N: int, T: int, obs: int, gn: int, cg: int, n_shards: int,
            device):
    """Time the four stages; returns (JSON row, problem, refined bundle)."""
    device = resolve(device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    t0 = time.perf_counter()
    prob = megamap.synthesize(N, T, obs)
    t_synth = time.perf_counter() - t0

    t0 = time.perf_counter()
    g = pg.optimize_host(prob.graph, iters=PG_ITERS)
    t_pg = time.perf_counter() - t0

    t0 = time.perf_counter()
    part = schur_dist.partition_problem(prob.bundle._replace(poses=g.poses),
                                        n_shards)
    t_part = time.perf_counter() - t0
    step = schur_dist.make_sharded_gn(
        n_shards, T=T, N=N, M=part.obs_t.shape[0], cg_iters=cg,
        gn_steps=gn, device=device)
    step(part)
    sync()
    t0 = time.perf_counter()
    out = step(part)
    sync()
    t_stage2 = time.perf_counter() - t0

    ate, lm_err = rms_errors(prob, out)
    row = {
        "metric": "megamap_refinement",
        "N_landmarks": N,
        "keyframes": T,
        "observations": int(part.obs_t.shape[0]),
        "gn_steps": gn,
        "cg_iters": cg,
        "end_to_end_s": t_synth + t_pg + t_part + t_stage2,
        "posegraph_5iters_s": t_pg,
        "partition_s": t_part,
        "schur_stage2_s": t_stage2,
        "schur_gn_step_s": t_stage2 / gn,
        "refined_pose_ate_m": ate,
        "refined_landmark_rmse_m": lm_err,
        "synthesize_s": t_synth,
        "n_shards": n_shards,
        "device": card_name(device),
        "execution": "eager",
    }
    return row, prob, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--N", type=int, default=50000)
    ap.add_argument("--T", type=int, default=512)
    ap.add_argument("--obs", type=int, default=None,
                    help="observations a keyframe (default max(1, 2N//T//2))")
    ap.add_argument("--gn", type=int, default=12)
    ap.add_argument("--cg", type=int, default=64)
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for a CPU run")
    args = ap.parse_args(argv)
    obs = args.obs or max(1, (2 * args.N) // args.T // 2)
    row, _, _ = measure(args.N, args.T, obs, args.gn, args.cg, args.shards,
                        args.device)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
