#!/usr/bin/env python3
"""Time the serving tick's two kernels (seq_scan, grid_update) of this
checkout against those of another checkout of the port, on one CUDA card,
in turns; or, with ``--config3``, config 3's tick.

    git archive <commit> | tar -x -C <dir>        # the other checkout
    python3 compare_kernels.py --other <dir> [--sizes 2048,8192,16384]
    python3 compare_kernels.py --other <dir> --config3

Each turn is a fresh process that imports the port, and the two timing
helpers of ``chip_smoke.py`` (``cuda_ms``, ``profiled_device_ms``), from
one checkout, builds its kernels, and at every N: runs the
known-association serving tick through ``ServingEngine`` until the map is
full (N/M + 8 ticks), then times

* ms per serving tick, known and unknown association: host clock around
  synchronized blocks of ``ServingEngine.tick`` calls (update-only ticks on
  the full map). The ticks' measurements are drawn before the clock starts,
  so the workload generator's cost, which differs between checkouts, is in
  neither side's time;
* each kernel's wrapper by CUDA events over back-to-back calls and the
  kernel alone by ``torch.profiler`` (device time), on that tick's real
  operands: the scan with known and with unknown association, the grid
  pass on the operands the scan's op buffers give.

The turns run other, this, this, other, so drift of the card or the host
falls on both alike. Without ``--other`` only this checkout is timed
(twice). One JSON line a turn, then a summary line with the medians. The
wrappers' signatures (``deferred_seq_scan``, ``fused_grid_update``) and
those two helpers are all a checkout has to share with this script. It
imports nothing of JAX.

``--config3`` runs, in each turn, the checkout's own ``chip_smoke.py``
phase 15 (``phase_config3_timing``: config 3 at B=1024 worlds, ms per tick
whole and by stage, world x ticks / s, device kernels a tick and the
device's idle share by ``torch.profiler``, the perception kernels per
call) on the clusters of a real batch of scans (``real_scans``, then
``clustering.cluster_scan``) and the operands of its phases 3 and 7; the
summary gives the medians of each side.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

M = 8


def worker(root: str, sizes):
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs          # the timed checkout's own helpers
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.ops.kernels import grid_update as gu
    from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as sq
    from shermbot_navigation_tpu_torch.parallel import bigmap, blocked_ekf
    from shermbot_navigation_tpu_torch.pipeline import serving

    dev = torch.device("cuda", 0)
    out = {"root": root, "sizes": {}}
    for N in sizes:
        cfg = EKFConfig(num_landmarks=N)
        Q, R = bigmap.noise(device=dev)
        fill = -(-N // M) + 8
        wl = bigmap.make_workload(N, fill + 64, M, device=dev)
        eng = serving.ServingEngine(cfg, M, Q, R, device=dev,
                                    robot_pose=[0.0, 0.0, 0.0])
        for t in range(fill):
            zs, ids, tw = bigmap.measurements(wl, t)
            eng.tick(tw, zs, ids=ids)
        unk = serving.ServingEngine(cfg, M, Q, R, device=dev, known=False)
        clock = [fill]

        def tick_ms(e, known, ticks=20, repeats=3):
            res = []
            for _ in range(repeats):
                drawn = [bigmap.measurements(wl, clock[0] + i)
                         for i in range(ticks)]
                clock[0] += ticks
                torch.cuda.synchronize()
                start = time.perf_counter()
                for zs, ids, tw in drawn:
                    e.tick(tw, zs, ids=ids if known else None)
                torch.cuda.synchronize()
                res.append((time.perf_counter() - start) * 1e3 / ticks)
            return statistics.median(res)

        def device_ms(fn, key):
            for _ in range(4):      # a profile now and then comes back empty
                ms = cs.profiled_device_ms(fn, key, 20)
                if ms is not None:
                    return ms
            return None

        per_tick = {"known": tick_ms(eng, True)}
        unk.state = eng.state          # the full map; the grid is shared
        per_tick["unknown"] = tick_ms(unk, False)
        st = unk.state
        zs, ids, _ = bigmap.measurements(wl, fill)
        valid = torch.ones(M, dtype=torch.bool, device=dev)
        args = (st.mean_r[0], st.mean_m[0].T.contiguous(), st.cov_rr[0],
                st.cov_rm[0].permute(0, 2, 1).reshape(6, N), st.diag4[0],
                st.seen[0], st.n_seen[0], st.cov_mm[0].reshape(4, N, N), zs,
                valid)
        known = lambda: sq.deferred_seq_scan(*args, ids, R, use_kernel=True)
        unknown = lambda: sq.deferred_seq_scan(*args, None, R, known=False,
                                               use_kernel=True)
        res = known()
        grid_ops = blocked_ekf.grid_operands(*res[7:12])
        grid = lambda: gu.fused_grid_update(st.cov_mm[0], *grid_ops,
                                            use_kernel=True)
        rows = {}
        for name, fn, key in (("seq_scan", known, "seq_scan"),
                              ("seq_scan_unknown", unknown, "seq_scan"),
                              ("grid_update", grid, "grid_update")):
            rows[name] = {"ms": cs.cuda_ms(fn, 50),
                          "device_ms": device_ms(fn, key)}
        out["sizes"][str(N)] = {
            "ms_per_tick": per_tick, "kernels": rows,
            "kinds": res[11].tolist(),
            "unknown_kinds": unknown()[11].tolist(),
            "n_seen": int(st.n_seen[0])}
        del eng, unk, st, args, res, grid_ops
        torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


def worker_config3(root: str):
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import chip_smoke as cs          # the timed checkout's own phase 15
    from shermbot_navigation_tpu_torch.ops import clustering
    from shermbot_navigation_tpu_torch.ops.kernels import _build
    from shermbot_navigation_tpu_torch.pipeline.config import get_scenario

    dev = torch.device("cuda", 0)
    _build.build()
    scn = get_scenario("lidar20_full")
    params = scn.world_params(device=dev)
    cl = clustering.cluster_scan(cs.real_scans(dev, scn), params.scan_min,
                                 params.scan_max, max_clusters=cs.C3,
                                 max_points=cs.P3)
    cm_ops = (cl.points.reshape(-1, cs.P3, 2), cl.counts.reshape(-1))
    grid_ops = cs.grid_operands(np.random.default_rng(0), dev)
    lines = []
    cs.emit = lambda **obj: lines.append(obj)
    cov_ops, _ = cs.phase_cov(dev)
    cs.phase_config3_timing(dev, scn, cm_ops, grid_ops, cov_ops)
    row = next(o for o in lines if o.get("phase") == "config3_timing")
    print(json.dumps({"root": root, "config3": row,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def summary_config3(turns, this, other):
    def med(root, pick):
        vals = [v for v in (pick(t["config3"]) for t in turns
                            if t["root"] == root) if v is not None]
        return statistics.median(vals) if vals else None

    prof = lambda key: lambda r: (r.get("profile") or {}).get(key)
    out = {}
    for label, root in (("other", other), ("this", this)):
        out[label] = {
            "ms_per_tick_whole": med(root, lambda r: r["ms_per_tick"]
                                     ["whole"]),
            "ms_per_tick_staged": med(root, lambda r: r["ms_per_tick"]
                                      ["staged"]),
            "ms_per_tick_path_b": med(root, lambda r: r["ms_per_tick"]
                                      ["perception_buffered"]),
            "world_ticks_per_s": med(root, lambda r: r["world_ticks_per_s"]),
            "staged_split_ms": {k: med(root, lambda r, k=k: r[
                "staged_split_ms"][k]) for k in ("noise", "sim",
                                                 "perception", "filter")},
            "device_kernels_per_tick": med(root, prof(
                "device_kernels_per_tick")),
            "device_busy_ms_per_tick": med(root, prof(
                "device_busy_ms_per_tick")),
            "device_idle_share": med(root, prof("device_idle_share")),
            "perception_kernels_per_call": med(root, lambda r: (r.get(
                "perception_profile") or {}).get("device_kernels_per_call"))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--sizes", default="2048,8192,16384")
    ap.add_argument("--config3", action="store_true",
                    help="time config 3's tick instead of the serving "
                         "kernels")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args()
    sizes = [int(s) for s in a.sizes.split(",")]
    if a.worker:
        if a.config3:
            worker_config3(a.worker)
        else:
            worker(a.worker, sizes)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    this = str(Path(__file__).resolve().parent)
    other = str(Path(a.other).resolve()) if a.other else this
    turns = []
    for root in (other, this, this, other):
        run = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", root,
             "--sizes", a.sizes] + (["--config3"] if a.config3 else []),
            capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        turns.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps({"card": card, **turns[-1]}), flush=True)

    if a.config3:
        print(json.dumps({"summary": {
            "card": card, "this": this, "other": other,
            "config3": summary_config3(turns, this, other)}}), flush=True)
        return 0

    def med(root, pick):
        vals = [pick(t) for t in turns if t["root"] == root]
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    summary = {"card": card, "this": this, "other": other, "sizes": {}}
    for n in map(str, sizes):
        row = {}
        for label, root in (("other", other), ("this", this)):
            row[label] = {
                "ms_per_tick": {k: med(root, lambda t: t["sizes"][n][
                    "ms_per_tick"][k]) for k in ("known", "unknown")},
                **{k: {f: med(root, lambda t: t["sizes"][n]["kernels"][k][f])
                       for f in ("ms", "device_ms")}
                   for k in ("seq_scan", "seq_scan_unknown", "grid_update")}}
        summary["sizes"][n] = row
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
