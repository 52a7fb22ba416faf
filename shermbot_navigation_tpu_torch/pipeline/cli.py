"""Command-line interface (port of
``shermbot_navigation_tpu.pipeline.cli``).

Subcommands:

- ``run``    -- run a registered scenario end to end on one world of the
               dense engine (``driver.run_scenario``) and print its
               metrics as one JSON line (ATE/RPE/NEES/n_seen); on the card
               unless ``--device cpu``; ``--engine native`` runs the
               shared C++ host engine instead.
- ``frames`` -- the SE(2) frame calculator: reads T_ab, T_bc, a vector, a
               twist and a frame name; prints all six transforms and the
               vector/twist in frames a/b/c (the reference CLI demo,
               ``rigid2d/src/main.cpp:5-101``).
- ``bench``  -- the port's headline benchmark (``bench.main``; its
               arguments follow).

Usage::

    python -m shermbot_navigation_tpu_torch.pipeline.cli run --scenario loop5_known
    python -m shermbot_navigation_tpu_torch.pipeline.cli frames < input.txt
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch


def run_metrics(scn, outs) -> dict:
    """The ``run`` line of a stacked TickOutput."""
    from . import metrics
    return {
        "scenario": scn.name,
        "steps": int(outs.n_seen.shape[0]),
        "n_seen": int(outs.n_seen[-1]),
        "ate_slam_m": float(metrics.ate(outs.slam_pose[:, 1:],
                                        outs.true_pose[:, 1:])),
        "ate_odom_m": float(metrics.ate(outs.odom_pose[:, 1:],
                                        outs.true_pose[:, 1:])),
        "heading_rmse_rad": float(metrics.heading_rmse(
            outs.slam_pose[:, 0], outs.true_pose[:, 0])),
        "rpe_m": float(metrics.rpe(outs.slam_pose, outs.true_pose)),
        "mean_nees": float(outs.nees.mean()),
    }


def _cmd_run(args):
    if args.engine == "native":
        return _run_native(args)

    from ..device import resolve
    from .config import get_scenario
    from .driver import run_scenario
    from .viz import write_trajectory_csv

    device = resolve(args.device)
    scn = get_scenario(args.scenario)
    dtype = torch.float64 if args.f64 else torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    outs = run_scenario(scn, gen, dtype, device)
    out = run_metrics(scn, outs)
    if args.traj:
        write_trajectory_csv(args.traj, outs)
    print(json.dumps(out))


def native_refusal(scn) -> str | None:
    """Why the native engine cannot run ``scn``, or None. It implements
    the reference algorithm exactly (first-hit association, gates
    0.01/60, unwrapped innovations, Q=.1/R=.001, reference slip, circle
    commands, dense capacity up to 1024), and a scenario that configures
    anything else is refused rather than run with other algorithms under
    its name."""
    if scn.command[0] != "circle":
        return "native engine supports circle commands only"
    unsupported = []
    if scn.assoc_mode != "first_hit":
        unsupported.append(f"assoc_mode={scn.assoc_mode}")
    if scn.wrap_innovation:
        unsupported.append("wrap_innovation")
    if scn.slip_mode != "reference":
        unsupported.append(f"slip_mode={scn.slip_mode}")
    if (scn.match_gate, scn.new_gate) != (0.01, 60.0):
        unsupported.append(f"gates={scn.match_gate}/{scn.new_gate}")
    if tuple(scn.q_diag) != (0.1, 0.1, 0.1) or tuple(scn.r_diag) != (
            0.001, 0.001):
        unsupported.append("non-default Q/R")
    if scn.scan_noise or scn.sensor_dropout or scn.scan_dropout:
        unsupported.append("scan_noise/dropout")
    if unsupported:
        return ("native engine runs the reference algorithm only; scenario "
                f"'{scn.name}' configures: {', '.join(unsupported)} — use "
                "the torch engine for these knobs")
    if scn.num_landmarks > 1024:
        return (f"native engine is dense O(D^3); capacity "
                f"{scn.num_landmarks} is a large-map workload — use the "
                "torch blocked/megamap engines")
    return None


def _run_native(args):
    """Run the scenario on the in-process C++ host engine (``native.py``)
    -- the reference pipeline on the host, with no card. Deterministic
    (noise at its mean) when --seed >= 0; a negative seed enables sampled
    noise (seeded with |seed|)."""
    from ..native import HostEngine
    from .config import get_scenario
    from .viz import TRAJ_HEADER

    scn = get_scenario(args.scenario)
    refused = native_refusal(scn)
    if refused:
        raise SystemExit(refused)
    w, v = scn.command[1], scn.command[2]
    eng = HostEngine(
        tubes=list(scn.tubes), capacity=scn.num_landmarks,
        known_assoc=scn.known_association, use_lidar=scn.use_lidar,
        max_range=scn.max_range, tube_var=scn.tube_var,
        twist_noise=scn.twist_noise, slip_min=scn.slip_min,
        slip_max=scn.slip_max, cmd=(w, v), deterministic=args.seed >= 0,
        seed=abs(args.seed) + 12345, steps=scn.steps)
    traj = open(args.traj, "w") if args.traj else contextlib.nullcontext()
    with eng, traj as tf:
        if tf:
            tf.write(TRAJ_HEADER)
        for t in range(scn.steps):
            n_seen = eng.tick(w, v)
            if tf:
                p = eng.poses
                row = (*p["truth"], *p["odom"], *p["slam"])
                tf.write(str(t) + "," +
                         ",".join(f"{x:.12g}" for x in row) +
                         f",{n_seen}\n")
        out = {
            "scenario": scn.name,
            "engine": "native",
            "steps": scn.steps,
            "n_seen": eng.n_seen,
            "ate_slam_m": eng.ate,
            "ate_odom_m": eng.ate_odom,
        }
    print(json.dumps(out))


def _cmd_frames(args):
    """Frame calculator (ref rigid2d/src/main.cpp): input is T_ab (deg dx
    dy), T_bc (deg dx dy), a vector (x y), a frame (a|b|c), a twist (w x
    y), a frame -- whitespace separated on stdin. f32 on the CPU, as the
    JAX package computes it, so both print the same characters."""
    from ..ops import se2

    toks = sys.stdin.read().replace(",", " ").split()
    vals = iter(toks)
    f32 = torch.float32

    def nums(n):
        return [float(next(vals)) for _ in range(n)]

    def parts(deg, dx, dy):
        return se2.from_parts(torch.tensor([dx, dy], dtype=f32),
                              se2.deg2rad(torch.tensor(deg, dtype=f32)))

    T_ab = parts(*nums(3))
    T_bc = parts(*nums(3))

    def show(name, T):
        print(f"{name}: dtheta (degrees): "
              f"{float(se2.rad2deg(se2.angle(T))):.6g} "
              f"dx: {float(T[2]):.6g} dy: {float(T[3]):.6g}")

    T_ba = se2.inv(T_ab)
    T_cb = se2.inv(T_bc)
    T_ac = se2.compose(T_ab, T_bc)
    T_ca = se2.inv(T_ac)
    for name, T in [("T_ab", T_ab), ("T_ba", T_ba), ("T_bc", T_bc),
                    ("T_cb", T_cb), ("T_ac", T_ac), ("T_ca", T_ca)]:
        show(name, T)

    v = torch.tensor(nums(2), dtype=f32)
    frame = next(vals)
    to_a = {"a": se2.identity(f32, "cpu"), "b": T_ab, "c": T_ac}[frame]
    v_a = se2.apply(to_a, v)
    v_b = se2.apply(se2.inv(T_ab), v_a)
    v_c = se2.apply(se2.inv(T_ac), v_a)
    print(f"v_a: [{float(v_a[0]):.6g} {float(v_a[1]):.6g}]")
    print(f"v_b: [{float(v_b[0]):.6g} {float(v_b[1]):.6g}]")
    print(f"v_c: [{float(v_c[0]):.6g} {float(v_c[1]):.6g}]")

    tw = torch.tensor(nums(3), dtype=f32)
    frame = next(vals)
    tw_a = se2.adjoint_twist(to_a, tw)
    tw_b = se2.adjoint_twist(se2.inv(T_ab), tw_a)
    tw_c = se2.adjoint_twist(se2.inv(T_ac), tw_a)
    for name, t in [("V_a", tw_a), ("V_b", tw_b), ("V_c", tw_c)]:
        print(f"{name}: angular velocity: {float(t[0]):.6g} "
              f"vx: {float(t[1]):.6g} vy: {float(t[2]):.6g}")


def _cmd_bench(args, rest):
    from .. import bench
    return bench.main(rest)


def main(argv=None):
    p = argparse.ArgumentParser(prog="shermbot-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a scenario")
    pr.add_argument("--scenario", default="stock6")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--f64", action="store_true")
    pr.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for a CPU run")
    pr.add_argument("--engine", default="torch", choices=["torch", "native"],
                    help="torch (the port, on the card or the CPU) or "
                         "native (the in-process C++ engine)")
    pr.add_argument("--traj", default=None, help="write trajectory CSV")
    pr.set_defaults(fn=_cmd_run)

    pf = sub.add_parser("frames", help="SE(2) frame calculator (stdin)")
    pf.set_defaults(fn=_cmd_frames)

    pb = sub.add_parser("bench", help="headline benchmark (the port's "
                                      "bench arguments follow)",
                        add_help=False)
    pb.set_defaults(fn=_cmd_bench)

    args, rest = p.parse_known_args(argv)
    if args.cmd == "bench":
        return args.fn(args, rest)
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
