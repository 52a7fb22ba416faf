"""Headline benchmark of the port: full-pipeline SLAM throughput on one
CUDA card against the measured C++ reference baseline (the port's
counterpart of the repository's ``bench.py``).

    python -m shermbot_navigation_tpu_torch.bench [--engine lanes|vmapped]
        [--scenario loop5_known] [--batch B] [--sweep] [--steps T]
        [--cpp-runs 5] [--device cpu]

Prints ONE JSON line (``--sweep``: one per batch size) with ``bench.py``'s
keys: ``metric``, ``value`` (worlds x ticks / s), ``unit``,
``vs_baseline``, ``baseline_ticks_per_sec``, ``baseline_spread``,
``batch``, ``scenario``, ``engine``, ``ate_m``, ``cpp_ate_m``,
``seconds_per_batch_run``, plus ``device`` (the card's name and power
limit as ``nvidia-smi`` reports them) and ``execution`` (``"eager"``: one
launch an op, no graph capture).

The workload is a scenario's full tick -- 5 tube-world sim substeps,
odometry, the fake sensor, the EKF predict and its sequential updates --
for B independent worlds in lockstep, ``steps`` ticks (the scenario's
600 by default). ``--engine lanes`` is ``run_scenario_batch_lanes`` (the
batch-trailing filter), ``vmapped`` is ``run_scenario_batch`` (the dense
filter under ``torch.func.vmap``). The port is timed as the best of 3
runs after one warm-up run, each from its own seeded ``torch.Generator``,
with the card synchronized before the clock stops. ``ate_m`` is the
median over the worlds of each world's ATE (never an RMSE pooled over the
worlds, which one diverged world would dominate).

The baseline is ``native/baseline/baseline --scenario <s> --deterministic
--repeat 5`` (built with ``make`` when absent), the median of
``--cpp-runs`` runs in the same session, with the spread recorded.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from .device import resolve
from .pipeline import driver
from .pipeline.config import get_scenario

BASELINE_DIR = Path(__file__).resolve().parents[1] / "native" / "baseline"
BASELINE_BIN = BASELINE_DIR / "baseline"
# the scenarios the C++ baseline also runs
SCENARIOS = ("loop5_known", "course12_noisy", "lidar20_full")
# where the lanes engine's eager tick stops gaining throughput on an H100
# (chip_smoke.py's config-1 sweep, phase configs12_sweep: 6.25 M world
# ticks/s at 262144 worlds, 6.53 M at 1048576; PERF.md)
DEFAULT_BATCH = 262144
SWEEP = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
ENGINES = {"lanes": driver.run_scenario_batch_lanes,
           "vmapped": driver.run_scenario_batch}


def measure_cpp(scenario: str, runs: int = 5) -> dict:
    """Median of ``runs`` runs of the C++ baseline with the spread: the
    host's number swings run to run, so one sample is no comparison."""
    if not BASELINE_BIN.exists():
        subprocess.run(["make"], cwd=BASELINE_DIR, check=True,
                       capture_output=True)
    samples = []
    ate = None
    for _ in range(runs):
        out = subprocess.run(
            [str(BASELINE_BIN), "--scenario", scenario, "--deterministic",
             "--repeat", "5"], check=True, capture_output=True, text=True)
        r = json.loads(out.stdout.strip())
        samples.append(r["ticks_per_sec"])
        ate = r["ate"]
    samples.sort()
    return {"ticks_per_sec": samples[len(samples) // 2],
            "ticks_per_sec_min": samples[0],
            "ticks_per_sec_max": samples[-1], "ate": ate}


def card_name(device: torch.device) -> str:
    """``name, power limit`` of the card as ``nvidia-smi`` prints them;
    ``"cpu"`` for a CPU run."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def world_ate(outs) -> torch.Tensor:
    """Each world's RMS position error over the run, (B,) f64."""
    d = outs.slam_pose[..., 1:].double() - outs.true_pose[..., 1:].double()
    return torch.sqrt((d * d).sum(-1).mean(-1))


def measure_port(scenario: str, engine: str, batch: int, steps: int,
                 device) -> dict:
    """Best of 3 timed runs after a warm-up: worlds x ticks / s, the
    seconds of the best run and its median-world ATE."""
    scn = get_scenario(scenario)
    run = ENGINES[engine]
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    def timed(seed):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        sync()
        t0 = time.perf_counter()
        outs = run(scn, g, batch, steps=steps, device=device)
        sync()
        return time.perf_counter() - t0, outs

    timed(0)
    best, outs = min((timed(seed) for seed in (1, 2, 3)),
                     key=lambda r: r[0])
    return {"ticks_per_sec": batch * steps / best, "seconds": best,
            "ate": float(world_ate(outs).median())}


def row(cpp: dict, port: dict, scenario: str, engine: str, batch: int,
        device_name: str) -> dict:
    return {
        "metric": "slam_pipeline_ticks_per_sec_per_chip",
        "value": port["ticks_per_sec"],
        "unit": "ticks/s",
        "vs_baseline": port["ticks_per_sec"] / cpp["ticks_per_sec"],
        "baseline_ticks_per_sec": cpp["ticks_per_sec"],
        "baseline_spread": [cpp["ticks_per_sec_min"],
                            cpp["ticks_per_sec_max"]],
        "batch": batch,
        "scenario": scenario,
        "engine": engine,
        "ate_m": port["ate"],
        "cpp_ate_m": cpp["ate"],
        "seconds_per_batch_run": port["seconds"],
        "device": device_name,
        "execution": "eager",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", choices=sorted(ENGINES), default="lanes")
    ap.add_argument("--scenario", choices=SCENARIOS, default="loop5_known")
    ap.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    ap.add_argument("--sweep", action="store_true",
                    help=f"one row per batch size of {SWEEP}")
    ap.add_argument("--steps", type=int, default=None,
                    help="ticks a run (default: the scenario's)")
    ap.add_argument("--cpp-runs", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for a CPU run")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    steps = args.steps or get_scenario(args.scenario).steps
    name = card_name(device)
    cpp = measure_cpp(args.scenario, args.cpp_runs)
    for batch in (SWEEP if args.sweep else (args.batch,)):
        port = measure_port(args.scenario, args.engine, batch, steps, device)
        print(json.dumps(row(cpp, port, args.scenario, args.engine, batch,
                             name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
