"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its configuration
(``portbench/configs/<config>.json``) names the driver
(``portbench/drivers/<driver>.py``) and its traffic is
``portbench/workloads/<traffic>.json``. The driver sets the cell up from
the seed (counted in ``setup_s``), runs the measured window, and checks the
window's answers against the plain reference once it has closed. With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (``portbench/metrics/<metric>.py``)
from ``torch.profiler`` over the window. The last line of standard output
is the result; the numbers compared, each beside its limit, are the last
lines of standard error. A run that finds no card, or fewer cards than the
cell needs, or JAX or the JAX package loaded, or a per-layer metric that
finds nothing to read in a cell that lists it, prints no result and exits
non-zero.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "shermbot_navigation_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_spec(bench: dict, name: str):
    """The cell's entry, its configuration file and its traffic file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "workloads" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, cfg, mix


def metrics_for(bench: dict, kind: str, name: str) -> list:
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def reader(metric: str):
    """The per-layer reader ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(bench: dict, name: str, summary, run) -> dict:
    """The cell's per-layer metrics from its traced window. A reader that
    finds nothing returns None and the metric is left out, except in a
    cell that the metric lists: there it has something to read, and
    nothing means the program's names moved (``LookupError``)."""
    out = {}
    for m in metrics_for(bench, "per_layer", name):
        value = reader(m["name"])(summary, run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        elif name in m.get("workloads", ()):
            raise LookupError(f"{m['name']} found nothing to read in {name}, "
                              f"which it lists")
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest()
    cell, cfg, mix = cell_spec(bench, args.workload)

    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"portbench: needs {cell['chips']} CUDA card(s), found {cards}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from portbench import trace as tr
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    run = driver.Cell(cfg, mix, args.seed, device)
    # what set-up made lives on: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - START

    summary = None
    if args.trace:
        with tr.Traced() as traced:
            run.window(args.seconds, tr.span)
        summary = traced.summary
    else:
        run.window(args.seconds, tr.no_span)
    peak = torch.cuda.max_memory_allocated(device)

    checks = run.check()
    correct = all(c["holds"] for c in checks) and run.failed == 0

    metrics = {}
    if args.trace:
        try:
            metrics = per_layer(bench, args.workload, summary, run)
        except LookupError as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 5
    else:
        values = dict(run.end_to_end(), setup_s=setup_s)
        for m in metrics_for(bench, "end_to_end", args.workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for line in run.notes():
        print(f"portbench: {line}", file=sys.stderr)
    for c in checks:
        print(f"check {c['name']} {c['value']!r} {c['op']} {c['limit']!r} "
              f"{'holds' if c['holds'] else 'FAILS'}", file=sys.stderr)
    result["limits"] = {c["name"]: {"value": c["value"], "op": c["op"],
                                    "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.exit(main())
