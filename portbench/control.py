"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's numbers on each of ``--seeds``, and the
control's on each of ``--control-seeds`` (the plain reference in the
program's place, its matrix products in TF32, the precision below the
float32 the configurations state). One JSON line a run, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s>
        --seeds 1,2,... --control-seeds 7,8,9

The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    from portbench import run as prun, trace
    from portbench.reference import arith
    bench = prun.manifest()
    _, cfg, mix = prun.cell_spec(bench, args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    device = torch.device("cuda", 0)
    plan = ([(int(s), None) for s in args.seeds.split(",") if s]
            + [(int(s), arith.tf32_matmul)
               for s in args.control_seeds.split(",") if s])
    for seed, mm in plan:
        t0 = time.perf_counter()
        cell = driver.Cell(cfg, mix, seed, device)
        cell.window(args.seconds, trace.no_span)
        kind = "program" if mm is None else "control"
        line = {"workload": args.workload, "seed": seed, "kind": kind}
        try:
            checks = cell.check(control_mm=mm)
            line.update(correct=all(c["holds"] for c in checks),
                        failed=cell.failed, attempted=cell.attempted,
                        readings={c["name"]: c["value"] for c in checks},
                        notes=cell.notes())
        except ValueError as e:         # a control that gives no number
            line.update(correct=False, readings=None, error=str(e))
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    sys.exit(main())
