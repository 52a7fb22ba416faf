"""The port against the plain references at a tiny size on the CPU, through
both drivers as a run drives them; and a run without a card prints no
result."""

import contextlib
import subprocess
import sys

import pytest
import torch

from portbench import run as prun
from portbench.drivers import batch_lanes, serving

NO_SPAN = lambda name: contextlib.nullcontext()  # noqa: E731
CPU = torch.device("cpu")


def tiny(cell: str):
    _, cfg, mix = prun.cell_spec(prun.manifest(), cell)
    if cfg["driver"] == "batch_lanes":
        return cfg, dict(mix, batch=6, episode_ticks=8, warmup_ticks=1,
                         checked_worlds=4)
    return (dict(cfg, landmarks=256),
            dict(mix, warmup_ticks=6, checked_rows_seen=4,
                 checked_rows_unseen=2, session_ticks=5))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_batch_lanes_matches_the_reference(seed):
    cfg, mix = tiny("lidar20.wide50")
    run = batch_lanes.Cell(cfg, mix, seed, CPU)
    run.window(0.0, NO_SPAN)
    assert run.attempted == 6 and run.failed == 0
    held = run.check()
    assert all(c["holds"] for c in held), held
    assert 0 < run.live_share <= 1


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
def test_serving_matches_the_reference(seed):
    cfg, mix = tiny("serve50k.known")
    run = serving.Cell(cfg, mix, seed, CPU)
    run.window(0.0, NO_SPAN)
    assert run.attempted == 1 and run.failed == 0
    e2e = run.end_to_end()
    assert e2e["tick_ms"] > 0 and e2e["tick_ms_p95"] > 0
    held = run.check()
    assert all(c["holds"] for c in held), held


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(prun.HERE / "run.py"),
                        "--workload", "lidar20.wide50", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=prun.ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_only_the_benchmark_is_no_run(tmp_path):
    """A directory with BENCHMARK.json and portbench/ alone has no program:
    the run fails and prints nothing."""
    import shutil
    shutil.copytree(prun.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(prun.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "serve50k.known", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", ["lidar20.wide50", "serve50k.known"])
def test_a_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "11", "--seconds", "2", "--trace",
                        "1"], capture_output=True, text=True, cwd=prun.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    assert json.loads(p.stdout.splitlines()[-1])["correct"]
