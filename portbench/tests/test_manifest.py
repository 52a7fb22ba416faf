"""BENCHMARK.json and every file it names: keys, names, units, and each
cell's files found by name; a mix added by files alone is found."""

import importlib.util
import json
import re
import shutil

import pytest
import torch

from portbench import run as prun
from portbench.drivers import batch_lanes

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return prun.manifest()


def test_top_level_keys(bench):
    assert set(bench) == TOP
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (prun.ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_each_cell_finds_its_files(bench):
    used = set()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell, cfg, mix = prun.cell_spec(bench, w["name"])
        used.add(cell["config"])
        assert importlib.util.find_spec(f"portbench.drivers.{cfg['driver']}")
        assert (prun.ROOT / cfg["reference"]).exists()
        assert cfg["limits"]
        got = {m["name"] for m in prun.metrics_for(bench, "end_to_end",
                                                   w["name"])}
        assert "setup_s" in got and len(got) >= 2
        layer = prun.metrics_for(bench, "per_layer", w["name"])
        assert layer
        for m in layer:
            assert callable(prun.reader(m["name"]))
            assert m["moves"] in got and m["moves"] in e2e
    assert used == {c["name"] for c in bench["configs"]}


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_a_mix_added_by_files_alone(tmp_path, bench):
    """A later change adds a cell with a traffic file and a manifest entry:
    the harness, copied as it is, finds and runs it."""
    shutil.copytree(prun.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mine = json.loads(json.dumps(bench))
    mine["workloads"].append({"name": "lidar20.tiny", "config":
                              "lidar20_full", "traffic": "lidar20.tiny",
                              "chips": 1, "why": "a throwaway mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(mine))
    (tmp_path / "portbench" / "workloads" / "lidar20.tiny.json").write_text(
        json.dumps({"batch": 3, "episode_ticks": 2, "warmup_ticks": 1,
                    "checked_worlds": 2}))
    spec = importlib.util.spec_from_file_location(
        "copied_run", tmp_path / "portbench" / "run.py")
    copied = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(copied)
    cell, cfg, mix = copied.cell_spec(copied.manifest(), "lidar20.tiny")
    assert mix["batch"] == 3 and cell["traffic"] == "lidar20.tiny"
    run = batch_lanes.Cell(cfg, mix, 7, torch.device("cpu"))
    run.window(0.0, lambda name: __import__("contextlib").nullcontext())
    assert run.attempted == 3 and run.ticks == 2
    assert all(c["holds"] for c in run.check())


def test_a_listed_metric_that_reads_nothing_fails(bench):
    """A per-layer reader that finds nothing in a cell the metric lists (a
    kernel renamed under it) makes the run fail, not drop the metric."""
    from types import SimpleNamespace
    cell = next(m for m in bench["per_layer"]
                if "grid_update_roofline" == m["name"])["workloads"][0]
    empty = SimpleNamespace(device_s={"other": 0.5}, busy_s=0.5,
                            window_s=1.0, launches=100,
                            kernel_seconds=lambda pattern: 0.0)
    run = SimpleNamespace(attempted=1, ticks=1, N=64, M=8)
    with pytest.raises(LookupError, match="grid_update_roofline"):
        prun.per_layer(bench, cell, empty, run)
