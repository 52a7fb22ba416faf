"""Configs 1 and 2 of the port on the CPU: the port's f32 run reproduces
the JAX golden fixtures that ``chip_smoke.py`` holds the card to
(``tests/fixtures/loop5_golden.json``, ``course12_golden.json``, written
by ``tests/fixtures/make_serving_golden.py``), and the port's bench entry
prints ``bench.py``'s keys."""

import base64
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from shermbot_navigation_tpu_torch import bench
from shermbot_navigation_tpu_torch.pipeline import driver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim.tube_world import TickNoise

FIXTURES = Path(__file__).resolve().parent / "fixtures"
T = 60                 # ticks of the reproduction
POSE_TOL = 1e-5


def _golden(name):
    return json.loads((FIXTURES / name).read_text())


def _f32(golden, key, shape):
    return np.frombuffer(base64.b64decode(golden[key]), "<f4").reshape(shape)


def _pose_err(outs, want, every, ticks):
    """Largest |port - fixture| over the fixture's poses in ``ticks``."""
    n = ticks // every
    got = outs[:, every - 1::every][:, :n].double().numpy()
    return float(np.abs(got - np.asarray(want, np.float64)[:, :n]).max())


def test_port_reproduces_the_loop5_fixture():
    g = _golden("loop5_golden.json")
    assert g["scenario"] == "loop5_known" and g["T"] == 600
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    outs = driver.run_scenario_batch_lanes(
        get_scenario("loop5_known"), gen, g["B"], steps=T, device="cpu")
    np.testing.assert_array_equal(outs.n_seen.numpy(),
                                  np.asarray(g["n_seen"])[:, :T])
    for f in ("true_pose", "odom_pose", "slam_pose"):
        assert _pose_err(getattr(outs, f), g[f], g["pose_every"], T) \
            <= POSE_TOL, f
    # noise-free: every world is the same to rounding, ATE 0.05199 m
    assert np.ptp(g["ate"]) < 1e-8
    assert abs(g["ate"][0] - 0.05199) < 1e-5


def test_port_reproduces_the_course12_fixture():
    g = _golden("course12_golden.json")
    assert g["scenario"] == "course12_noisy" and g["B"] == 8
    shape = g["normals_shape"]                     # (T, 7, S, 2)
    B, S = g["B"], shape[2]
    z = lambda *s: torch.zeros((T, B, *s))
    twist, slip = z(S, 2), z(S, 2)                 # world 7: every draw 0
    twist[:, :-1] = torch.from_numpy(
        _f32(g, "twist_normals_f32_b64", shape)[:T].copy())
    slip[:, :-1] = torch.from_numpy(
        _f32(g, "slip_normals_f32_b64", shape)[:T].copy())
    scn = get_scenario("course12_noisy")
    # the scan normals and keep uniforms are unused (no lidar, no dropout)
    noise = TickNoise(twist=twist, slip=slip, scan=z(360),
                      marker_keep=z(len(scn.tubes)), scan_keep=z(360))
    outs = driver.run_scenario_batch_lanes(scn, noise, B, steps=T,
                                           device="cpu")
    np.testing.assert_array_equal(outs.n_seen.numpy(),
                                  np.asarray(g["n_seen"])[:, :T])
    for f in ("true_pose", "odom_pose", "slam_pose"):
        want = _f32(g, f"{f}_f32_b64", g["pose_shape"])[:, :T]
        err = float(np.abs(getattr(outs, f).double().numpy() - want).max())
        assert err <= POSE_TOL, (f, err)
    assert len(g["ate"]) == B and all(np.isfinite(g["ate"]))


def test_bench_entry_prints_the_bench_keys(capsys):
    """The port's bench entry on the CPU at a tiny size, both engines."""
    keys = {"metric", "value", "unit", "vs_baseline",
            "baseline_ticks_per_sec", "baseline_spread", "batch",
            "scenario", "engine", "ate_m", "cpp_ate_m",
            "seconds_per_batch_run", "device", "execution"}
    for engine in ("lanes", "vmapped"):
        assert bench.main(["--device", "cpu", "--batch", "3", "--steps", "4",
                           "--cpp-runs", "1", "--engine", engine]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        r = json.loads(lines[0])
        assert set(r) == keys
        assert r["metric"] == "slam_pipeline_ticks_per_sec_per_chip"
        assert (r["engine"], r["batch"], r["scenario"], r["device"],
                r["execution"]) == (engine, 3, "loop5_known", "cpu", "eager")
        assert r["value"] > 0 and r["baseline_ticks_per_sec"] > 0
        assert abs(r["cpp_ate_m"] - 0.051976) < 1e-6
        assert np.isfinite(r["ate_m"])


@pytest.mark.parametrize("scenario", ["course12_tuned", "lidar20_tuned"])
def test_bench_entry_prints_the_tuned_rows(capsys, scenario):
    """The quality modes on the bench entry (CPU, tiny size): no C++ run
    (the reference cannot express nearest-neighbour gates), so its fields
    are null, and the row adds the diverged fraction and the median NEES
    beside the median-world ATE."""
    assert bench.main(["--device", "cpu", "--batch", "2", "--steps", "3",
                       "--scenario", scenario]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == {"metric", "value", "unit", "vs_baseline",
                      "baseline_ticks_per_sec", "baseline_spread", "batch",
                      "scenario", "engine", "ate_m", "cpp_ate_m",
                      "seconds_per_batch_run", "device", "execution",
                      "diverged_fraction", "median_nees"}
    assert (r["scenario"], r["batch"], r["engine"]) == (scenario, 2, "lanes")
    assert all(r[k] is None for k in ("vs_baseline", "baseline_ticks_per_sec",
                                      "baseline_spread", "cpp_ate_m"))
    assert r["value"] > 0 and r["diverged_fraction"] == 0.0
    assert np.isfinite(r["ate_m"]) and np.isfinite(r["median_nees"])
