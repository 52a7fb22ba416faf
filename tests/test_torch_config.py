"""The port's configuration (``pipeline/config``) against the JAX
package's, field by field; the rules of the package: it imports no JAX,
and every entry point runs on the card unless the caller asks for the
CPU."""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.pipeline import config as jconfig
from shermbot_navigation_tpu_torch.pipeline import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


def test_registry_has_the_same_scenarios():
    assert sorted(tconfig.SCENARIOS) == sorted(jconfig.SCENARIOS)


@pytest.mark.parametrize("name", sorted(jconfig.SCENARIOS))
def test_scenario_equal_field_by_field(name):
    j, t = jconfig.get_scenario(name), tconfig.get_scenario(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.world_config()) == dataclasses.asdict(
        j.world_config())
    assert dataclasses.asdict(t.ekf_config()) == {
        **dataclasses.asdict(j.ekf_config())}
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jp, tp = j.world_params(jdt), t.world_params(tdt, "cpu")
        for k in jp._fields:
            assert getattr(tp, k).dtype == tdt
            np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                          np.asarray(getattr(jp, k)), k)
        for a, b in zip(t.noise_matrices(tdt, "cpu"), j.noise_matrices(jdt)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_constants_and_layout_helpers():
    for k in ("WHEEL_BASE", "WHEEL_RADIUS", "TUBE_RADIUS", "ROBOT_RADIUS",
              "SIM_HZ", "SLAM_HZ", "ODOM_HZ", "Q_DIAG", "R_DIAG", "SCAN_MIN",
              "SCAN_MAX", "STOCK_TUBES"):
        assert getattr(tconfig, k) == getattr(jconfig, k), k
    assert tconfig._ring(7, 0.6) == jconfig._ring(7, 0.6)
    assert tconfig._grid(10, 0.5) == jconfig._grid(10, 0.5)


def test_get_scenario_unknown_and_yaml(tmp_path):
    with pytest.raises(KeyError, match="unknown scenario"):
        tconfig.get_scenario("nope")
    pytest.importorskip("yaml")
    good = tmp_path / "s.yaml"
    good.write_text("name: mine\nnum_landmarks: 3\ntubes: [[0.1, 0.2]]\n"
                    "command: [circle, 0.1, 0.2]\n")
    assert dataclasses.asdict(tconfig.from_yaml(str(good))) == \
        dataclasses.asdict(jconfig.from_yaml(str(good)))
    bad = tmp_path / "b.yaml"
    bad.write_text("name: mine\nnot_a_key: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        tconfig.from_yaml(str(bad))


def test_port_imports_no_jax():
    """No module of the port, and not ``chip_smoke.py``, imports ``jax`` or
    anything of the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|shermbot_navigation_tpu)\b"
                     r"(?!_torch)", re.M)
    files = sorted((ROOT / "shermbot_navigation_tpu_torch").rglob("*.py"))
    assert len(files) > 20
    for f in files + [ROOT / "chip_smoke.py"]:
        hit = pat.search(f.read_text())
        assert hit is None, f"{f}: {hit.group(0)!r}"


ENTRY_POINTS = {
    "device.resolve": lambda d: __import__(
        "shermbot_navigation_tpu_torch.device", fromlist=["x"]).resolve(d),
    "config.world_params": lambda d: tconfig.get_scenario(
        "stock6").world_params(device=d),
    "config.noise_matrices": lambda d: tconfig.get_scenario(
        "stock6").noise_matrices(device=d),
    "tube_world.default_params": lambda d: __import__(
        "shermbot_navigation_tpu_torch.sim.tube_world",
        fromlist=["x"]).default_params(device=d),
    "diff_drive.init_state": lambda d: __import__(
        "shermbot_navigation_tpu_torch.ops.diff_drive",
        fromlist=["x"]).init_state(device=d),
    "se2.identity": lambda d: __import__(
        "shermbot_navigation_tpu_torch.ops.se2",
        fromlist=["x"]).identity(device=d),
    "ekf_batch.init": lambda d: __import__(
        "shermbot_navigation_tpu_torch.models.ekf_batch",
        fromlist=["x"]).init(tconfig.get_scenario("stock6").ekf_config(), 2,
                             device=d),
    "driver.init_pipeline": lambda d: __import__(
        "shermbot_navigation_tpu_torch.pipeline.driver",
        fromlist=["x"]).init_pipeline(tconfig.get_scenario("stock6"),
                                      device=d),
    "driver.command_twist": lambda d: __import__(
        "shermbot_navigation_tpu_torch.pipeline.driver",
        fromlist=["x"]).command_twist(tconfig.get_scenario("stock6"), 3,
                                      device=d),
    "driver.run_scenario": lambda d: __import__(
        "shermbot_navigation_tpu_torch.pipeline.driver",
        fromlist=["x"]).run_scenario(
            tconfig.get_scenario("stock6"), torch.Generator(), device=d,
            steps=1),
    "driver.run_scenario_batch_lanes": lambda d: __import__(
        "shermbot_navigation_tpu_torch.pipeline.driver",
        fromlist=["x"]).run_scenario_batch_lanes(
            tconfig.get_scenario("stock6"), torch.Generator(), 2, steps=1,
            device=d),
    "convert.batch_state_from_numpy": lambda d: __import__(
        "shermbot_navigation_tpu_torch.utils.convert",
        fromlist=["x"]).clusters_from_numpy(
            dict(points=np.zeros((1, 4, 2)), counts=np.zeros(1, np.int32),
                 valid=np.zeros(1, bool)), d),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_new_entry_points_default_to_the_card(name):
    """Without a device an entry point runs on the card, and raises where
    there is none, naming ``device="cpu"``; asked for the CPU it runs."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](None)
    ENTRY_POINTS[name]("cpu")
