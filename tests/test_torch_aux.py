"""The port's auxiliary modules against the JAX package's, on the CPU:
the robot description (``utils/robot``), the fake turtle and the
rectangle controller (``sim/fake_turtle``, ``sim/turtle_rect``), tracing
(``utils/tracing``), the replay artifacts (``pipeline/viz``) and the CLI
(``pipeline/cli``: ``frames``, ``run`` on both engines, ``bench``).

Tolerances: the closed-loop rectangle run in f64 agrees with JAX to
1e-12 at every one of 3000 steps (a pure function of the pose, the same
operations in the same order, one rounding each); ``frames`` prints the
JAX CLI's characters (f32, as the JAX CLI computes them when run as a
program); ``run`` on ``loop5_known`` in f64 agrees with the JAX CLI's
JSON to 1e-9 (this scenario scales every draw by zero, so the two
packages' generators do not enter; the run is held to JAX's on replayed
noise by ``tests/test_torch_driver.py``); the native engine's line is
the same C++ run on both sides, equal exactly.
"""

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.pipeline import cli as jcli
from shermbot_navigation_tpu.sim import fake_turtle as jft
from shermbot_navigation_tpu.sim import turtle_rect as jrect
from shermbot_navigation_tpu.utils.robot import TURTLEBOT3_BURGER as JBURGER
from shermbot_navigation_tpu_torch.pipeline import cli as tcli
from shermbot_navigation_tpu_torch.pipeline import viz
from shermbot_navigation_tpu_torch.pipeline.driver import TickOutput
from shermbot_navigation_tpu_torch.sim import fake_turtle as tft
from shermbot_navigation_tpu_torch.sim import turtle_rect as trect
from shermbot_navigation_tpu_torch.utils import robot as trobot
from shermbot_navigation_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
FRAMES_INPUT = "90 0 1\n90 1 0\n1 1\na\n1 1 1\na\n"   # tests/test_cli.py


def test_robot_description_equals_jax():
    import dataclasses
    assert dataclasses.asdict(trobot.TURTLEBOT3_BURGER) == \
        dataclasses.asdict(JBURGER)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.float64, torch.float64)):
        jp = JBURGER.diff_drive_params(jdt)
        tp = trobot.TURTLEBOT3_BURGER.diff_drive_params(tdt, "cpu")
        for k in jp._fields:
            assert getattr(tp, k).dtype == tdt
            assert getattr(tp, k).numpy() == np.asarray(getattr(jp, k)), k


def test_rectangle_run_matches_jax_and_visits_the_corners():
    """Closed loop over 3000 steps of 0.02 s in f64: the controller drives
    the fake turtle round the rectangle; state, command and pose equal
    JAX's within 1e-12 at every step, every corner is visited within 0.08
    m, and the machine ends IDLE (``tests/test_aux.py``)."""
    vals = dict(x=0.0, y=0.0, width=0.5, height=0.3, max_xdot=0.2,
                max_wdot=1.0)
    jrp = jrect.RectParams(**{k: jnp.asarray(v, jnp.float64)
                              for k, v in vals.items()})
    trp = trect.RectParams(**{k: torch.tensor(v, dtype=torch.float64)
                              for k, v in vals.items()})
    jp = JBURGER.diff_drive_params(jnp.float64)
    tp = trobot.TURTLEBOT3_BURGER.diff_drive_params(torch.float64, "cpu")
    jctrl, jcorners = jrect.start(jrp)
    tctrl, tcorners = trect.start(trp)
    np.testing.assert_array_equal(tcorners.numpy(), np.asarray(jcorners))
    jst, tst = jft.init_state(jnp.float64), tft.init_state(torch.float64,
                                                            "cpu")
    dt = 0.02

    @jax.jit
    def jstep(ctrl, ft):
        ctrl, cmd = jrect.controller_step(jrp, ctrl, ft.drive.pose)
        ft, wheels = jft.step(jp, ft, cmd, dt)
        return ctrl, ft, cmd, wheels

    traj, fsms = [], []
    for _ in range(3000):
        jctrl, jst, jcmd, jw = jstep(jctrl, jst)
        tctrl, tcmd = trect.controller_step(trp, tctrl, tst.drive.pose)
        tst, tw = tft.step(tp, tst, tcmd, dt)
        assert int(tctrl.fsm) == int(jctrl.fsm)
        assert int(tctrl.prev) == int(jctrl.prev)
        np.testing.assert_allclose(tcmd.numpy(), np.asarray(jcmd), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tst.drive.pose.numpy(),
                                   np.asarray(jst.drive.pose), rtol=0,
                                   atol=1e-12)
        traj.append(tst.drive.pose[1:].numpy())
        fsms.append(int(tctrl.fsm))
    traj = np.stack(traj)
    for c in tcorners.numpy():
        assert np.min(np.linalg.norm(traj - c, axis=1)) < 0.08, c
    assert int(tctrl.fsm) == trect.IDLE
    assert trect.ROTATE in fsms and trect.LEFT in fsms
    assert tctrl.fsm.dtype == torch.int32


def test_trace_exports_program_spans(tmp_path):
    """Under ``trace``, a span of the program is written to the exported
    trace and is also among the recorded spans."""
    tracing.clear()
    with tracing.trace(str(tmp_path / "prof")):
        with tracing.stage("aux.filter"):
            torch.ones(4) * 2 + 1
    text = (tmp_path / "prof" / "trace.json").read_text()
    events = json.loads(text)["traceEvents"]
    assert any(e.get("name") == "aux.filter" for e in events)
    assert [s.name for s in tracing.spans()] == ["aux.filter"]
    tracing.clear()


def test_plot_and_csv_write_what_jax_writes(tmp_path):
    """The same TickOutput values through both packages' viz: the CSV
    files are equal byte for byte; the figures are written."""
    from shermbot_navigation_tpu.pipeline import viz as jviz
    from shermbot_navigation_tpu.pipeline.driver import TickOutput as JOut
    rng = np.random.default_rng(0)
    T = 10
    arrays = dict(true_pose=rng.normal(size=(T, 3)),
                  odom_pose=rng.normal(size=(T, 3)),
                  slam_pose=rng.normal(size=(T, 3)),
                  n_seen=np.arange(T, dtype=np.int32), nees=np.ones(T))
    touts = TickOutput(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jouts = JOut(**{k: jnp.asarray(v) for k, v in arrays.items()})
    png = str(tmp_path / "run.png")
    viz.plot_run(png, touts, tube_locs=torch.tensor([[0.5, 0.5]]),
                 est_landmarks=[[0.4, 0.4]])
    assert os.path.getsize(png) > 1000
    viz.write_trajectory_csv(str(tmp_path / "t.csv"), touts)
    jviz.write_trajectory_csv(str(tmp_path / "j.csv"), jouts)
    t_csv = (tmp_path / "t.csv").read_text()
    assert t_csv == (tmp_path / "j.csv").read_text()
    assert len(t_csv.splitlines()) == T + 1


def test_scan_figure(tmp_path):
    png = str(tmp_path / "scan.png")
    scan = torch.full((360,), 2.0)
    scan[10:20] = 0.5
    viz.scan_figure(png, scan, detections=torch.tensor([[0.5, 0.1]]),
                    valid=torch.tensor([True]))
    assert os.path.getsize(png) > 1000


def _port_frames(monkeypatch, capsys, text):
    monkeypatch.setattr("sys.stdin", io.StringIO(text))
    tcli.main(["frames"])
    return capsys.readouterr().out


def test_frames_prints_the_jax_cli_characters(monkeypatch, capsys):
    """``frames`` on ``tests/test_cli.py``'s input prints exactly what the
    JAX CLI prints when run as a program (its default f32)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    want = subprocess.run(
        [sys.executable, "-m", "shermbot_navigation_tpu.pipeline.cli",
         "frames"], input=FRAMES_INPUT, capture_output=True, text=True,
        cwd=ROOT, env=env, check=True, timeout=300).stdout
    assert _port_frames(monkeypatch, capsys, FRAMES_INPUT) == want


def test_frames_hand_derived_values(monkeypatch, capsys):
    """The hand-derived values of ``tests/test_cli.py``: T_ab = (90, 0,
    1), T_bc = (90, 1, 0); v = (1, 1) and V = (1, 1, 1) in frame a."""
    out = _port_frames(monkeypatch, capsys, FRAMES_INPUT)
    num = r"-?\d+\.?\d*(?:e-?\d+)?"
    got = {line.split(":")[0]: [float(x) for x in re.findall(num, line)]
           for line in out.strip().splitlines()}
    want = {"T_ab": (90, 0, 1), "T_ba": (-90, -1, 0), "T_bc": (90, 1, 0),
            "T_cb": (-90, 0, 1), "T_ac": (180, 0, 2), "T_ca": (180, 0, 2),
            "v_a": (1, 1), "v_b": (0, -1), "v_c": (-1, 1),
            "V_a": (1, 1, 1), "V_b": (1, 1, 0), "V_c": (1, 1, -1)}
    for name, w in want.items():
        g = got[name]
        if name in ("T_ac", "T_ca"):            # +-180 is one rotation
            g = [abs(g[0])] + g[1:]
        np.testing.assert_allclose(g, w, atol=1e-4, err_msg=name)


def _json_line(fn, capsys, argv):
    fn(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_on_the_cpu_matches_the_jax_cli(capsys, tmp_path):
    """``run --device cpu --f64 --scenario loop5_known`` against the JAX
    CLI's ``run --platform cpu --f64``: the same keys, every number within
    1e-9, ``n_seen`` exactly; ``--traj`` writes the JAX CLI's columns."""
    port = _json_line(tcli.main, capsys, [
        "run", "--device", "cpu", "--f64", "--scenario", "loop5_known",
        "--traj", str(tmp_path / "t.csv")])
    ref = _json_line(jcli.main, capsys, [
        "run", "--platform", "cpu", "--f64", "--scenario", "loop5_known",
        "--traj", str(tmp_path / "j.csv")])
    assert port.keys() == ref.keys()
    assert port["n_seen"] == ref["n_seen"] == 5
    assert port["scenario"] == ref["scenario"]
    assert port["steps"] == ref["steps"]
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(port[k] - v) <= 1e-9, (k, port[k], v)
    t_rows = (tmp_path / "t.csv").read_text().splitlines()
    j_rows = (tmp_path / "j.csv").read_text().splitlines()
    assert t_rows[0] == j_rows[0] and len(t_rows) == len(j_rows)


def test_run_native_engine_matches_the_jax_cli(capsys):
    """``--engine native`` is the same C++ run on both sides: equal
    lines; and the same refusals."""
    port = _json_line(tcli.main, capsys, ["run", "--engine", "native",
                                          "--scenario", "loop5_known"])
    ref = _json_line(jcli.main, capsys, ["run", "--engine", "native",
                                         "--scenario", "loop5_known"])
    assert port == ref
    for name in ("course12_tuned", "bigmap2000"):
        with pytest.raises(SystemExit) as e:
            tcli.main(["run", "--engine", "native", "--scenario", name])
        assert "native engine" in str(e.value)


def test_run_without_a_card_names_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.main(["run", "--scenario", "loop5_known"])


def test_bench_subcommand_runs_the_port_bench(capsys):
    """``bench`` hands its arguments to the port's ``bench.main``."""
    tcli.main(["bench", "--device", "cpu", "--batch", "2", "--steps", "2",
               "--cpp-runs", "1"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["batch"] == 2 and row["scenario"] == "loop5_known"


def test_compile_entry_equals_the_eager_tick():
    """``entry.entry()`` (one ``slam_tick`` on ``stock6``, f32) under
    ``torch.compile(backend="aot_eager")`` on the CPU: the traced tick
    gives the eager tick's values, integer fields exactly."""
    from shermbot_navigation_tpu_torch import entry
    fn, args = entry.entry("cpu")
    eager = fn(*args)
    compiled = torch.compile(fn, backend="aot_eager")(*args)
    assert entry.max_difference(compiled, eager) == 0.0
    assert torch.isfinite(eager[1].slam_pose).all()
