"""Each limit separates: the control (the reference in the program's
place, its matrix products in TF32) and each fault a cell can have, planted
under a run that is driven as the benchmark drives it, come out not
correct. At a tiny size on the CPU; ``portbench/control.py`` reads the
control at the cells' own sizes on the card."""

import contextlib

import pytest
import torch

from portbench.drivers import batch_lanes, serving
from portbench.reference import arith

from .test_reference import tiny

NO_SPAN = lambda name: contextlib.nullcontext()  # noqa: E731
CPU = torch.device("cpu")


def lidar_run(seed=5, control_mm=None):
    cfg, mix = tiny("lidar20.wide50")
    run = batch_lanes.Cell(cfg, mix, seed, CPU)
    run.window(0.0, NO_SPAN)
    return run.check(control_mm), run


def serving_run(seed=6, control_mm=None):
    cfg, mix = tiny("serve50k.known")
    run = serving.Cell(cfg, mix, seed, CPU)
    run.window(0.0, NO_SPAN)
    return run.check(control_mm), run


def correct(held, run):
    return all(c["holds"] for c in held) and run.failed == 0


def test_the_lidar_control_is_not_correct():
    assert correct(*lidar_run())
    assert not correct(*lidar_run(control_mm=arith.tf32_matmul))


def test_the_serving_control_is_not_correct():
    """At the map's own size (N = 50,000, landmarks up to 320 m away) for one
    session of 150 ticks, reference against reference: TF32 in the
    program's place fails (at a tiny map it would not: the cell's float32
    conditioning comes from its size)."""
    import math
    from portbench import checks, run as prun, traffic
    from portbench.reference import serving as ref
    _, cfg, mix = prun.cell_spec(prun.manifest(), "serve50k.known")
    N, T, seed = cfg["landmarks"], 150, 12
    ids = traffic.serving_schedule(mix, seed, 0, T, N)
    w = 2 * math.pi / mix["loop_ticks"]
    zs = traffic.measure(traffic.landmark_grid(N, mix["spacing_m"]), w,
                         mix["speed_mps"], ids,
                         [math.sqrt(r) for r in cfg["filter"]["r_diag"]],
                         seed, 0)
    run = {"twist": torch.tensor([w, mix["speed_mps"], 0.0]),
           "sessions": [{"zs": zs, "ids": ids}],
           "row_ids": torch.tensor([0, 5, 77, 598, 4000, 30000])}
    control = ref.control(cfg, run, arith.tf32_matmul)
    held = checks.held(ref.judge(cfg, control), cfg["limits"])
    assert not all(c["holds"] for c in held)


def _filter_unchanged(monkeypatch):
    from shermbot_navigation_tpu_torch.models import ekf_batch
    monkeypatch.setattr(ekf_batch, "step", lambda cfg, st, *a, **k: st)


def _fit_altered(monkeypatch):
    from shermbot_navigation_tpu_torch.ops.kernels import circle_fit as cfk
    real = cfk.fit_tail

    def fit_tail(*a, **k):
        center, radius, ok = real(*a, **k)
        return center + 1e-3, radius, ok
    monkeypatch.setattr(cfk, "fit_tail", fit_tail)


def _half_the_worlds(monkeypatch):
    from shermbot_navigation_tpu_torch.pipeline import driver
    from shermbot_navigation_tpu_torch.sim import tube_world as tw
    real = driver.run_scenario_batch_lanes

    def run(scn, noise, batch, **k):
        h = batch // 2
        hook = k.pop("on_tick", None)
        half = tw.TickNoise(*(f[:, :h] for f in noise))

        def twice(t, obs, zs, valid):
            obs = obs._replace(scan=torch.cat([obs.scan] * 2)[:batch])
            hook(t, obs, torch.cat([zs] * 2)[:batch],
                 torch.cat([valid] * 2)[:batch])
        outs = real(scn, half, h, on_tick=twice if hook else None, **k)
        return type(outs)(*(torch.cat([f] * 2)[:batch] for f in outs))
    monkeypatch.setattr(driver, "run_scenario_batch_lanes", run)


@pytest.mark.parametrize("fault", [_filter_unchanged, _fit_altered,
                                   _half_the_worlds])
def test_a_lidar_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(*lidar_run())


def _tick_unchanged(monkeypatch):
    from shermbot_navigation_tpu_torch.pipeline.serving import ServingEngine
    monkeypatch.setattr(ServingEngine, "tick", lambda self, *a, **k:
                        self.state)


def _pose_altered(monkeypatch):
    from shermbot_navigation_tpu_torch.pipeline.serving import ServingEngine
    real = ServingEngine.tick

    def tick(self, *a, **k):
        st = real(self, *a, **k)
        st.mean_r[0, 1] += 1e-2
        return st
    monkeypatch.setattr(ServingEngine, "tick", tick)


def _grid_pass_skipped(monkeypatch):
    from shermbot_navigation_tpu_torch.ops.kernels import grid_update
    monkeypatch.setattr(grid_update, "fused_grid_update",
                        lambda cov, *a, **k: cov)


@pytest.mark.parametrize("fault", [_tick_unchanged, _pose_altered,
                                   _grid_pass_skipped])
def test_a_serving_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not correct(*serving_run())
