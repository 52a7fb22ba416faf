"""The port's span recorder (``utils/tracing``) on the CPU: off without a
profiler, the spans the serving and batch ticks record under one, their
nesting in the recorder and in the profiler's own events, outputs that do
not depend on recording, and the bound on what is kept."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.pipeline import driver
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.pipeline.serving import ServingEngine
from shermbot_navigation_tpu_torch.utils import tracing

TICK = ("tick.sim", "tick.perception", "tick.filter")


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.clear()
    yield
    tracing.clear()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def serve(ticks=2):
    """A CPU serving engine at N=64, M=8, ``ticks`` known-association
    ticks of 4 measurements; returns the engine."""
    eng = ServingEngine(EKFConfig(num_landmarks=64), 8, torch.eye(3) * 1e-4,
                        torch.eye(2) * 1e-3, device="cpu")
    for t in range(ticks):
        zs = torch.tensor([[1.0 + 0.1 * i, 0.3 - 0.2 * i] for i in range(4)])
        eng.tick(torch.tensor([0.02, 0.1, 0.0]), zs,
                 ids=torch.arange(4) + 4 * t)
    return eng


def lanes(ticks=3):
    g = torch.Generator()
    g.manual_seed(0)
    return driver.run_scenario_batch_lanes(get_scenario("lidar20_full"), g,
                                           batch=2, steps=ticks,
                                           device="cpu")


def test_off_without_a_profiler():
    assert tracing.stage("a") is tracing.stage("b", "cpu")
    serve(1)
    assert tracing.spans() == []


def test_serving_tick_records_the_grid_pass_inside_it():
    with profiled() as p:
        serve(1)
    tick, grid = (next(s for s in tracing.spans() if s.name == n)
                  for n in ("serving.tick", "blocked.grid_pass"))
    assert grid.parent == tick.id and tick.parent is None
    assert tick.start_ns <= grid.start_ns <= grid.end_ns <= tick.end_ns
    assert grid.device_ms is None               # a CPU run: host times only
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in p.profiler.kineto_results.events()
          if e.name() in ("serving.tick", "blocked.grid_pass")}
    assert ev["serving.tick"][0] <= ev["blocked.grid_pass"][0]
    assert ev["blocked.grid_pass"][1] <= ev["serving.tick"][1]


def test_batch_tick_records_its_three_stages_in_order():
    with profiled():
        lanes(3)
    rec = tracing.spans()
    ids = {s.id: s for s in rec}
    stages = sorted((s for s in rec if s.name in TICK),
                    key=lambda s: s.start_ns)
    assert [s.name for s in stages] == list(TICK) * 3
    assert all(s.parent is None for s in stages)
    fits = [s for s in rec if s.name == "perception.circle_fit"]
    fronts = [s for s in rec if s.name == "perception.fit_inputs"]
    assert len(fits) == len(fronts) == 3
    assert all(ids[f.parent].name == "tick.perception"
               for f in fits + fronts)
    assert all(a.parent == f.parent and a.end_ns <= f.start_ns
               for a, f in zip(fronts, fits))


@pytest.mark.parametrize("engine", ["serving", "lanes"])
def test_outputs_do_not_depend_on_recording(engine):
    run = (lambda: serve(3).state) if engine == "serving" else lanes
    off = run()
    with profiled():
        on = run()
    assert tracing.spans()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_the_buffer_keeps_the_newest_spans():
    n = tracing.CAPACITY + 5
    with profiled():
        for i in range(n):
            with tracing.stage(str(i)):
                pass
    rec = tracing.spans()
    assert len(rec) == tracing.CAPACITY
    assert rec[0].name == "5" and rec[-1].name == str(n - 1)


def test_counters_add_and_outlive_clear():
    """Counters are plain adds, always on, and ``clear()`` keeps them: each
    is added once a process, so a cleared one would be lost for good."""
    before = tracing.counters()
    tracing.count("test.load_s", 0.25)
    tracing.count("test.load_s", 0.5)
    with profiled():
        with tracing.stage("a"):
            pass
    tracing.clear()
    assert tracing.spans() == []
    assert tracing.counters() == dict(before, **{
        "test.load_s": before.get("test.load_s", 0) + 0.75})
