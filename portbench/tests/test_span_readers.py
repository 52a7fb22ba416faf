"""The readers of the program's own spans and counters
(``portbench/metrics/*``, through ``portbench/spans.py``): each on
synthetic records, those listed in the benchmark in the cells they name, a
program that records nothing, and on the card the grid pass's span against
the profiler's kernel time."""

from types import SimpleNamespace

import pytest
import torch

from portbench import counts, run as prun
from shermbot_navigation_tpu_torch.utils import tracing

# each reader and the cells in which it finds something to read
CELLS = {"host_to_grid_ms.serve": ["serve50k.known"],
         "grid_update_roofline.span": ["serve50k.known"],
         "sim_ms.eval": ["lidar20.wide50"],
         "perception_ms.eval": ["lidar20.wide50"],
         "filter_ms.eval": ["lidar20.wide50"],
         "circle_fit_roofline.span": ["lidar20.wide50"],
         "kernel_load_s": ["serve50k.known", "lidar20.wide50"]}
# the readers that BENCHMARK.json lists, each on the cells it names; the
# span twins of the rooflines and the serving tick's host time wait
# (PERF.md, Open questions)
LISTED_IN_BENCHMARK = ("sim_ms.eval", "perception_ms.eval", "filter_ms.eval",
                       "kernel_load_s")


def rec(name, id, parent=None, start_ms=0.0, end_ms=0.0, device_ms=None):
    return SimpleNamespace(name=name, id=id, parent=parent,
                           start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6), device_ms=device_ms)


# three serving ticks: the grid pass's launch returns 2, 3 and 5 ms after
# each tick starts; it runs 30, 31 and 40 ms on the card
SERVING = [rec("blocked.grid_pass", 1, 0, 1.0, 2.0, 30.0),
           rec("serving.tick", 0, None, 0.0, 2.5),
           rec("blocked.grid_pass", 3, 2, 12.0, 13.0, 31.0),
           rec("serving.tick", 2, None, 10.0, 13.5),
           rec("blocked.grid_pass", 5, 4, 24.0, 25.0, 40.0),
           rec("serving.tick", 4, None, 20.0, 25.5)]
# two batch ticks
BATCH = [rec("tick.sim", 0, device_ms=10.0),
         rec("perception.circle_fit", 2, 1, device_ms=0.5),
         rec("tick.perception", 1, device_ms=100.0),
         rec("tick.filter", 3, device_ms=200.0),
         rec("tick.sim", 4, device_ms=12.0),
         rec("perception.circle_fit", 6, 5, device_ms=0.7),
         rec("tick.perception", 5, device_ms=110.0),
         rec("tick.filter", 7, device_ms=220.0)]
RUN = SimpleNamespace(N=50_000, M=8, B=65536, ticks=2, live_share=0.25,
                      attempted=3, scn=SimpleNamespace(max_clusters=16))


def expected(metric):
    if metric == "host_to_grid_ms.serve":
        return 3.0
    if metric == "grid_update_roofline.span":
        least = counts.least_seconds(*counts.grid_update_work(50_000, 50_000,
                                                              8))
        return 100.0 * least / 31e-3
    if metric == "circle_fit_roofline.span":
        slots = 65536 * 16
        least = counts.least_seconds(*counts.circle_fit_tail_work(
            slots, 0.25 * slots))
        return 100.0 * least / 0.6e-3
    if metric == "kernel_load_s":
        return 0.75
    return {"sim_ms.eval": 11.0, "perception_ms.eval": 105.0,
            "filter_ms.eval": 210.0}[metric]


@pytest.fixture
def recorded(monkeypatch):
    """The program's recorder, made to hand out the given records."""
    def give(records, counters):
        monkeypatch.setattr(tracing, "spans", lambda: list(records))
        monkeypatch.setattr(tracing, "counters", lambda: dict(counters))
    return give


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_each_reader_on_synthetic_records(metric, recorded):
    recorded(SERVING + BATCH, {"kernels.load_s": 0.75})
    got = prun.reader(metric)(None, RUN)
    assert got == pytest.approx(expected(metric), rel=1e-12)


def test_the_listed_readers_name_their_cells():
    """The readers of the program's spans and counters that are metrics of
    the benchmark each carry a ``workloads`` list: the cells in which they
    find something to read, where ``run.per_layer`` fails a metric that
    reads nothing."""
    got = {m["name"]: m for m in prun.manifest()["per_layer"]
           if m["name"] in CELLS}
    assert sorted(got) == sorted(LISTED_IN_BENCHMARK)
    for name, m in got.items():
        assert sorted(m["workloads"]) == sorted(CELLS[name])
        assert m["source"] == ("program_counter" if name == "kernel_load_s"
                               else "program_span")


@pytest.mark.parametrize("cell", CELLS["kernel_load_s"])
def test_a_program_without_the_recorder_fails_a_traced_run(cell,
                                                           monkeypatch):
    """The benchmark laid over a program without its recorder: in every
    cell a listed reader of the program's spans and counters finds nothing,
    and the traced run fails (exit 5) rather than leave the metric out."""
    monkeypatch.delattr(tracing, "spans")
    monkeypatch.delattr(tracing, "counters")
    bench = prun.manifest()
    mine = [m for m in bench["per_layer"] if m["name"] in CELLS]
    with pytest.raises(LookupError):
        prun.per_layer(dict(bench, per_layer=mine), cell, None, RUN)


@pytest.mark.parametrize("cell", CELLS["kernel_load_s"])
def test_the_listed_readers_are_reported_in_their_cells(cell, recorded):
    recorded(SERVING + BATCH, {"kernels.load_s": 0.75})
    bench = prun.manifest()
    mine = [m for m in bench["per_layer"] if m["name"] in CELLS]
    got = prun.per_layer(dict(bench, per_layer=mine), cell, None, RUN)
    want = {m: expected(m) for m in LISTED_IN_BENCHMARK
            if cell in CELLS[m]}
    assert {k: v["value"] for k, v in got.items()} == pytest.approx(want)
    assert got["kernel_load_s"]["unit"] == "s"


@pytest.mark.parametrize("metric", sorted(CELLS))
def test_a_program_without_the_recorder_reads_nothing(metric, monkeypatch):
    """A program older than its recorder (no ``spans``, no ``counters``):
    each reader returns None and raises nothing itself."""
    monkeypatch.delattr(tracing, "spans")
    monkeypatch.delattr(tracing, "counters")
    assert prun.reader(metric)(None, RUN) is None


@pytest.mark.requires_cuda
def test_the_grid_pass_span_times_the_kernel():
    """Four serving ticks at N=2048 under the profiler, each on a card left
    idle by the last tick's readback, as in the serving cell: each tick's
    ``blocked.grid_pass`` device time holds the grid_update kernel's, and
    exceeds it by no more than the span's host time plus 10 us. On an idle
    card the span's first event runs as soon as it is queued, so its
    device time also holds the host's time in the span before the launch:
    at N=2048 that is ~56 us on a ~62-us kernel (an H100), so the span
    twin of ``grid_update_roofline`` reads about half of it at small N
    (PERF.md, Open questions G)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.pipeline.serving import ServingEngine
    dev = torch.device("cuda", 0)
    eng = ServingEngine(EKFConfig(num_landmarks=2048), 8,
                        torch.eye(3) * 1e-4, torch.eye(2) * 1e-3, device=dev)
    twist = torch.tensor([0.02, 0.1, 0.0], device=dev)
    zs = torch.tensor([[1.0 + 0.1 * i, 0.3 - 0.2 * i] for i in range(8)],
                      device=dev)
    ids = torch.arange(8 * 7, device=dev).reshape(7, 8)

    def tick(t):
        eng.tick(twist, zs, ids=ids[t])
        eng.state.mean_r.cpu()               # the readback drains the card

    for t in range(3):
        tick(t)
    assert tracing.counters()["kernels.load_s"] > 0
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for t in range(3, 7):
            tick(t)
        torch.cuda.synchronize()
    grid = [s for s in tracing.spans() if s.name == "blocked.grid_pass"]
    cuda = torch.autograd.DeviceType.CUDA
    kernel_ms = [e.duration_ns() / 1e6
                 for e in sorted(p.profiler.kineto_results.events(),
                                 key=lambda e: e.start_ns())
                 if e.device_type() == cuda and "grid_update" in e.name()]
    assert len(grid) == len(kernel_ms) == 4
    for s, k in zip(grid, kernel_ms):
        host_ms = (s.end_ns - s.start_ns) / 1e6
        assert k <= s.device_ms <= k + host_ms + 0.010, (s.device_ms, k,
                                                         host_ms)
    tracing.clear()
