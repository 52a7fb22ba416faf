"""The traced window: ``torch.profiler`` over the whole measured window,
reduced to what the per-layer readers need (device busy time as the union
of kernel, copy and fill intervals; device time by kernel name; the CUDA
runtime's launch calls; the idle gaps labelled by the harness's own spans).
"""

from __future__ import annotations

import contextlib
import time

import torch

# the CUDA runtime and driver calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel",
                "cuLaunchKernelEx")
SPAN_PREFIX = "portbench."


def span(name: str):
    """A span of the harness around a call into the program; shows in the
    traced run's timeline, costs nothing untraced."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def no_span(name: str):
    return contextlib.nullcontext()


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Summary:
    """What a traced window holds: ``window_s`` (host wall time), ``busy_s``
    (device), ``device_s`` {kernel name: seconds}, ``device_events``,
    ``launches`` and ``gaps`` [(label, seconds)], the longest first."""

    def __init__(self, events, t0_ns: int, t1_ns: int, window_s: float):
        dev, spans = [], []
        device_s: dict[str, float] = {}
        launches = 0
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            name = e.name()
            if name.startswith(SPAN_PREFIX):
                # the harness's spans: host ranges (their mirror on the
                # device's timeline is no device work)
                if e.device_type() != cuda:
                    a = e.start_ns()
                    spans.append((a, a + e.duration_ns(),
                                  name[len(SPAN_PREFIX):]))
            elif e.device_type() == cuda:
                a = e.start_ns()
                b = a + e.duration_ns()
                dev.append((a, b))
                device_s[name] = device_s.get(name, 0.0) + (b - a) / 1e9
            elif name.startswith(LAUNCH_CALLS):
                launches += 1
        merged = _merge(dev)
        self.window_s = window_s
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        self.device_s = device_s
        self.device_events = len(dev)
        self.launches = launches
        edges = [t0_ns] + [x for ab in merged for x in ab] + [t1_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        self.gaps = [(self._label(spans, (a + b) // 2), (b - a) / 1e9)
                     for a, b in gaps[:10]]

    @staticmethod
    def _label(spans, t):
        best = None
        for a, b, name in spans:
            if a <= t <= b and (best is None or b - a < best[1] - best[0]):
                best = (a, b, name)
        return best[2] if best else "host"

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds ``pattern``."""
        return sum(s for k, s in self.device_s.items() if pattern in k)

    def breakdown(self) -> dict:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], s] for k, s in top],
                "idle_gaps": [[k, s] for k, s in self.gaps]}


class Traced:
    """A profiler over the block; :attr:`summary` after it closes."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self._t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        t1_ns = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self._prof.profiler.kineto_results.events()
        # the profiler's clock and the host's wall clock share no origin:
        # place the window by the events' own span
        starts = [e.start_ns() for e in events]
        ends = [e.start_ns() + e.duration_ns() for e in events]
        t0 = min(starts) if starts else self._t0_ns
        t1 = max(ends) if ends else t1_ns
        self.summary = Summary(events, t0, t1, window_s)
        return False
