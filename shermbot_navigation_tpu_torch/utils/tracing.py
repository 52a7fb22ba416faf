"""Tracing, profiling and structured metrics (port of
``shermbot_navigation_tpu.utils.tracing``).

- :func:`trace` -- context manager around ``torch.profiler.profile``
  (CPU and, where the card is, CUDA activity) that writes a Chrome /
  TensorBoard trace into ``logdir``;
- :func:`stage` -- ``torch.profiler.record_function``, so pipeline stages
  (sim / perception / filter) are labeled in profiles;
- :func:`time_fn` -- warm up, then median wall time with the output's
  device synchronized (PyTorch returns before the card finishes);
- :class:`MetricsLog` -- JSONL logger for per-run metrics artifacts.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable

import torch

stage = torch.profiler.record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; the trace is written to
    ``logdir/trace.json`` (Chrome trace format, which TensorBoard's
    profile plugin and ``chrome://tracing`` read)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _first_tensor(out):
    """The first tensor of ``out`` (a tensor, or a nest of tuples, lists
    and dicts), or None."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def _sync(out) -> None:
    """Wait until ``out`` is computed: a synchronize of the card its
    first tensor lies on (the JAX ``_sync`` blocks on the first leaf)."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> dict:
    """Median/best wall time of ``fn(*args)`` with warmup and device
    sync."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return {
        "best_s": times[0],
        "median_s": times[len(times) // 2],
        "mean_s": sum(times) / len(times),
        "iters": iters,
    }


class MetricsLog:
    """Append-only JSONL metrics artifact: one record a :meth:`log` call,
    with a wall-clock ``t``; a number (a 0-dim tensor or numpy scalar
    included) is written as a float."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, **fields: Any) -> None:
        rec = {"t": time.time()}
        rec.update({
            k: (float(v) if hasattr(v, "dtype") or isinstance(v, (int, float))
                else v)
            for k, v in fields.items()
        })
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
