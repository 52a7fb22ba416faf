"""The program's spans and counters, and the operator's trace exporter
(port of ``shermbot_navigation_tpu.utils.tracing``).

- :func:`stage` -- a named span around one layer of the program. While no
  ``torch.profiler`` is active it is one shared no-op context manager and
  records nothing, so the untraced path pays two checks a span (a
  profiler on, ``torch.compile`` tracing). While one
  is (:func:`trace`, or any ``torch.profiler.profile``), the span is a
  range on the profiler's host timeline, on the clock of the device's
  kernels and copies, and a record here: its name, the span it nests in
  (per thread) and its host start and end. A span given a CUDA device
  also times the work queued on that device's current stream, by a pair
  of CUDA events (none while the stream captures a graph).
- :func:`spans` -- the finished records, the newest :data:`CAPACITY` kept;
  :func:`counters` -- the counts added by :func:`count`, always on, so
  counted only at boundaries that run once a process or a session, never
  once a tick; :func:`clear` empties the spans and keeps the counters.
- :func:`trace` -- profile a block and write its Chrome trace to
  ``logdir/trace.json``; spans inside it are recorded.

The range is the profiler's function-scope record (``cpu_op`` in the
trace), not ``torch.profiler.record_function``'s user annotation: the
profiler mirrors a user annotation onto the device's timeline, where it
would read as device work over the host gaps it encloses.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

CAPACITY = 65536

_enabled = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_done: collections.deque = collections.deque(maxlen=CAPACITY)
_counters: dict = {}
_ids = itertools.count()
_open = threading.local()


class _Stage:
    """A span: ``name``, ``id``, ``parent`` (the id of the span it nests
    in, or None), ``start_ns`` and ``end_ns`` (``time.perf_counter_ns``),
    and, once finished and read by :func:`spans`, ``device_ms`` (the device
    time between its events, or None for a host span)."""

    __slots__ = ("name", "device", "id", "parent", "start_ns", "end_ns",
                 "device_ms", "_events", "_fn")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.device_ms = None

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self._fn = _range(self.name)
        self._fn.__enter__()
        self._events = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            if not torch.cuda.is_current_stream_capturing():
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(stream)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        self._fn.__exit__(*exc)
        _open.stack.pop()
        _done.append(self)
        return False


def stage(name: str, device=None):
    """A span named ``name`` (``with stage(name):``); ``device``, where it
    is a CUDA device, also times the work queued on its current stream.
    Records only while a ``torch.profiler`` is active, and never inside
    code that ``torch.compile`` traces (which would break its graph)."""
    if torch.compiler.is_compiling() or not _enabled():
        return _OFF
    return _Stage(name, None if device is None else torch.device(device))


def spans() -> list:
    """The finished spans, oldest first. A device span's ``device_ms`` is
    read from its events here, after one synchronize of the cards the
    unread ones were queued on."""
    done = list(_done)
    pending = [s for s in done if s._events is not None]
    for dev in {s.device for s in pending}:
        torch.cuda.synchronize(dev)
    for s in pending:
        s.device_ms = s._events[0].elapsed_time(s._events[1])
        s._events = None
    return done


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    return dict(_counters)


def clear() -> None:
    """Forget the finished spans. The counters stay: each is added once a
    process or a session, so clearing them would lose it for good."""
    _done.clear()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile everything inside the block; the trace is written to
    ``logdir/trace.json`` (Chrome trace format, which TensorBoard's
    profile plugin and ``chrome://tracing`` read). The program's spans
    are recorded while it runs."""
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
