"""The port's own spans and counters (``utils/tracing`` of the program), as
the per-layer readers take them. A program that records none (one older
than its recorder) gives no spans and no counters here, so its readers
find nothing, and nothing raises.

Of the readers, ``kernel_load_s`` and the batch tick's ``sim_ms.eval``,
``perception_ms.eval`` and ``filter_ms.eval`` are in ``BENCHMARK.json``,
each listing the cells it reads in; there ``run.per_layer`` fails a
metric that reads nothing, so a program without the recorder fails the
traced run."""

from __future__ import annotations

import statistics

from shermbot_navigation_tpu_torch.utils import tracing


def named(name: str) -> list:
    """The recorded spans called ``name``, oldest first."""
    read = getattr(tracing, "spans", None)
    return [] if read is None else [s for s in read() if s.name == name]


def counter(name: str):
    """The counter ``name``, or None."""
    read = getattr(tracing, "counters", None)
    return None if read is None else read().get(name)


def device_ms(name: str) -> list:
    """The device milliseconds of the spans called ``name`` that timed the
    card."""
    return [s.device_ms for s in named(name) if s.device_ms is not None]


def median(values):
    return statistics.median(values) if values else None
