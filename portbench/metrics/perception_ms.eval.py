"""The device time a batch tick of the perception stage: the device milliseconds of
the program's ``tick.perception`` spans (the work each queues, by its CUDA
events) over the traced window's ticks."""

from portbench import spans


def read(trace, run):
    ms = spans.device_ms("tick.perception")
    return sum(ms) / run.ticks if ms else None
