"""Work put on the card a tick, from the host: the profiler's CUDA runtime
and driver launch calls (kernels, graphs, async copies and fills) over the
traced window, over the ticks of the window. Includes the harness's three
copies a tick of the checked worlds' scan and detections."""


def read(trace, run):
    if trace.launches == 0:
        return None
    return trace.launches / run.ticks
