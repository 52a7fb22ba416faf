"""Kernel 1's share of its roofline on the serving tick, from the program's
own span: the least time the card could take for one grid pass over the
map's four planes (``counts.grid_update_work``, as ``grid_update_roofline``
counts it), over the median device time of the ``blocked.grid_pass`` span
(whatever the pass launches, by the span's CUDA events), in %."""

from portbench import counts, spans


def read(trace, run):
    busy_ms = spans.median(spans.device_ms("blocked.grid_pass"))
    if not busy_ms:
        return None
    least = counts.least_seconds(*counts.grid_update_work(run.N, run.N,
                                                          run.M))
    return 100.0 * least / (busy_ms / 1e3)
