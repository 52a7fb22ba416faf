"""Kernel 4's share of its roofline on the batch tick, from the program's own
span: the least time the card could take for the fit tail over a tick's B x
C cluster slots (``counts.circle_fit_tail_work``, with the share of live
slots, as ``circle_fit_roofline`` counts it), over the device time a tick of
the ``perception.circle_fit`` span (whatever the fit launches, by the span's
CUDA events), in %."""

from portbench import counts, spans


def read(trace, run):
    busy_ms = sum(spans.device_ms("perception.circle_fit"))
    if not busy_ms:
        return None
    slots = run.B * run.scn.max_clusters
    least = counts.least_seconds(*counts.circle_fit_tail_work(
        slots, run.live_share * slots))
    return 100.0 * least / (busy_ms / 1e3 / run.ticks)
