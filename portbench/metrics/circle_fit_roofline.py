"""Kernel 4's share of its roofline on the batch tick: the least time the
card could take for the fit tail over a tick's B x C cluster slots, with
the operations of the slots that hold a cluster to fit
(``counts.circle_fit_tail_work``; the share of such slots from the
reference's clustering of the checked worlds' scans), over the device time
a tick of the kernels named ``circle_fit_tail``, in %.

The fit is found by its kernel's name: the port has no span around it.
Where no kernel of that name ran, the reader finds nothing and the run
fails (a cell that lists the metric fits circles every tick), so a fit
that moves to a kernel of another name is seen, not dropped. A span around
the fit inside the port (``utils/tracing.stage`` in ``ops/circle_fit``)
would let the reader take the device time of whatever that span launches.
"""

from portbench import counts


def read(trace, run):
    busy = trace.kernel_seconds("circle_fit_tail") / run.ticks
    if busy <= 0:
        return None
    slots = run.B * run.scn.max_clusters
    least = counts.least_seconds(*counts.circle_fit_tail_work(
        slots, run.live_share * slots))
    return 100.0 * least / busy
