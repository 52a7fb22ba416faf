"""Kernel 5's share of its roofline on the batch tick: the least time the
card could take for one filter tick of the B worlds
(``counts.ekf_tick_work``: the state read and written once, the tick's
measurements read once), over the device time a tick of the kernels named
``ekf_tick_kernel``, in %.

The filter's tick is found by its kernel's name, as ``circle_fit_roofline``
finds the fit. Where no kernel of that name ran, the reader finds nothing
and the run fails (a cell that lists the metric runs the filter every
tick), so a tick that moves to a kernel of another name is seen, not
dropped.
"""

from portbench import counts


def read(trace, run):
    busy = trace.kernel_seconds("ekf_tick_kernel") / run.ticks
    if busy <= 0:
        return None
    N = run.scn.num_landmarks
    least = counts.least_seconds(*counts.ekf_tick_work(
        run.B, 3 + 2 * N, N, run.scn.max_clusters))
    return 100.0 * least / busy
