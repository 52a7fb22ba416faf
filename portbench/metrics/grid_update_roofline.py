"""Kernel 1's share of its roofline on the serving tick: the least time the
card could take for one grid pass over the map's four planes
(``counts.grid_update_work``), over the device time a tick of the kernels
doing the grid pass (those named ``grid_update``), in %.

The grid pass is found by its kernel's name: the port has no span around
it. Where no kernel of that name ran, the reader finds nothing and the run
fails (a cell that lists the metric has a grid pass), so a pass that moves
to a kernel of another name is seen, not dropped. A span around the pass
inside the port (``utils/tracing.stage`` in ``parallel/blocked_ekf``) would
let the reader take the device time of whatever that span launches.
"""

from portbench import counts


def read(trace, run):
    busy = trace.kernel_seconds("grid_update") / run.attempted
    if busy <= 0:
        return None
    least = counts.least_seconds(*counts.grid_update_work(run.N, run.N,
                                                          run.M))
    return 100.0 * least / busy
