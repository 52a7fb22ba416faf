"""The host's time a serving tick before the card's grid pass is queued: over
the window's ticks, the median of the end of the ``blocked.grid_pass`` span
(the kernel's launch has returned) less the start of the ``serving.tick``
span it nests in, in ms, on the host clock. In a closed loop the readback of
the last pose drains the card, so the card waits through this time before
its longest kernel can start."""

from portbench import spans


def read(trace, run):
    ticks = {s.id: s for s in spans.named("serving.tick")}
    return spans.median([(g.end_ns - ticks[g.parent].start_ns) / 1e6
                         for g in spans.named("blocked.grid_pass")
                         if g.parent in ticks])
