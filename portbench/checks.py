"""The comparison that decides ``correct``: each number against the limit
its configuration file states."""

from __future__ import annotations

import math

OPS = {"<=": lambda v, lim: v <= lim, ">=": lambda v, lim: v >= lim}


def held(readings: dict, limits: dict) -> list:
    """``readings`` {name: number} against ``limits`` {name: [op, limit]}:
    one entry a number, in the limits' order. A number that is not finite,
    or has no reading, fails."""
    out = []
    for name, (op, limit) in limits.items():
        v = readings.get(name, math.nan)
        ok = isinstance(v, (int, float)) and math.isfinite(v) and \
            OPS[op](v, limit)
        out.append({"name": name, "value": v, "op": op, "limit": limit,
                    "holds": bool(ok)})
    return out
