"""Lidar scans for the perception tests, from numpy alone (no JAX, so that
the card's tests can use them): the reference's clustering cases, arcs,
tubes and a cluster across ray 0."""

import numpy as np


def synth_scan(segments, n=360, fill=2.0):
    r = np.full(n, fill)
    for s, e, v in segments:
        r[s:e] = v
    return r


# the reference's clustering cases (tests/test_perception.py) with the
# valid clusters' counts they expect
CLUSTER_CASES = {
    "two_clusters": ([(10, 20, 0.5), (100, 110, 0.7)], [10, 10]),
    "jump_splits": ([(10, 15, 0.5), (15, 20, 0.7)], [5, 5]),
    "small_jump_merges": ([(10, 15, 0.5), (15, 20, 0.52)], [10]),
    "out_of_range_gap": ([(10, 15, 0.99), (15, 18, 1.01), (18, 23, 0.99)],
                         [10]),
    "closes_at_359": ([(350, 360, 0.5)], [10]),
    "wraparound_moves_359": ([(355, 360, 0.5), (0, 5, 0.5)], [6]),
    "min_range_filtered": ([(10, 20, 0.01)], []),
    "under_3_invalid": ([(10, 12, 0.5)], []),
    "overflow_of_P": ([(10, 90, 0.5)], [80]),
}


def arc_scans(seed, count, noise, dtype=np.float64):
    """The reference's structured random scans: an out-of-range background
    and a few arcs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        ranges = np.full(360, 5.0)
        for _ in range(int(rng.integers(1, 7))):
            c = int(rng.integers(0, 360))
            w = int(rng.integers(3, 25))
            r0 = rng.uniform(0.1, 0.95)
            span = np.arange(c - w // 2, c + w // 2) % 360
            ranges[span] = r0 + rng.normal(0, noise, span.shape[0])
        out.append(ranges)
    return np.stack(out).astype(dtype)


def tube_scans(seed, count, noise=1e-4, dtype=np.float64):
    """Scans of tubes (radius 0.0381) around the robot, exact ray-circle
    ranges at integer degrees plus a little range noise (a noise-free tube
    gives a rank-deficient moment matrix, whose fit amplifies ulps)."""
    rng = np.random.default_rng(seed)
    ang = np.deg2rad(np.arange(360.0))
    u = np.stack([np.cos(ang), np.sin(ang)], -1)
    out = []
    for _ in range(count):
        ranges = np.full(360, 2.0)
        for _ in range(int(rng.integers(2, 9))):
            d, a = rng.uniform(0.2, 1.05), rng.uniform(0, 2 * np.pi)
            c = d * np.array([np.cos(a), np.sin(a)])
            b = -(u @ c)
            disc = b * b - (c @ c - 0.0381 ** 2)
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            hit = (disc >= 0) & (t > 0)
            ranges = np.where(hit & (t < ranges), t, ranges)
        ranges = np.where(ranges < 2.0,
                          ranges + rng.normal(0, noise, 360), ranges)
        out.append(ranges)
    return np.stack(out).astype(dtype)


def wraparound_scan():
    ranges = np.full(360, 5.0)
    th = np.deg2rad(np.arange(-8, 9).astype(np.float64))
    ranges[np.arange(-8, 9) % 360] = 0.5 * np.cos(th) - np.sqrt(
        np.maximum(0.04 ** 2 - (0.5 * np.sin(th)) ** 2, 0.0))
    return ranges[None]
