"""Perception of the port (``ops/clustering``, ``ops/landmark_detection``)
against the JAX reference on the CPU: the port is batch-first, so a stack
of scans goes through it at once and through ``jax.vmap`` of the JAX
function. Decisions (cluster boundaries, counts, validity, circle / not)
must be equal; positions to the tolerance written at each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.ops import clustering as jcl
from shermbot_navigation_tpu.ops import landmark_detection as jld
from shermbot_navigation_tpu_torch.ops import clustering as tcl
from shermbot_navigation_tpu_torch.ops import landmark_detection as tld
from shermbot_navigation_tpu_torch.utils import convert

MINR, MAXR = 0.05, 1.0

# the JAX functions vmapped over a stack of scans and jitted (eager vmap
# dispatches every op of the Jacobi chain by itself and is 4x slower)
J_DETECT = {s: jax.jit(jax.vmap(lambda r, s=s: jld.detect_landmarks(
    r, MINR, MAXR, segmented=s))) for s in (True, False)}
J_CLUSTER = jax.jit(jax.vmap(lambda r: jcl.cluster_scan(r, MINR, MAXR)))


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


def _arc_scans(seed, count, noise, dtype=np.float64):
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


def _tube_scans(seed, count, noise=1e-4, dtype=np.float64):
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


def _wraparound_scan():
    ranges = np.full(360, 5.0)
    th = np.deg2rad(np.arange(-8, 9).astype(np.float64))
    ranges[np.arange(-8, 9) % 360] = 0.5 * np.cos(th) - np.sqrt(
        np.maximum(0.04 ** 2 - (0.5 * np.sin(th)) ** 2, 0.0))
    return ranges[None]


def test_cluster_scan_reference_cases_match_jax():
    scans = np.stack([synth_scan(seg) for seg, _ in CLUSTER_CASES.values()])
    got = tcl.cluster_scan(torch.from_numpy(scans), MINR, MAXR)
    want = J_CLUSTER(jnp.asarray(scans))
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_allclose(got.points.numpy(), want.points, rtol=0,
                               atol=1e-15)
    for k, (_, expect) in enumerate(CLUSTER_CASES.values()):
        assert sorted(got.counts[k][got.valid[k]].tolist()) == sorted(expect)
    assert got.counts.dtype == torch.int32


@pytest.mark.parametrize("maker,seed", [(_arc_scans, 3), (_tube_scans, 4)])
def test_cluster_and_classify_match_jax(maker, seed):
    scans = maker(seed, 12, 0.01) if maker is _arc_scans else maker(seed, 12)
    got = tcl.cluster_scan(torch.from_numpy(scans), MINR, MAXR)
    want = J_CLUSTER(jnp.asarray(scans))
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_allclose(got.points.numpy(), want.points, rtol=0,
                               atol=1e-15)
    margins = {}
    circ = tcl.classify_clusters(got, margins=margins)
    jcirc = jax.jit(jax.vmap(jcl.classify_clusters))(want)
    np.testing.assert_array_equal(circ.numpy(), jcirc)
    assert float(margins["std"]) > 1e-6       # no decision sat on a tie


def test_cluster_scan_small_buffers_drop_overflow():
    """C=2 slots and P=4 rows: clusters past C and rows past P are dropped,
    the counts keep the full size."""
    scan = synth_scan([(10, 20, 0.5), (100, 110, 0.7), (200, 210, 0.6)])
    got = tcl.cluster_scan(torch.from_numpy(scan), MINR, MAXR,
                           max_clusters=2, max_points=4)
    want = jcl.cluster_scan(jnp.asarray(scan), MINR, MAXR, max_clusters=2,
                            max_points=4)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_allclose(got.points.numpy(), want.points, atol=1e-15)
    assert got.counts.tolist() == [10, 10]


@pytest.mark.parametrize("case", ["arc", "line", "corner"])
def test_classify_reference_cases(case):
    if case == "arc":
        th = np.linspace(0.3, 2.0, 12)
        pts = np.stack([0.5 * np.cos(th), 0.5 * np.sin(th)], -1)
    elif case == "line":
        t = np.linspace(0, 1, 12)
        pts = np.stack([t, 0.5 * t], -1) + np.random.default_rng(2).normal(
            0, 1e-4, (12, 2))
    else:
        pts = np.concatenate(
            [np.stack([np.linspace(0, 1, 8), np.zeros(8)], -1),
             np.stack([np.ones(8), np.linspace(0.1, 1, 8)], -1)])
    buf = np.zeros((1, 64, 2))
    buf[0, :len(pts)] = pts
    arrays = dict(points=buf, counts=np.array([len(pts)], np.int32),
                  valid=np.array([True]))
    got = tcl.classify_clusters(convert.clusters_from_numpy(arrays, "cpu"))
    want = jcl.classify_clusters(jcl.Clusters(
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    assert bool(got[0]) == bool(want[0])
    if case != "line":
        assert bool(got[0]) == (case == "arc")


def _pad16(scans):
    """Repeat the last scan up to 16 rows: one compiled shape for JAX."""
    assert len(scans) <= 16
    return np.concatenate([scans] + [scans[-1:]] * (16 - len(scans)))


def _three_way(scans, atol):
    """segmented = buffered = JAX, on a stack of scans."""
    scans = _pad16(scans)
    t = torch.from_numpy(scans)
    seg = tld.detect_landmarks(t, MINR, MAXR, segmented=True)
    buf = tld.detect_landmarks(t, MINR, MAXR, segmented=False)
    default = tld.detect_landmarks(t, MINR, MAXR)
    assert torch.equal(default.valid, seg.valid)
    assert torch.equal(default.positions, seg.positions)
    for s in (True, False):
        want = J_DETECT[s](jnp.asarray(scans))
        got = seg if s else buf
        v = np.asarray(want.valid)
        np.testing.assert_array_equal(got.valid.numpy(), v)
        np.testing.assert_allclose(got.positions.numpy()[v],
                                   np.asarray(want.positions)[v], rtol=0,
                                   atol=atol)
    v = seg.valid.numpy()
    np.testing.assert_array_equal(buf.valid.numpy(), v)
    # the JAX package's pin between its two paths
    np.testing.assert_allclose(seg.positions.numpy()[v],
                               buf.positions.numpy()[v], atol=1e-5)
    return int(v.sum())


def test_detect_random_scans_three_way():
    """``TestSegmentedDetect.test_random_scans``'s scans."""
    _three_way(_arc_scans(3, 12, 0.01), 1e-10)


def test_detect_tube_scans_three_way():
    """Tubes with 1e-4 range noise: detections exist (unlike the noisy
    arcs above, which the classifier rejects), and the fit is conditioned
    well enough that the port agrees with JAX to 1e-9."""
    assert _three_way(_tube_scans(5, 16), 1e-9) > 20


def test_detect_wraparound_and_all_out_of_range():
    _three_way(np.concatenate([_wraparound_scan(),
                               np.full((2, 360), 5.0)]), 1e-10)


def test_detect_f32_decisions_equal():
    """``TestSegmentedDetect.test_f32_matches_too`` plus tube scans, f32:
    the detection masks of both paths equal JAX's, positions at the JAX
    test's 1e-3."""
    rng = np.random.default_rng(9)
    ranges = np.full(360, 5.0, np.float32)
    for c in (40, 130, 270):
        span = np.arange(c - 6, c + 7) % 360
        ranges[span] = 0.6 + rng.normal(0, 0.005, 13)
    scans = _pad16(np.concatenate([ranges[None],
                                   _tube_scans(6, 8, 1e-3, np.float32)]))
    for s in (True, False):
        got = tld.detect_landmarks(torch.from_numpy(scans), MINR, MAXR,
                                   segmented=s)
        want = J_DETECT[s](jnp.asarray(scans))
        v = np.asarray(want.valid)
        assert v.sum() > 10
        np.testing.assert_array_equal(got.valid.numpy(), v)
        np.testing.assert_allclose(got.positions.numpy()[v],
                                   np.asarray(want.positions)[v], atol=1e-3)


def test_detect_synthetic_tube_and_margins():
    """``TestDetect``: one tube at (0.5, 0) is found at its centre; the
    diagnostics report finite margins."""
    ranges = np.full(360, 2.0)
    for k in range(360):
        th = np.deg2rad(k)
        b = -(0.5 * np.cos(th))
        disc = b * b - (0.25 - 0.0381 ** 2)
        if disc >= 0 and -b - np.sqrt(disc) > 0:
            ranges[k] = -b - np.sqrt(disc)
    margins = {}
    det = tld.detect_landmarks(torch.from_numpy(ranges), MINR, MAXR,
                               margins=margins)
    got = det.positions[det.valid].numpy()
    assert got.shape[0] == 1
    np.testing.assert_allclose(got[0], [0.5, 0.0], atol=5e-3)
    assert np.isfinite(float(margins["split"]))
    assert np.isfinite(float(margins["std"]))
