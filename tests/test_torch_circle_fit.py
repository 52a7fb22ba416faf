"""The whole-fit kernel's wrappers (``ops/kernels/circle_fit``: the fused
moments + eigen-chain of the buffered path, and the tail of the segmented
path) against the JAX reference on the CPU. The wrappers run their plain
versions here (CPU tensors); the JAX moments run through the XLA route
and through the Pallas kernel in interpret mode, as in the JAX package's
own tests. The kernel itself is held bit for bit against these plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: in f64 the two chains differ by libm ulps (atan2, cos, sin)
amplified by the fit's conditioning, 1e-10 on centre and radius outside
the decade just above the rank switch (``_off_switch``); in f32
the JAX package's own kernel pin, 1e-4, on clusters away from the fit's
rank-deficiency switch, where two f32 implementations may take different
branches (``chip_smoke.py`` records how often)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_to_numpy  # noqa: F401  (one torch thread)
from shermbot_navigation_tpu.ops import circle_fit as jcf
from shermbot_navigation_tpu.ops import clustering as jcl
from shermbot_navigation_tpu_torch.ops import circle_fit as tcf
from shermbot_navigation_tpu_torch.ops import landmark_detection as tld
from shermbot_navigation_tpu_torch.ops.clustering import Clusters
from shermbot_navigation_tpu_torch.ops.kernels import circle_fit as cfk
from shermbot_navigation_tpu_torch.ops.kernels import circle_moments as tcm
from shermbot_navigation_tpu_torch.ops.smallalg import eigh4_jacobi_c

P = 16


def _clusters(kind, C, dtype, seed):
    """``(points (C, P, 2), counts (C,), valid (C,))`` of one kind:
    "random" noisy arcs of radii 0.04..1.5; "exact" noise-free tube-sized
    arcs of 5 points or more (their moment matrix is singular up to
    rounding, of either sign: the rank switch); "edge" noisy arcs with
    counts 0..3, exactly P and above P. Rows at and past a count hold
    junk. Left out, as ill-posed for two f64 chains: noise-free arcs of a
    large radius (smallest eigenvalue ~1e-17 of the largest, past the
    switch into a near-singular solve), exact arcs of 4 points (sigma4
    ~3e-12, on the switch) and near-collinear sets (radii of 1e2..1e4,
    held to 1e-8 in ``test_torch_circle_moments.py``): libm ulps move
    their fits by up to O(1)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((C, P, 2))
    counts = rng.integers(5 if kind == "exact" else 4, P + 1, C)
    for c in range(C):
        th = np.sort(rng.uniform(0, 2.5, P))
        ctr = rng.uniform(-1.5, 1.5, 2)
        if kind == "exact":
            r = 0.0381
            noise = 0.0
        else:
            r = rng.uniform(0.04, 1.5)
            noise = (1e-3, 2e-2, 1e-4)[c % 3]
        arc = ctr + r * np.stack([np.cos(th), np.sin(th)], -1)
        pts[c] = arc + rng.normal(0, noise, (P, 2))
    if kind == "edge":
        counts[:6] = [0, 1, 2, 3, P, P + 9]
    pts[np.arange(P)[None, :] >= counts[:, None]] = 1e3
    valid = counts >= 3
    valid[::5] = False
    return pts.astype(dtype), counts.astype(np.int32), valid


def _jax_moments(pts, counts):
    return jcf._moments_comps(jnp.asarray(pts), jnp.asarray(counts))


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _off_switch(m16):
    """Clusters whose sigma4 (the square root of the moment matrix's
    smallest eigenvalue) is not in the decade just above the rank switch,
    [1e-12, 1e-11). There the fit solves a near-singular system and libm's
    last bits move it by centimetres: on 288 exact arcs in f64, 7 fits
    (sigma4 1.4e-12..7.2e-12) parted from JAX's by 0.03 m, every other by
    less than 1e-10."""
    lam, _ = eigh4_jacobi_c([m16[:, k] for k in range(16)])
    s4 = torch.sqrt(torch.clamp_min(lam[0], 0.0)).numpy()
    return ~((s4 >= 1e-12) & (s4 < 1e-11))


def _compare(got, want, atol, where=None):
    """``ok`` equal (where ``where``), centre and radius within ``atol``
    where both are ok."""
    center, radius, ok = got
    jcenter, jradius, jok = (np.asarray(x) for x in want)
    sel = np.ones_like(jok) if where is None else where
    np.testing.assert_array_equal(ok.numpy()[sel], jok[sel])
    m = jok if where is None else jok & where
    assert m.any()
    np.testing.assert_allclose(center.numpy()[m], jcenter[m], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(radius.numpy()[m], jradius[m], rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kind", ["random", "exact", "edge"])
@pytest.mark.parametrize("layout", [16, 10])
def test_fit_tail_f64_matches_jax(kind, layout):
    """``fit_tail`` (plain route) against the JAX ``_fit_tail_c`` on the
    same f64 moments, in both moment layouts: the 16 row-major entries and
    the segmented path's 10 distinct ones read as a strided view."""
    pts, counts, valid = _clusters(kind, 24, np.float64, 0)
    mc, cx, cy, zbar = _jax_moments(pts, counts)
    want = jcf._fit_tail_c(mc, cx, cy, zbar, jnp.asarray(counts),
                           jnp.asarray(valid))
    m16 = np.stack([np.asarray(x) for x in mc], -1)
    if layout == 16:
        m = torch.from_numpy(m16)
    else:
        wide = np.zeros((24, 11))
        wide[:, 1:] = m16[:, [0, 1, 2, 3, 5, 6, 7, 10, 11, 15]]
        m = torch.from_numpy(wide)[:, 1:]
        assert not m.is_contiguous()
    got = cfk.fit_tail(m, *_torch(np.asarray(cx), np.asarray(cy),
                                  np.asarray(zbar), counts, valid))
    _compare(got, want, 1e-10, where=_off_switch(torch.from_numpy(m16)))


@pytest.mark.parametrize("kind", ["random", "exact", "edge"])
def test_circle_fit_raw_f64_matches_jax(kind):
    """The whole fit (``circle_fit_raw``, plain route) in f64: its moments
    against JAX's (XLA route) to 1e-12, its fit against the JAX chain on
    those same moments to 1e-10, and, where the fit is well-posed
    (noisy arcs), against JAX ``fit_circles`` end to end to 1e-10. On an
    exact arc the two sides' moments, summed in another order, put the
    smallest eigenvalue (~1e-22) on either side of the rank switch, so
    end to end is not held there; nor, on either check, is a fit in the
    decade above the switch (``_off_switch``)."""
    pts, counts, valid = _clusters(kind, 24, np.float64, 1)
    got = cfk.circle_fit_raw(*_torch(pts, counts, valid))
    mc, cx, cy, zbar = _jax_moments(pts, counts)
    np.testing.assert_allclose(got[3].numpy(), np.stack(mc, -1), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got[4].numpy(), np.stack([cx, cy], -1),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[5].numpy(), zbar, rtol=0, atol=1e-12)
    own = [jnp.asarray(got[3][:, k].numpy()) for k in range(16)]
    _compare(got[:3], jcf._fit_tail_c(
        own, jnp.asarray(got[4][:, 0].numpy()),
        jnp.asarray(got[4][:, 1].numpy()), jnp.asarray(got[5].numpy()),
        jnp.asarray(counts), jnp.asarray(valid)), 1e-10,
        where=_off_switch(got[3]))
    if kind != "exact":
        _compare(got[:3], jcf.fit_circles(
            jcl.Clusters(*map(jnp.asarray, (pts, counts, valid))),
            use_pallas=False), 1e-10)


def test_circle_fit_raw_f32_matches_pallas_interpret():
    """f32, against JAX ``fit_circles(use_pallas=True, interpret=True)``
    (the TPU moment kernel in interpret mode, then the chain): ``ok``
    equal, centre and radius at the JAX package's pin on noisy arcs (away
    from the rank switch), the moments at its kernel pin."""
    pts, counts, valid = _clusters("edge", 32, np.float32, 2)
    jc = jcl.Clusters(*map(jnp.asarray, (pts, counts, valid)))
    want = jcf.fit_circles(jc, use_pallas=True, interpret=True)
    got = cfk.circle_fit_raw(*_torch(pts, counts, valid))
    noisy = np.arange(32) % 3 != 2
    _compare(got[:3], want, 1e-4, where=noisy)
    from shermbot_navigation_tpu.ops.pallas.circle_moments import (
        circle_moments_raw as j_moments_raw)
    jm, jcent, jzbar = j_moments_raw(jc.points, jc.counts, interpret=True)
    np.testing.assert_allclose(got[3].numpy(), jm, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[4].numpy(), jcent, rtol=1e-5, atol=1e-6)


def test_fit_tail_f32_matches_jax():
    """f32 on the same moments: ``ok`` equal, 1e-4 on noisy arcs."""
    pts, counts, valid = _clusters("random", 32, np.float32, 3)
    mc, cx, cy, zbar = _jax_moments(pts, counts)
    want = jcf._fit_tail_c(mc, cx, cy, zbar, jnp.asarray(counts),
                           jnp.asarray(valid))
    m16 = np.stack([np.asarray(x) for x in mc], -1)
    got = cfk.fit_tail(*_torch(m16, np.asarray(cx), np.asarray(cy),
                               np.asarray(zbar), counts, valid))
    _compare(got, want, 1e-4, where=np.arange(32) % 3 != 2)


def test_wrappers_are_the_plain_versions_on_the_cpu():
    """On CPU tensors neither wrapper launches: ``circle_fit_raw`` is
    ``_reference_raw`` then ``_fit_tail_c`` bit for bit, its moments are
    ``circle_moments_raw``'s, ``fit_tail`` on those moments gives the same
    fit, and ``fit_circles`` returns it; leading batch dimensions
    flatten."""
    pts, counts, valid = _torch(*_clusters("edge", 12, np.float32, 4))
    before = (cfk.circle_fit_raw.launches, cfk.fit_tail.launches)
    center, radius, ok, m16, cent, zbar = cfk.circle_fit_raw(pts, counts,
                                                             valid)
    mc, cx, cy, zb = tcm._reference_raw(pts, counts)
    want = cfk._fit_tail_c(mc, cx, cy, zb, counts, valid)
    for g, w in zip((center, radius, ok), want):
        assert torch.equal(g, w)
    for g, w in zip((m16, cent, zbar), tcm.circle_moments_raw(pts, counts)):
        assert torch.equal(g, w)
    tail = cfk.fit_tail(m16, cent[:, 0], cent[:, 1], zbar, counts, valid)
    for g, w in zip(tail, want):
        assert torch.equal(g, w)
    fits = tcf.fit_circles(Clusters(points=pts, counts=counts, valid=valid))
    assert torch.equal(fits.center, center) and torch.equal(fits.valid, ok)
    nested = cfk.circle_fit_raw(pts.reshape(3, 4, P, 2),
                                counts.reshape(3, 4), valid.reshape(3, 4))
    for g, w in zip(nested, (center, radius, ok, m16, cent, zbar)):
        assert torch.equal(g.reshape(w.shape), w)
    assert (cfk.circle_fit_raw.launches, cfk.fit_tail.launches) == before


def _scan(B, seed):
    """Scans of three tubes from the origin with a little range noise."""
    rng = np.random.default_rng(seed)
    ang = np.deg2rad(np.arange(360.0))
    ranges = np.full((B, 360), 2.0)
    for cx, cy in ((0.6, 0.0), (0.0, 0.5), (-0.4, -0.4)):
        b = cx * np.cos(ang) + cy * np.sin(ang)
        disc = b * b - (cx * cx + cy * cy - 0.0381 ** 2)
        hit = (disc > 0) & (b > 0)
        t = np.where(hit, b - np.sqrt(np.maximum(disc, 0.0)), 2.0)
        ranges = np.minimum(ranges, t)
    ranges += rng.normal(scale=2e-4, size=ranges.shape) * (ranges < 1.5)
    return torch.from_numpy(ranges.astype(np.float32))


def test_segmented_detection_plain_route_is_bit_equal():
    """``detect_landmarks`` (segmented) routes its front end through
    ``perception.fit_inputs`` and its fit through ``fit_tail``: on the CPU
    it is the explicit plain chain (``_segment_fit_inputs`` ->
    ``_fit_tail_c`` -> ``_compact``), bit for bit."""
    scan = _scan(3, 5)
    a = tld.detect_landmarks(scan, 0.05, 1.0)
    mom, cx, cy, zbar, count, valid, is_circle = tld._segment_fit_inputs(
        scan, 0.05, 1.0, 16, 64, 10.0)
    center, radius, okf = cfk._fit_tail_c(cfk.components(mom), cx, cy, zbar,
                                          count, valid)
    b = tld._compact(center, is_circle & okf & (radius <= 1.0))
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.valid, b.valid)
    assert a.valid.sum(-1).tolist() == [3, 3, 3]


def test_trace_follows_the_tail():
    """The plain tail's trace (the kernel's trace entry lists the same
    intermediates in the same order): 369 named values, each rotation's
    cosine and sine those of its angle, and the last four the result."""
    names = cfk.trace_names()
    assert len(names) == 369 and len(set(names)) == 369
    pts, counts, valid = _torch(*_clusters("random", 1, np.float32, 7))
    mc, cx, cy, zb = tcm._reference_raw(pts, counts)
    trace = []
    center, radius, ok = cfk._fit_tail_c(mc, cx, cy, zb, counts, valid,
                                         trace=trace)
    assert [n for n, _ in trace] == names
    vals = dict(trace)
    th = vals["eigh_Q.sweep3(1,2).theta"]
    assert torch.equal(vals["eigh_Q.sweep3(1,2).c"], torch.cos(th))
    assert torch.equal(vals["eigh_Q.sweep3(1,2).s"], torch.sin(th))
    assert torch.equal(vals["center_x"], center[..., 0])
    assert torch.equal(vals["radius"], radius)
    assert torch.equal(vals["ok"].bool(), ok)
    with pytest.raises(ValueError, match="card"):
        cfk.trace(mc[0], cx, cy, zb, True)
