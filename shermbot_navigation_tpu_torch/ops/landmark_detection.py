"""Scan -> landmark detections: the perception stage as one function (port
of ``shermbot_navigation_tpu.ops.landmark_detection``), batch-first:
``ranges (..., n)`` -> ``Detections`` with ``positions (..., C, 2)``.

Equivalent of the reference ``landmarks`` node (``nuslam/src/landmarks.cpp``):
cluster the scan, classify clusters as circles, fit circles, and emit
robot-frame landmark positions. Filtering matches the node (ref :84-105):
non-circle clusters dropped; degenerate fits (< 4 points) dropped; fitted
radius > 1 m dropped; positions are the fitted centers. Detections keep
cluster order (what matters for the EKF's sequential updates).

Forms taken where the JAX package used a TPU lowering device: the
compaction permutation and the cluster-to-ray broadcasts are ``gather``
(JAX: one-hot matmuls); the segment sums stay one-hot ``torch.matmul``
products (full f32, TF32 is off package-wide), because a matmul sums in a
fixed order where ``scatter_add`` on the card uses atomics and would make
the perception stage differ in ulps from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.tracing import stage
from . import se2
from .circle_fit import fit_circles
from .clustering import (SPLIT_THRESHOLD, _scan_membership, classify_clusters,
                         cluster_scan)
from .kernels import circle_fit as cfk


class Detections(NamedTuple):
    positions: torch.Tensor  # (..., C, 2) robot-frame centers, compacted
    valid: torch.Tensor      # (..., C) detection mask


def _compact(center, ok):
    """Compact valid detections to the front, preserving order (stable);
    the permutation is applied with ``gather``."""
    C = ok.shape[-1]
    slot = torch.arange(C, device=ok.device)
    order = torch.argsort(torch.where(ok, slot, C), dim=-1, stable=True)
    positions = torch.gather(center, -2,
                             order[..., None].expand(*order.shape, 2))
    return Detections(positions=positions,
                      valid=torch.gather(ok, -1, order))


def _segment_fit_inputs(ranges, min_range, max_range, max_clusters: int,
                        max_points: int, std_threshold_deg: float = 10.0,
                        margins: dict | None = None):
    """The segmented path up to its fit: ``(moments (..., C, 10), cx, cy,
    zbar, count, valid, is_circle)``, the moments the 10 distinct sums
    (zz, zx, zy, z, xx, xy, x, yy, y, n) as columns of the one segment-sum
    product that also holds the angle deviations (a strided view, which
    the tail kernel reads in place)."""
    n = ranges.shape[-1]
    dt = ranges.dtype
    dev = ranges.device
    C = max_clusters
    P = max_points
    idx = torch.arange(n, device=dev)
    slot = torch.arange(C, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    pts, member, cid, pos, counts, num_closed, wrap_move = _scan_membership(
        ranges, min_range, max_range, C, SPLIT_THRESHOLD, margins)
    x = pts[..., 0]
    y = pts[..., 1]

    # effective buffer coordinates per ray (incl. the wrap append; a full
    # cluster 0 overwrites its last stored row, exactly like the buffer's
    # row write at min(counts0, P-1))
    is_last = idx == n - 1
    wrap = wrap_move[..., None]
    counts0 = counts[..., :1]
    moved = is_last & wrap
    rcid = torch.where(moved, torch.zeros_like(cid), cid)
    rpos = torch.where(moved, torch.clamp_max(counts0, P - 1), pos)
    overwritten = ((~is_last) & wrap & (counts0 >= P)
                   & (cid == 0) & (pos == P - 1))
    rinc = ((member & (pos < P) & ~overwritten) | moved) & (rcid < C)

    count_final = counts + (wrap & (slot == 0)).to(counts.dtype)
    valid = (slot < num_closed[..., None]) & (count_final >= 3)

    Wc = ((rcid[..., None, :] == slot[:, None])
          & rinc[..., None, :]).to(dt)                     # (..., C, n)
    rcid_c = torch.clamp(rcid, 0, C - 1).long()

    def seg(vals):
        """Segment-sum a list of per-ray tensors -> list of (..., C)."""
        out = torch.matmul(Wc, torch.stack(vals, dim=-1))  # (..., C, K)
        return [out[..., k] for k in range(len(vals))]

    def bcast(v):
        """Broadcast a per-cluster tensor back to rays (0 off-cluster)."""
        return torch.where(rinc, torch.gather(v, -1, rcid_c), zero)

    # endpoints: first stored row / last stored row of each cluster
    w0 = Wc * (rpos == 0).to(dt)[..., None, :]
    p2 = torch.matmul(w0, pts)                             # (..., C, 2)
    last = torch.clamp(count_final - 1, 0, P - 1)
    w3 = Wc * (rinc & (rpos == torch.gather(last, -1, rcid_c))
               ).to(dt)[..., None, :]
    p3 = torch.matmul(w3, pts)

    cf_r = bcast(count_final.to(dt))
    p2x_r, p2y_r = bcast(p2[..., 0]), bcast(p2[..., 1])
    p3x_r, p3y_r = bcast(p3[..., 0]), bcast(p3[..., 1])

    # inscribed angles (ref :221-224), interior rows only
    num = p2y_r * (x - p3x_r) + y * (p3x_r - p2x_r) + p3y_r * (p2x_r - x)
    den = (p2x_r - x) * (x - p3x_r) + (p2y_r - y) * (y - p3y_r)
    angles = se2.rad2deg(torch.atan2(num, den))
    interior = rinc & (rpos >= 1) & (rpos.to(dt) <= cf_r - 2.0)
    ang0 = torch.where(interior, angles, zero)             # select, not *

    sx, sy, s_ang, s_int = seg([x, y, ang0, interior.to(dt)])
    cnt_m = torch.clamp_min(count_final, 1).to(dt)
    cx = sx / cnt_m
    cy = sy / cnt_m
    cnt_i = torch.clamp_min(s_int, 1.0)
    mean_ang = s_ang / cnt_i

    dev2 = torch.where(interior, (angles - bcast(mean_ang)) ** 2, zero)
    xc = x - bcast(cx)
    yc = y - bcast(cy)
    z = xc * xc + yc * yc
    sums = torch.matmul(Wc, torch.stack(
        [dev2, z * z, z * xc, z * yc, z, xc * xc, xc * yc, xc,
         yc * yc, yc, torch.ones_like(x)], dim=-1))       # (..., C, 11)
    s_dev2, sz = sums[..., 0], sums[..., 4]

    std = torch.sqrt(s_dev2 / cnt_i)
    real = valid & (count_final >= 3)
    if margins is not None:
        inf = torch.full_like(std, float("inf"))
        margins["std"] = torch.where(
            real, torch.abs(std - std_threshold_deg), inf).min()
    is_circle = real & (std < std_threshold_deg)
    zbar = sz / cnt_m
    return sums[..., 1:], cx, cy, zbar, count_final, valid, is_circle


def _detect_segmented(ranges, min_range, max_range, max_clusters: int,
                      max_points: int, max_radius: float,
                      std_threshold_deg: float = 10.0,
                      margins: dict | None = None,
                      use_kernel: bool | None = None) -> Detections:
    """The whole perception stage as SEGMENT REDUCTIONS over rays: no
    ``(C, P, 2)`` point buffer; the quantities the buffered path reduces
    from the buffer (endpoints, inscribed angles, centroid, moments) come
    straight from per-ray tensors through ``(C, n)`` one-hot products
    feeding the componentized fit tail (``ops/kernels/circle_fit.fit_tail``,
    ``use_kernel`` as there). Semantics are the buffered path's, including
    the wraparound append of ray n-1 to cluster 0 (ref :169-174), the
    ``max_points`` capacity drop, and the divide-by-full-count centroid."""
    mom, cx, cy, zbar, count, valid, is_circle = _segment_fit_inputs(
        ranges, min_range, max_range, max_clusters, max_points,
        std_threshold_deg, margins)
    with stage("perception.circle_fit", ranges.device):
        center, radius, okf = cfk.fit_tail(mom, cx, cy, zbar, count, valid,
                                           use_kernel=use_kernel)
    ok = is_circle & okf & (radius <= max_radius)
    return _compact(center, ok)


def detect_landmarks(ranges, min_range, max_range,
                     max_clusters: int = 16, max_points: int = 64,
                     max_radius: float = 1.0,
                     segmented: bool | None = None,
                     use_kernel: bool | None = None,
                     margins: dict | None = None) -> Detections:
    """Full perception stage for scans ``ranges (..., n)``.

    ``segmented=None`` -> True: the segment-reduction path (no point
    buffer), whose fit is the tail kernel of ``ops/kernels/circle_fit``.
    ``segmented=False`` is the buffered path (``cluster_scan`` ->
    ``classify_clusters`` -> ``fit_circles``): the parity oracle, and the
    path for users who need the ``Clusters`` buffer itself; its fit is
    that module's whole-fit kernel. ``use_kernel`` routes either as the
    package rule says (``ops/kernels/__init__.py``). ``margins`` (a dict,
    diagnostics) receives the smallest distances of a split decision and a
    circle decision to their thresholds."""
    if segmented is None or segmented:
        return _detect_segmented(ranges, min_range, max_range,
                                 max_clusters, max_points, max_radius,
                                 margins=margins, use_kernel=use_kernel)
    clusters = cluster_scan(ranges, min_range, max_range,
                            max_clusters=max_clusters, max_points=max_points,
                            margins=margins)
    is_circle = classify_clusters(clusters, margins=margins)
    fits = fit_circles(clusters, use_kernel=use_kernel)
    ok = is_circle & fits.valid & (fits.radius <= max_radius)
    return _compact(fits.center, ok)
