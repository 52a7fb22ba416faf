"""Lidar scan clustering as fixed-shape tensor ops (port of
``shermbot_navigation_tpu.ops.clustering``), batch-first: every function
takes leading batch dimensions (``ranges (..., n)``, ``Clusters.points
(..., C, P, 2)``) where the JAX package is vmapped.

Reproduced semantics of the reference ``clusterPoints``
(``nuslam/src/circle_fit_library.cpp:136-206``), as in the JAX package:

- points with range outside ``[min_range, max_range]`` are skipped and do
  NOT split the cluster they sit inside (ref :148-153);
- an in-range ray ``i`` closes its cluster iff ``|r[i] - r[i+1]| >= 0.04``
  where ``i+1`` wraps and may be out-of-range (ref :155-159, :185-196);
- clusters are emitted in close order; the trailing still-open cluster is
  dropped, except that when ray n-1 is in range and does not split, that
  single point is appended to cluster 0 (ref :169-174);
- point coordinates use integer-degree ray angles in the body frame;
- clusters with fewer than 3 points are marked invalid.

Forms taken where the JAX package used a TPU lowering device: the per-ray
position and the last point of a cluster are read with ``gather`` (JAX:
one-hot masked sums), and the point buffer is filled with ``scatter_``
(JAX: a ``(C*P, n)`` one-hot matmul). Member slots are unique, overflow
rows go to a dump row that is dropped, and empty slots stay zero, so the
results are the same.

``_segment_fit_inputs`` is the segmented perception path's front end
(``landmark_detection``) up to the circle fit, in plain tensor ops: the
plain version of the kernel ``ops/kernels/perception.fit_inputs``, which
imports it from here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se2

SPLIT_THRESHOLD = 0.04  # meters, ref circle_fit_library.cpp:142


class Clusters(NamedTuple):
    """Padded cluster set.

    ``points``: (..., C, P, 2) body-frame xy, zero-padded.
    ``counts``: (..., C) int32 number of valid points per cluster slot
    (not clamped to P: overflow rows are dropped from the buffer only).
    ``valid``:  (..., C) cluster slot holds a real cluster with >= 3 points.
    """

    points: torch.Tensor
    counts: torch.Tensor
    valid: torch.Tensor


def _scan_membership(ranges, min_range, max_range, max_clusters: int,
                     threshold: float, margins: dict | None = None):
    """Shared clustering front end: per-ray membership, cluster id,
    within-cluster position, per-cluster counts, plus the wraparound
    bookkeeping (ref :148-174). Returns
    ``(pts, member, cid, pos, counts, num_closed, wrap_move)`` where
    ``member``/``counts`` are BEFORE the wraparound append of ray n-1.

    ``margins`` (a dict, diagnostics) receives ``"split"``: the smallest
    ``| |r[i] - r[i+1]| - threshold |`` over in-range rays, a tensor."""
    n = ranges.shape[-1]
    dt = ranges.dtype
    dev = ranges.device
    idx = torch.arange(n, device=dev)

    in_range = (ranges >= min_range) & (ranges <= max_range)
    nxt = torch.roll(ranges, -1, dims=-1)
    jump = torch.abs(ranges - nxt)
    split = in_range & (jump >= threshold)
    if margins is not None:
        inf = torch.full_like(jump, float("inf"))
        margins["split"] = torch.where(
            in_range, torch.abs(jump - threshold), inf).min()

    # cluster id = number of splits strictly before this ray
    split_i = split.to(torch.int32)
    cum = torch.cumsum(split_i, dim=-1, dtype=torch.int32)
    cid = cum - split_i                            # exclusive cumsum
    num_closed = cum[..., -1]

    # trailing open cluster (id == num_closed) is dropped...
    member = in_range & (cid < num_closed[..., None])
    # ...except the wraparound single-point move of ray n-1 into cluster 0
    wrap_move = in_range[..., n - 1] & ~split[..., n - 1] & (num_closed > 0)
    member = member & ~((idx == n - 1) & wrap_move[..., None])

    # body-frame points at integer-degree angles (ref :161-163)
    ang = se2.deg2rad(idx.to(dt) * (360.0 / n))
    pts = torch.stack([ranges * torch.cos(ang), ranges * torch.sin(ang)],
                      dim=-1)

    # position within cluster: per-cluster running count, read at the
    # ray's own (clamped) cluster with a gather
    slots = torch.arange(max_clusters, device=dev)
    onehot = ((cid[..., None] == slots) & member[..., None]).to(torch.int32)
    run = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    cid_c = torch.clamp(cid, 0, max_clusters - 1).long()
    pos = torch.gather(run, -1, cid_c[..., None])[..., 0]

    counts = torch.sum(onehot, dim=-2, dtype=torch.int32)
    return pts, member, cid, pos, counts, num_closed, wrap_move


def cluster_scan(ranges, min_range, max_range,
                 max_clusters: int = 16, max_points: int = 64,
                 threshold: float = SPLIT_THRESHOLD,
                 margins: dict | None = None) -> Clusters:
    """Cluster scans ``ranges (..., n)`` -- ray k at body angle k*(360/n)
    deg -- into ``Clusters`` with points ``(..., C, P, 2)``."""
    n = ranges.shape[-1]
    dev = ranges.device
    C, P = max_clusters, max_points
    pts, member, cid, pos, counts, num_closed, wrap_move = _scan_membership(
        ranges, min_range, max_range, C, threshold, margins)

    # scatter into the padded buffer; rays that are no member, or overflow
    # a cluster's P rows or the C slots, land in dump row C*P (dropped)
    flat_idx = torch.where(member & (cid < C) & (pos < P),
                           cid * P + pos,
                           torch.full_like(cid, C * P)).long()
    buf = torch.zeros((*ranges.shape[:-1], C * P + 1, 2), dtype=pts.dtype,
                      device=dev)
    buf.scatter_(-2, flat_idx[..., None].expand(*flat_idx.shape, 2), pts)
    points = buf[..., :C * P, :].reshape(*ranges.shape[:-1], C, P, 2)

    # append ray n-1 to the end of cluster 0 on wrap (ref :169-174); a full
    # cluster 0 has its last stored row overwritten
    c0 = torch.clamp_max(counts[..., 0], P - 1)
    at_c0 = torch.arange(P, device=dev) == c0[..., None]
    row0 = torch.where((wrap_move[..., None] & at_c0)[..., None],
                       pts[..., n - 1, :][..., None, :], points[..., 0, :, :])
    points = torch.cat([row0[..., None, :, :], points[..., 1:, :, :]],
                       dim=-3)
    counts = torch.cat([(counts[..., 0] + wrap_move.to(torch.int32)
                         )[..., None], counts[..., 1:]], dim=-1)

    slot = torch.arange(C, device=dev)
    valid = (slot < num_closed[..., None]) & (counts >= 3)
    return Clusters(points=points, counts=counts, valid=valid)


def classify_clusters(clusters: Clusters, std_threshold_deg: float = 10.0,
                      margins: dict | None = None):
    """Circle / not-circle via inscribed-angle statistics, over all
    cluster slots (ref ``classifyCluster``, circle_fit_library.cpp:208-250).

    For each cluster: endpoints p2 (first) and p3 (last); for every
    interior point p1 the angle ``atan2(num, den)`` (ref :221-224) in
    degrees; circle iff the population stddev of those angles is < 10
    degrees. Clusters with < 3 points are non-circles.

    ``margins`` (a dict, diagnostics) receives ``"std"``: the smallest
    ``|std - threshold|`` over valid clusters, a tensor."""
    pts, counts, valid = clusters
    P = pts.shape[-2]
    dt = pts.dtype
    dev = pts.device
    pos = torch.arange(P, device=dev)
    m = counts[..., None]

    p2 = pts[..., 0, :]                                  # (..., C, 2) first
    last = torch.clamp(counts - 1, 0, P - 1).long()
    p3 = torch.gather(pts, -2, last[..., None, None].expand(
        *last.shape, 1, 2))[..., 0, :]                   # (..., C, 2) last

    interior = (pos >= 1) & (pos <= m - 2)               # (..., C, P)

    x1, y1 = pts[..., 0], pts[..., 1]                    # p1 = each point
    x2, y2 = p2[..., None, 0], p2[..., None, 1]
    x3, y3 = p3[..., None, 0], p3[..., None, 1]
    num = y2 * (x1 - x3) + y1 * (x3 - x2) + y3 * (x2 - x1)
    den = (x2 - x1) * (x1 - x3) + (y2 - y1) * (y1 - y3)
    angles = se2.rad2deg(torch.atan2(num, den))          # (..., C, P)

    zero = torch.zeros((), dtype=dt, device=dev)
    cnt = torch.clamp_min(torch.sum(interior, dim=-1), 1).to(dt)
    mean = torch.sum(torch.where(interior, angles, zero), dim=-1) / cnt
    var = torch.sum(torch.where(interior, (angles - mean[..., None]) ** 2,
                                zero), dim=-1) / cnt
    std = torch.sqrt(var)
    real = valid & (counts >= 3)
    if margins is not None:
        inf = torch.full_like(std, float("inf"))
        margins["std"] = torch.where(
            real, torch.abs(std - std_threshold_deg), inf).min()
    return real & (std < std_threshold_deg)


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
