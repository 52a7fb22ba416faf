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
(JAX: one-hot matmuls); in the plain version the segment sums stay one-hot
``torch.matmul`` products (full f32, TF32 is off package-wide), because a
matmul sums in a fixed order where ``scatter_add`` on the card uses
atomics and would make the perception stage differ in ulps from run to
run. On the card the segmented path's front end is one kernel
(``ops/kernels/perception``), which adds each slot's rays in ray order,
the order cuBLAS's products mostly take there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.tracing import stage
from .circle_fit import fit_circles
# _segment_fit_inputs, the plain front end, lives below both this module and
# its kernel's wrapper; it is named here for the segmented path's callers
from .clustering import (_segment_fit_inputs, classify_clusters,  # noqa: F401
                         cluster_scan)
from .kernels import circle_fit as cfk
from .kernels import perception as pk


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


def _detect_segmented(ranges, min_range, max_range, max_clusters: int,
                      max_points: int, max_radius: float,
                      std_threshold_deg: float = 10.0,
                      margins: dict | None = None) -> Detections:
    """The whole perception stage as SEGMENT REDUCTIONS over rays: no
    ``(C, P, 2)`` point buffer; the quantities the buffered path reduces
    from the buffer (endpoints, inscribed angles, centroid, moments) come
    straight from the rays (``ops/kernels/perception.fit_inputs``: one
    kernel on the card, the ``(C, n)`` one-hot products of
    :func:`_segment_fit_inputs` on the CPU) and feed the componentized fit
    tail (``ops/kernels/circle_fit.fit_tail``). Semantics are the buffered
    path's, including the wraparound append of ray n-1 to cluster 0 (ref
    :169-174), the ``max_points`` capacity drop, and the divide-by-full-count
    centroid."""
    with stage("perception.fit_inputs", ranges.device):
        mom, cx, cy, zbar, count, valid, is_circle = pk.fit_inputs(
            ranges, min_range, max_range, max_clusters, max_points,
            std_threshold_deg, margins)
    with stage("perception.circle_fit", ranges.device):
        center, radius, okf = cfk.fit_tail(mom, cx, cy, zbar, count, valid)
    ok = is_circle & okf & (radius <= max_radius)
    return _compact(center, ok)


def detect_landmarks(ranges, min_range, max_range,
                     max_clusters: int = 16, max_points: int = 64,
                     max_radius: float = 1.0,
                     segmented: bool | None = None,
                     margins: dict | None = None) -> Detections:
    """Full perception stage for scans ``ranges (..., n)``.

    ``segmented=None`` -> True: the segment-reduction path (no point
    buffer), whose fit is the tail kernel of ``ops/kernels/circle_fit``.
    ``segmented=False`` is the buffered path (``cluster_scan`` ->
    ``classify_clusters`` -> ``fit_circles``): the parity oracle, and the
    path for users who need the ``Clusters`` buffer itself; its fit is
    that module's whole-fit kernel. ``margins`` (a dict, diagnostics)
    receives the smallest distances of a split decision and a circle
    decision to their thresholds."""
    if segmented is None or segmented:
        return _detect_segmented(ranges, min_range, max_range,
                                 max_clusters, max_points, max_radius,
                                 margins=margins)
    clusters = cluster_scan(ranges, min_range, max_range,
                            max_clusters=max_clusters, max_points=max_points,
                            margins=margins)
    is_circle = classify_clusters(clusters, margins=margins)
    fits = fit_circles(clusters)
    ok = is_circle & fits.valid & (fits.radius <= max_radius)
    return _compact(fits.center, ok)
