"""The per-cluster circle fit in one kernel: moments and eigen-chain
(``csrc/circle_fit.cu``), with its plain versions.

Two wrappers, one per perception path:

* :func:`circle_fit_raw` -- points ``(..., P, 2)``, counts, valid ->
  centre, radius, ok and the moments it computed on the way (the buffered
  path, ``ops/circle_fit.fit_circles``). Plain version:
  ``circle_moments._reference_raw`` followed by :func:`_fit_tail_c`.
* :func:`fit_tail` -- moments, centroid, zbar, count, valid -> centre,
  radius, ok (the segmented path, ``ops/landmark_detection``, whose
  moments are one-hot segment sums). Plain version: :func:`_fit_tail_c`.

:func:`_fit_tail_c` is the port of the JAX ``_fit_tail_c``
(``shermbot_navigation_tpu/ops/circle_fit.py``), op for op; the kernel
repeats its operations one rounding at a time and gives its bits. On the
TPU the moments were a Pallas kernel (``circle_moments_raw``) and XLA fused
the chain behind it; in eager PyTorch the chain is ~8,200 elementwise
launches a call, so here it is one kernel.

Both wrappers follow the package rule (``ops/kernels/__init__.py``): the
kernel for CUDA tensors, the plain version for CPU tensors, and on a CUDA
operand the kernel does not take (not f32) a raise, never a fallback.
``circle_fit_raw.launches`` and ``fit_tail.launches`` count kernel
launches.
"""

from __future__ import annotations

import torch

from ..smallalg import eigh4_jacobi_c, solve4_c
from . import require, wants_kernel
from ._build import check, library, stream_handle
from .circle_moments import _reference_raw

# Column k of a row-major 16-entry moment row in the 10 distinct moments
# (zz, zx, zy, z, xx, xy, x, yy, y, n): the segmented path's layout.
DISTINCT = (0, 1, 2, 3, 1, 4, 5, 6, 2, 5, 7, 8, 3, 6, 8, 9)


def _circle_from_A(A0_, A1, A2, A3):
    """Circle parameters from the algebraic vector (ref :107-110):
    ``(a, b, radius)`` relative to the centroid."""
    A0 = torch.where(torch.abs(A0_) < 1e-30, torch.full_like(A0_, 1e-30),
                     A0_)
    a = -A1 / (2.0 * A0)
    b = -A2 / (2.0 * A0)
    R2 = (A1 ** 2 + A2 ** 2 - 4.0 * A0_ * A3) / (4.0 * A0 * A0)
    return a, b, torch.sqrt(torch.clamp_min(R2, 0.0))


def _fit_tail_c(mc, cx, cy, z_bar, count, valid, trace=None):
    """Fully-componentized eigen-chain (ref :50-110): ``mc`` is a length-16
    list of batched moment components (row-major); no 4x4 tensor is built.
    Op for op the JAX ``_fit_tail_c``; the plain version of the tail kernel.
    ``trace`` (a list) receives ``(name, tensor)`` for every intermediate
    the kernel's trace entry writes, in its order (:func:`trace_names`)."""
    dt = mc[0].dtype
    rec = (lambda name, v: trace.append((name, v))) if trace is not None \
        else (lambda name, v: None)
    lam, V = eigh4_jacobi_c(mc, trace=None if trace is None else
                            _Prefixed(trace, "eigh_M."))
    lam = [torch.clamp_min(l, 0.0) for l in lam]
    s = [torch.sqrt(l) for l in lam]
    for k in range(4):
        rec(f"s[{k}]", s[k])
    sigma4 = s[0]

    # branch a: rank-deficient -> null vector (ref :78-80)
    A_null = [V[i][0] for i in range(4)]

    # branch b: Y = V S V^T (symmetric -- 10 unique comps, mirrored)
    Y = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Y[i][j] = Y[j][i] = sum(V[i][k] * s[k] * V[j][k]
                                    for k in range(4))
            rec(f"Y[{i}][{j}]", Y[i][j])
    # Y Hinv with the closed-form Hinv (0.5 anti-diag corners, identity
    # middle, -2 z_bar at [3,3]) -- ref :55-61
    YH = [[0.5 * Y[i][3], Y[i][1], Y[i][2],
           0.5 * Y[i][0] - 2.0 * z_bar * Y[i][3]] for i in range(4)]
    # Q = (Y Hinv) Y, symmetric
    Q = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            Q[i][j] = Q[j][i] = sum(YH[i][k] * Y[k][j] for k in range(4))
            rec(f"Q[{i}][{j}]", Q[i][j])

    eq, EV = eigh4_jacobi_c([Q[i][j] for i in range(4) for j in range(4)],
                            trace=None if trace is None else
                            _Prefixed(trace, "eigh_Q."))
    # smallest POSITIVE eigenvalue; default column 0 if none positive
    # (ref :81-104) -- running component argmin, strict < keeps the first
    inf = torch.full_like(eq[0], float("inf"))
    big = [torch.where(e > 0, e, inf) for e in eq]
    best = big[0]
    Astar = [EV[i][0] for i in range(4)]
    for k in (1, 2, 3):
        take = big[k] < best
        best = torch.where(take, big[k], best)
        Astar = [torch.where(take, EV[i][k], Astar[i]) for i in range(4)]
    for i in range(4):
        rec(f"Astar[{i}]", Astar[i])

    # A = solve(Y, Astar); guard the solve for the untaken branch
    rank_def = sigma4 < 1e-12
    rec("rank_deficient", rank_def.to(dt))
    bump = rank_def.to(dt)
    Ysafe = [[Y[i][j] + bump * (1.0 if i == j else 0.0) for j in range(4)]
             for i in range(4)]
    A_gen = solve4_c(Ysafe, Astar)
    for i in range(4):
        rec(f"A_solve[{i}]", A_gen[i])
    A = [torch.where(rank_def, A_null[i], A_gen[i]) for i in range(4)]
    for i in range(4):
        rec(f"A[{i}]", A[i])

    a, b, radius = _circle_from_A(*A)
    ccx = a + cx
    ccy = b + cy
    ok = (valid & (count >= 4) & torch.isfinite(ccx) & torch.isfinite(ccy)
          & torch.isfinite(radius))
    rec("center_x", ccx)
    rec("center_y", ccy)
    rec("radius", radius)
    rec("ok", ok.to(dt))
    return torch.stack([ccx, ccy], dim=-1), radius, ok


class _Prefixed:
    """A trace list seen through a name prefix."""

    def __init__(self, out: list, prefix: str):
        self.out, self.prefix = out, prefix

    def append(self, item):
        self.out.append((self.prefix + item[0], item[1]))


def trace_names() -> list:
    """Names of the tail's intermediates in the trace entry's order."""
    names = []
    _fit_tail_c([torch.zeros(())] * 16, *(torch.zeros(()),) * 3,
                torch.zeros((), dtype=torch.int32),
                torch.zeros((), dtype=torch.bool), trace=names)
    return [n for n, _ in names]


def components(m):
    """The 16 row-major moment components of ``m (..., 16)`` or of the 10
    distinct ones ``m (..., 10)``, as a list of ``(...,)`` views."""
    if m.shape[-1] == 16:
        return [m[..., k] for k in range(16)]
    if m.shape[-1] == 10:
        return [m[..., k] for k in DISTINCT]
    raise ValueError(f"moments must be (..., 16) or (..., 10), got "
                     f"{tuple(m.shape)}")


def _count(lead):
    C = 1
    for d in lead:
        C *= d
    return C


def _outputs(C, dev):
    return (torch.empty((C, 2), dtype=torch.float32, device=dev),
            torch.empty((C,), dtype=torch.float32, device=dev),
            torch.empty((C,), dtype=torch.bool, device=dev))


def _flat(t, lead, dtype, name, what):
    """``t`` with shape ``lead`` on the operand's device, flattened,
    contiguous, in ``dtype`` (integer counts are cast; anything else must
    already be ``dtype``)."""
    if tuple(t.shape) != tuple(lead):
        require(False, name, f"{what} must be {tuple(lead)}, got "
                             f"{tuple(t.shape)}")
    return t.reshape(-1).to(dtype).contiguous()


def circle_fit_raw(points, counts, valid):
    """``points (..., P, 2)``, ``counts (...,)`` integer, ``valid (...,)``
    bool -> ``(center (..., 2), radius (...,), ok (...,), m16 (..., 16),
    centroid (..., 2), zbar (...,))``: the whole fit of every cluster slot
    (``ok``: valid, >= 4 points and a finite result) and the moments
    behind it (row-major, as ``circle_moments_raw`` gives them). Leading
    batch dimensions are flattened into the kernel's cluster axis."""
    name = "circle_fit"
    if not wants_kernel(points):
        mc, cx, cy, zbar = _reference_raw(points, counts)
        center, radius, ok = _fit_tail_c(mc, cx, cy, zbar, counts, valid)
        return (center, radius, ok, torch.stack(mc, dim=-1),
                torch.stack([cx, cy], dim=-1), zbar)
    lead = points.shape[:-2]
    P = points.shape[-2]
    dev = points.device
    if not (points.dim() >= 3 and points.shape[-1] == 2 and P >= 1
            and points.dtype == torch.float32):
        require(False, name, f"points must be float32 (..., P >= 1, 2), got "
                             f"{points.dtype} {tuple(points.shape)}")
    if not (counts.device == dev and valid.device == dev
            and not counts.dtype.is_floating_point
            and counts.dtype != torch.bool and valid.dtype == torch.bool):
        require(False, name, f"counts must be integer and valid bool on "
                             f"{dev}, got {counts.dtype} on {counts.device},"
                             f" {valid.dtype} on {valid.device}")
    C = _count(lead)
    require(C >= 1, name, "needs at least one cluster")
    pts = points.reshape(C, P, 2).contiguous()
    cnt = _flat(counts, lead, torch.int32, name, "counts")
    val = _flat(valid, lead, torch.bool, name, "valid")
    m16 = torch.empty((C, 16), dtype=torch.float32, device=dev)
    cent = torch.empty((C, 2), dtype=torch.float32, device=dev)
    zbar = torch.empty((C,), dtype=torch.float32, device=dev)
    center, radius, ok = _outputs(C, dev)
    # float2 loads of the points, float4 stores of the moment rows
    require(pts.data_ptr() % 8 == 0, name, "points must be 8-byte aligned")
    check(name, library().circle_fit(
        pts.data_ptr(), cnt.data_ptr(), val.data_ptr(), m16.data_ptr(),
        cent.data_ptr(), zbar.data_ptr(), center.data_ptr(),
        radius.data_ptr(), ok.data_ptr(), C, P, stream_handle(dev)))
    circle_fit_raw.launches += 1
    return (center.reshape(*lead, 2), radius.reshape(lead), ok.reshape(lead),
            m16.reshape(*lead, 16), cent.reshape(*lead, 2),
            zbar.reshape(lead))


circle_fit_raw.launches = 0


def fit_tail(m, cx, cy, zbar, count, valid):
    """The fit from the moments: ``m (..., 16)`` row-major or ``(..., 10)``
    the distinct ones (zz, zx, zy, z, xx, xy, x, yy, y, n; a view at a row
    stride, such as columns of a wider tensor, is read in place),
    ``cx``, ``cy``, ``zbar (...,)``, ``count (...,)`` integer, ``valid
    (...,)`` bool -> ``(center (..., 2), radius (...,), ok (...,))``."""
    name = "circle_fit_tail"
    if not wants_kernel(m):
        return _fit_tail_c(components(m), cx, cy, zbar, count, valid)
    lead = m.shape[:-1]
    K = m.shape[-1]
    dev = m.device
    if not (K in (16, 10) and m.dtype == torch.float32):
        require(False, name, f"moments must be float32 (..., 16) or "
                             f"(..., 10), got {m.dtype} {tuple(m.shape)}")
    for what, t in (("cx", cx), ("cy", cy), ("zbar", zbar)):
        if not (t.dtype == torch.float32 and t.device == dev):
            require(False, name, f"{what} must be float32 on {dev}, got "
                                 f"{t.dtype} on {t.device}")
    if not (count.device == dev and valid.device == dev
            and not count.dtype.is_floating_point
            and count.dtype != torch.bool and valid.dtype == torch.bool):
        require(False, name, f"count must be integer and valid bool on "
                             f"{dev}, got {count.dtype} on {count.device}, "
                             f"{valid.dtype} on {valid.device}")
    C = _count(lead)
    require(C >= 1, name, "needs at least one cluster")
    rows = m.reshape(C, K)                 # a view where the strides allow
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    flat = [_flat(t, lead, torch.float32, name, what)
            for what, t in (("cx", cx), ("cy", cy), ("zbar", zbar))]
    cnt = _flat(count, lead, torch.int32, name, "count")
    val = _flat(valid, lead, torch.bool, name, "valid")
    center, radius, ok = _outputs(C, dev)
    check(name, library().circle_fit_tail(
        rows.data_ptr(), rows.stride(0), K, *(t.data_ptr() for t in flat),
        cnt.data_ptr(), val.data_ptr(), center.data_ptr(), radius.data_ptr(),
        ok.data_ptr(), C, stream_handle(dev)))
    fit_tail.launches += 1
    return center.reshape(*lead, 2), radius.reshape(lead), ok.reshape(lead)


fit_tail.launches = 0


def trace(m16, cx, cy, zbar, live: bool):
    """The tail kernel's intermediates for ONE cluster (16 moments, its
    centroid and zbar as 0-d or 1-element f32 CUDA tensors; ``live`` =
    valid and >= 4 points), in :func:`trace_names` order; card only, a
    diagnostic beside the plain version's ``_fit_tail_c(..., trace=...)``."""
    dev = m16.device
    require(dev.type == "cuda", "circle_fit_trace", "the trace runs on the "
                                                    "card")
    inp = torch.cat([m16.reshape(16), cx.reshape(1), cy.reshape(1),
                     zbar.reshape(1)]).float().contiguous()
    out = torch.full((len(trace_names()),), float("nan"), device=dev)
    check("circle_fit_trace", library().circle_fit_trace(
        inp.data_ptr(), int(live), out.data_ptr(), stream_handle(dev)))
    return out


def chain_probe(staged, iters: int):
    """Launch the tail's latency probe: one warp, lane ``l`` fitting the
    cluster of row ``l`` of ``staged (32, 19)`` (16 moments, cx, cy, zbar)
    ``iters`` times, each fit waiting for the last. The caller times it
    with CUDA events; card only."""
    dev = staged.device
    require(dev.type == "cuda" and tuple(staged.shape) == (32, 19)
            and staged.dtype == torch.float32, "circle_fit_probe",
            "needs a (32, 19) float32 tensor on the card")
    out = torch.empty(32, device=dev)
    check("circle_fit_probe", library().circle_fit_probe(
        staged.contiguous().data_ptr(), out.data_ptr(), iters,
        stream_handle(dev)))
    return out
