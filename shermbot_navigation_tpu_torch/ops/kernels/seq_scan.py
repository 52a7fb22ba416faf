"""The deferred tick's whole measurement scan, known or unknown association
(port of ``shermbot_navigation_tpu.ops.pallas.seq_scan``).

For each of the tick's M measurements, in order: the slot -- the known id
(an id outside [0, N) is a full no-op) or, with unknown association, the
reference's first-hit Mahalanobis gates against the carried own-block
diagonal (match, skip, new, or overflow, which stops the rest of the
tick); the Kalman update of ``mean_r``, ``cov_rr``, ``mm2``, ``rm6`` and
``diag4`` against a grid column reconstructed from the frozen grid plus
the tick's earlier ops, or the analytic landmark init; and the op-history
outputs ``Kb``, ``HSb``, ``CRb`` (M, 4, N), ``gb`` and ``kindb`` (M,)
that the grid pass consumes.

On the card the scan is ``csrc/seq_scan.cu``: it replaces the TPU kernel
``deferred_seq_scan`` (``ops/pallas/seq_scan.py``). It is bound by latency
(a serial chain of M small updates on one robot): a measurement costs its
barriers, one exchange of slot g's values and a chain of scalar
arithmetic. The kernel keeps the whole carried state on chip for the
chain, as the TPU kernel kept it in VMEM: the lanes are split over the
CTAs of one thread-block cluster, a thread holds its lanes of every strip
in registers from the first measurement to the last, the robot state is
replicated in every thread (no thread works alone behind a barrier), the
thread's own op history stays in shared memory where it fits, and row g
of the frozen planes (column g by symmetry, PARITY D13) is fetched ahead
by ``cp.async`` into a shared-memory ring. Two cluster barriers a
measurement remain with known association, three with unknown (the
first-hit reduction, an integer minimum). :func:`launch_plan` chooses the
cluster size, the threads, the lanes a thread, the ring depth and where
the history lives, from (N, M) alone; every output is bit-equal across
cluster sizes. B worlds (operands with a leading B) take one launch of B
clusters, one a world. It uses libm-accurate ``atan2f``/``sinf``/``cosf``.
:func:`reference_seq_scan` is the plain version: a twin of the XLA scan
body of the JAX ``_make_sharded_deferred`` at map=1, which reads exact
grid columns.
"""

from __future__ import annotations

import functools
import math

import torch

from . import checked_operands, require, wants_kernel
from ._build import check, library, stream_handle
from ...device import resolve
from ...models.ekf_slam import _inv2x2
from ...ops import se2
from ...parallel.blocked_ekf import _associate_comp, _h5_coeffs

MAX_MEAS = 64   # the CUDA kernel's op-kind masks and packet table
MAX_CLUSTER = 16        # CTAs a cluster (8 is portable, 16 Hopper's most)
MAX_THREADS = 1024
LANE_CHOICES = (1, 2, 4, 8)     # lanes a thread: the kernel's instances
RING_CHOICES = (4, 2, 1)        # row ring depths tried, deepest first
MIN_LANES_PER_CTA = 256         # a CTA with fewer lanes is not worth a CTA
SMEM_PER_CTA = 227 * 1024       # what one block can use on sm_90
STATIC_SMEM = 4096              # the kernel's static shared state, rounded up


def launch_plan(N: int, M: int, known: bool = True,
                cluster: int | None = None, *, batch: int = 1,
                max_active=None) -> dict:
    """How the CUDA kernel is launched for a map of N lanes and M
    measurements: a pure function, the only place the choice is made.

    Returns ``{"cluster", "threads", "lanes", "per_cta", "ring",
    "hist_smem", "smem_bytes"}``: CTA ``c`` of the cluster owns lanes
    ``[c * per_cta, (c + 1) * per_cta)`` and its thread ``t`` the lanes
    ``c * per_cta + t + k * threads`` for ``k < lanes`` (:func:`plan_lanes`
    lists them). ``ring`` is the depth of the row ring (1 with unknown
    association: the row is known only at the decision), ``hist_smem``
    whether the thread's op history (16 M bytes a lane) stays in shared
    memory, ``smem_bytes`` the dynamic shared memory of one CTA.
    ``cluster`` overrides the cluster size (the tests hold the outputs
    bit-equal across sizes); one that cannot hold the map raises
    ``ValueError``.

    The default cluster is the largest power of two up to
    ``MAX_CLUSTER`` that leaves a CTA ``MIN_LANES_PER_CTA`` lanes: the
    scalar chain is replicated in every warp, so few warps a CTA keep it
    at its latency, and unknown association's scoring of every seen lane
    spreads over the CTAs. A launch of ``batch`` worlds runs one cluster a
    world; where the card cannot hold ``batch`` clusters of the default
    size at once (``max_active(plan)``: how many clusters of a plan fit,
    ``cudaOccupancyMaxActiveClusters``), the largest smaller cluster
    whose ``batch`` clusters all fit is taken, if one does (a smaller
    cluster gives each thread more lanes and so holds more of a world in
    the same registers). The outputs do not depend on the choice.
    """
    if N < 1 or not 1 <= M <= MAX_MEAS or batch < 1:
        raise ValueError(f"seq_scan plan: N >= 1, 1 <= M <= {MAX_MEAS} and "
                         f"batch >= 1, got N={N}, M={M}, batch={batch}")
    if cluster is not None:
        return _plan(N, M, known, cluster)
    cluster = 1
    while (cluster < MAX_CLUSTER
           and -(-N // (2 * cluster)) >= MIN_LANES_PER_CTA):
        cluster *= 2
    plan = _plan(N, M, known, cluster)
    if max_active is None or batch == 1 or batch <= max_active(plan):
        return plan
    while cluster > 1:
        cluster //= 2
        try:
            smaller = _plan(N, M, known, cluster)
        except ValueError:
            break
        if batch <= max_active(smaller):
            return smaller
    return plan


def _plan(N: int, M: int, known: bool, cluster: int) -> dict:
    """:func:`launch_plan` for a given cluster size."""
    if cluster not in (1, 2, 4, 8, 16) or cluster > MAX_CLUSTER:
        raise ValueError(f"seq_scan plan: cluster {cluster} is not a power "
                         f"of two up to {MAX_CLUSTER}")
    per_cta = -(-N // cluster)
    # up to 512 threads (128 registers each); above that the kernel has
    # one instance, 1024 threads of 8 lanes, for maps no smaller plan holds
    threads = min(512, -(-per_cta // 32) * 32)
    if threads * LANE_CHOICES[-1] < per_cta:
        threads = MAX_THREADS
    lanes = next((k for k in LANE_CHOICES if threads * k >= per_cta
                  and (threads <= 512 or k == LANE_CHOICES[-1])), None)
    if lanes is None:
        raise ValueError(
            f"seq_scan plan: a cluster of {cluster} CTAs of {threads} "
            f"threads holds {cluster * threads * LANE_CHOICES[-1]} lanes, "
            f"N={N}")
    slot_bytes = 16 * threads * lanes       # one ring slot or one op's history
    budget = (SMEM_PER_CTA - STATIC_SMEM) // slot_bytes
    rings = [d for d in RING_CHOICES if d <= M or d == 1] if known else [1]
    ring = next((d for d in rings if d + M <= budget), None)
    hist_smem = ring is not None
    if ring is None:
        ring = next((d for d in rings if d <= budget), None)
        if ring is None:
            raise ValueError(f"seq_scan plan: no room for a row of "
                             f"{slot_bytes} bytes")
    return {"cluster": cluster, "threads": threads, "lanes": lanes,
            "per_cta": per_cta, "ring": ring, "hist_smem": hist_smem,
            "smem_bytes": slot_bytes * (ring + (M if hist_smem else 0))}


@functools.cache
def _max_active(cluster, threads, lanes, ring, hist_smem, m) -> int:
    n = library().seq_scan_max_clusters(cluster, threads, lanes, ring,
                                        int(hist_smem), m)
    if n < 0:
        check("seq_scan_max_clusters", -n)
    return n


def max_active_clusters(plan: dict, M: int) -> int:
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters`` on the kernel instance the plan
    launches); card only."""
    return _max_active(plan["cluster"], plan["threads"], plan["lanes"],
                       plan["ring"], plan["hist_smem"], M)


def plan_lanes(plan: dict, N: int) -> torch.Tensor:
    """The lane each (CTA, k, thread) of ``plan`` owns, -1 for an empty
    slot: ``(cluster, lanes, threads)`` int64, the kernel's own rule."""
    c = torch.arange(plan["cluster"])[:, None, None]
    k = torch.arange(plan["lanes"])[None, :, None]
    t = torch.arange(plan["threads"])[None, None, :]
    local = k * plan["threads"] + t
    n = c * plan["per_cta"] + local
    return torch.where((local < plan["per_cta"]) & (n < N), n, -1)


def _col_at(mm0p, Kb, HSb, CRb, gb, kb, j, g, g1, lane):
    """Grid column g (comps (4, N)) after the tick's ops 0..j-1: the frozen
    column, minus earlier rank-2 updates, with earlier init overwrites."""
    col = mm0p.index_select(2, g1)[:, :, 0]            # col[c][n] = mm0p[c, n, g]
    hs_g = HSb.index_select(2, g1)[:, :, 0]            # (M, 4)
    cr_g = CRb.index_select(2, g1)[:, :, 0]
    for i in range(j):
        is_upd = kb[i] == 1
        is_init = kb[i] == 2
        s_i = gb[i]
        k, h = Kb[i], hs_g[i]
        corr = torch.stack([k[0] * h[0] + k[1] * h[1], k[0] * h[2] + k[1] * h[3],
                            k[2] * h[0] + k[3] * h[1], k[2] * h[2] + k[3] * h[3]])
        col = torch.where(is_upd, col - corr, col)
        # init at s_i == g: the whole column is the cross strip, comp
        # (p, q) of the column being comp (q, p) of the stored strip
        col = torch.where(is_init & (s_i == g), CRb[i][[0, 2, 1, 3]], col)
        # init at another slot: row s_i of this column <- strip column g
        hit_row = (lane == s_i)[None, :]
        col = torch.where(is_init & (s_i != g) & hit_row, cr_g[i][:, None],
                          col)
    return col


def _gate_margin(dist, any_hit, d_first, match_gate, new_gate):
    """Smallest relative distance of this measurement's scores to a gate:
    every finite lane distance to ``new_gate`` and, on a hit, the first
    hit's distance to ``match_gate``. A rounding difference can flip a
    decision only where this is near 0."""
    finite = torch.isfinite(dist)
    to_new = torch.where(finite, (dist - new_gate).abs() / new_gate,
                         torch.full_like(dist, float("inf"))).amin()
    to_match = torch.where(any_hit, (d_first - match_gate).abs() / match_gate,
                           torch.full_like(d_first, float("inf")))
    return torch.minimum(to_new, to_match)


def reference_seq_scan(mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p,
                       zs, valid, ids, R, *, known: bool = True,
                       match_gate: float = 0.01, new_gate: float = 60.0,
                       wrap_innovation: bool = False,
                       symmetrize: bool = True, gate_margins=None):
    """Plain PyTorch scan (f32 or f64). Arguments and returns as
    :func:`deferred_seq_scan`; every selection is a ``torch.where``, as in
    the XLA body, so no value goes back to the host.

    ``gate_margins`` (a list, unknown association only) receives one 0-dim
    tensor per measurement: its smallest relative margin to either gate
    (:func:`_gate_margin`; inf for an inert measurement)."""
    M = zs.shape[0]
    N = mm2.shape[1]
    dtype, dev = mm2.dtype, mm2.device
    lane = torch.arange(N, device=dev)
    Kb = torch.zeros((M, 4, N), dtype=dtype, device=dev)
    HSb = torch.zeros_like(Kb)
    CRb = torch.zeros_like(Kb)
    gb = torch.zeros(M, dtype=torch.int32, device=dev)
    kb = torch.zeros(M, dtype=torch.int32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for j in range(M):
        z = zs[j]
        if known:
            g = ids[j].long()
            v = valid[j] & (g >= 0) & (g < N)
            g1 = g.clamp(0, N - 1).reshape(1)
            seen_g = seen.index_select(0, g1)[0]
            is_new = v & ~seen_g
            do_update = v & seen_g
        else:
            # reference first-hit gating against the carried diag4
            # (blocked_ekf.py:756-772 of the JAX package)
            act = valid[j] & ~stopped
            any_hit, first, d_first, dist = _associate_comp(
                mean_r, mm2, cov_rr, rm6, seen, z, R, diag4,
                new_gate=new_gate, wrap_innovation=wrap_innovation)
            no_seen = n_seen == 0
            cap_full = n_seen >= N
            is_match = act & ~no_seen & any_hit & (d_first < match_gate)
            want_new = act & (no_seen | ~any_hit)
            is_new = want_new & ~cap_full
            stopped = stopped | (want_new & cap_full)
            do_update = is_match
            g = torch.where(is_match, first,
                            torch.clamp_max(n_seen, N - 1).long())
            g1 = g.reshape(1)
            if gate_margins is not None:
                gate_margins.append(torch.where(
                    act, _gate_margin(dist, any_hit, d_first, match_gate,
                                      new_gate),
                    torch.full_like(d_first, float("inf"))))

        # ---- measurement geometry off the sequential means ----
        mj = mm2.index_select(1, g1)[:, 0]
        H5, z_hat = _h5_coeffs(mean_r, mj)
        dz = z - z_hat
        if wrap_innovation:
            dz = torch.stack([dz[0], se2.normalize_angle(dz[1])])

        # ---- UPDATE branch ----
        rm_j = rm6.index_select(1, g1)[:, 0].reshape(3, 2)
        SHt_r = torch.cat([cov_rr, rm_j], dim=1) @ H5.T             # (3, 2)
        col4 = _col_at(mm0p, Kb, HSb, CRb, gb, kb, j, g, g1, lane)
        s4 = torch.stack([
            rm6[0 + p] * H5[q, 0] + rm6[2 + p] * H5[q, 1]
            + rm6[4 + p] * H5[q, 2]
            + col4[p * 2 + 0] * H5[q, 3] + col4[p * 2 + 1] * H5[q, 4]
            for p in range(2) for q in range(2)])                   # (4, N)
        SHt_j = s4.index_select(1, g1)[:, 0].reshape(2, 2)
        psi = H5 @ torch.cat([SHt_r, SHt_j], dim=0) + R
        psi_inv = _inv2x2(psi)
        K_r = SHt_r @ psi_inv
        k4 = torch.stack([
            s4[p * 2 + 0] * psi_inv[0, r] + s4[p * 2 + 1] * psi_inv[1, r]
            for p in range(2) for r in range(2)])
        upd_mean_r = mean_r + K_r @ dz
        upd_mean_r = torch.cat([se2.normalize_angle(upd_mean_r[:1]),
                                upd_mean_r[1:]])
        upd_mm2 = mm2 + torch.stack([k4[0] * dz[0] + k4[1] * dz[1],
                                     k4[2] * dz[0] + k4[3] * dz[1]])
        upd_cov_rr = cov_rr - K_r @ SHt_r.T
        if symmetrize:
            upd_cov_rr = 0.5 * (upd_cov_rr + upd_cov_rr.T)
        upd_rm6 = rm6 - torch.stack([
            K_r[i, 0] * s4[p * 2 + 0] + K_r[i, 1] * s4[p * 2 + 1]
            for i in range(3) for p in range(2)])

        # ---- INIT branch: strips only; grid writes buffered ----
        th, x, y = mean_r[0], mean_r[1], mean_r[2]
        a = z[1] + th
        r_ = z[0]
        sa, ca = torch.sin(a), torch.cos(a)
        m_new = torch.stack([x + r_ * ca, y + r_ * sa])
        one, zero = torch.ones_like(r_), torch.zeros_like(r_)
        Gx = torch.stack([torch.stack([-r_ * sa, one, zero]),
                          torch.stack([r_ * ca, zero, one])])
        Gz = torch.stack([torch.stack([ca, -r_ * sa]),
                          torch.stack([sa, r_ * ca])])
        cross4 = torch.stack([
            Gx[p, 0] * rm6[0 + q] + Gx[p, 1] * rm6[2 + q]
            + Gx[p, 2] * rm6[4 + q]
            for p in range(2) for q in range(2)])                   # (4, N)
        B_own = (Gx @ cov_rr) @ Gx.T + (Gz @ R) @ Gz.T
        hit = (lane == g)[None, :]
        cross4 = torch.where(hit, B_own.reshape(4, 1), cross4)
        cross_r = (Gx @ cov_rr).T
        ini_mm2 = torch.where(hit, m_new[:, None], mm2)
        ini_rm6 = torch.where(hit, cross_r.reshape(6, 1), rm6)
        seen_upd = seen | hit[0]

        # ---- select sequential state ----
        diag_upd = diag4 - torch.stack([
            k4[p * 2 + 0] * s4[r * 2 + 0] + k4[p * 2 + 1] * s4[r * 2 + 1]
            for p in range(2) for r in range(2)])
        mean_r = torch.where(do_update, upd_mean_r, mean_r)
        mm2 = torch.where(do_update, upd_mm2,
                          torch.where(is_new, ini_mm2, mm2))
        cov_rr = torch.where(do_update, upd_cov_rr, cov_rr)
        rm6 = torch.where(do_update, upd_rm6,
                          torch.where(is_new, ini_rm6, rm6))
        n_seen = n_seen + is_new.to(n_seen.dtype)
        seen = torch.where(is_new, seen_upd, seen)
        diag4 = torch.where(do_update, diag_upd, diag4)
        diag4 = torch.where(is_new & hit, B_own.reshape(4, 1), diag4)

        # ---- record the op ----
        kind = torch.where(do_update, 1, torch.where(is_new, 2, 0)
                           ).to(torch.int32)
        Kb[j] = torch.where(do_update, k4, torch.zeros_like(k4))
        HSb[j] = torch.where(do_update, s4, torch.zeros_like(s4))
        CRb[j] = torch.where(is_new, cross4, torch.zeros_like(cross4))
        gb[j] = torch.where(kind > 0, g, -1)
        kb[j] = kind
    return (mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, Kb, HSb, CRb,
            gb, kb)


def kernel_operands(mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p, zs,
                    valid, ids, R, known: bool = True):
    """What the CUDA kernel takes: f32 strips and planes, bool ``seen`` and
    ``valid``, int32 ``n_seen`` and ``ids``, the shapes of
    :func:`deferred_seq_scan` for one world, or each but ``R`` with a
    leading B, all on ``mm2``'s device, 1 <= M <= 64. Raises
    ``ValueError`` otherwise; returns (contiguous operands by name, each
    but ``R`` with the leading B, 1 for one world; N, M). Needs no card."""
    name = "seq_scan"
    require(mm2.dim() in (2, 3) and zs.dim() == mm2.dim(), name,
            f"mm2 (2, N) and zs (M, 2), or each with a leading B, got "
            f"{tuple(mm2.shape)} and {tuple(zs.shape)}")
    per_world = [mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p, zs,
                 valid, ids]
    if mm2.dim() == 2:
        per_world = [None if x is None else x[None] for x in per_world]
    (mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p, zs, valid,
     ids) = per_world
    B, N, M = mm2.shape[0], mm2.shape[2], zs.shape[1]
    require(1 <= M <= MAX_MEAS, name, f"1 <= M <= {MAX_MEAS}, got M={M}")
    f32, i32 = torch.float32, torch.int32
    spec = {"mean_r": (mean_r, (B, 3), f32), "mm2": (mm2, (B, 2, N), f32),
            "cov_rr": (cov_rr, (B, 3, 3), f32),
            "rm6": (rm6, (B, 6, N), f32), "diag4": (diag4, (B, 4, N), f32),
            "seen": (seen, (B, N), torch.bool),
            "n_seen": (n_seen, (B,), i32), "mm0p": (mm0p, (B, 4, N, N), f32),
            "zs": (zs, (B, M, 2), f32), "valid": (valid, (B, M), torch.bool),
            "R": (R, (2, 2), f32)}
    if known:
        require(ids is not None, name, "known association needs ids")
        spec["ids"] = (ids, (B, M), i32)
    return checked_operands(name, mm2.device, spec), N, M


def _launch(ops, N, M, plan, known, match_gate, new_gate, wrap_innovation,
            symmetrize, stamps=None):
    """Allocate the twelve outputs and launch ``csrc/seq_scan.cu`` on the
    checked operands ``ops`` (B worlds) under ``plan``; ``stamps`` selects
    the clocked instance (:func:`phase_clock`, B = 1). The outputs have
    the leading B."""
    dev = ops["mm2"].device
    B = ops["mm2"].shape[0]
    f32, i32 = torch.float32, torch.int32
    # three allocations for the twelve outputs (the wrapper's host time is
    # most of a call): the f32 outputs are views of one buffer, the int32
    # ones of another
    shapes = ((B, 3), (B, 2, N), (B, 3, 3), (B, 6, N), (B, 4, N),
              (B, M, 4, N), (B, M, 4, N), (B, M, 4, N))
    sizes = [math.prod(shape) for shape in shapes]
    fbuf = torch.empty(sum(sizes), dtype=f32, device=dev)
    mr_o, mm2_o, crr_o, rm6_o, dg_o, Kb, HSb, CRb = (
        t.view(shape) for t, shape in zip(fbuf.split(sizes), shapes))
    ibuf = torch.empty(B * (2 * M + 1), dtype=i32, device=dev)
    ns_o = ibuf[:B]
    gb = ibuf[B:B * (M + 1)].view(B, M)
    kb = ibuf[B * (M + 1):].view(B, M)
    seen_o = torch.empty((B, N), dtype=torch.bool, device=dev)
    ptr = {k: t.data_ptr() for k, t in ops.items()}
    code = library().seq_scan(
        ptr["mean_r"], ptr["cov_rr"], ptr["n_seen"], ptr["mm2"], ptr["rm6"],
        ptr["diag4"], ptr["seen"], ptr["mm0p"], ptr["zs"], ptr["valid"],
        ptr.get("ids"), ptr["R"], mr_o.data_ptr(), crr_o.data_ptr(),
        ns_o.data_ptr(), mm2_o.data_ptr(), rm6_o.data_ptr(), dg_o.data_ptr(),
        seen_o.data_ptr(), Kb.data_ptr(), HSb.data_ptr(), CRb.data_ptr(),
        gb.data_ptr(), kb.data_ptr(), N, M, B, int(bool(wrap_innovation)),
        int(bool(symmetrize)), int(bool(known)), float(match_gate),
        float(new_gate), plan["cluster"], plan["threads"], plan["lanes"],
        plan["ring"], int(plan["hist_smem"]),
        None if stamps is None else stamps.data_ptr(), stream_handle(dev))
    check("seq_scan", code)
    return (mr_o, mm2_o, crr_o, rm6_o, dg_o, seen_o, ns_o, Kb, HSb, CRb,
            gb, kb)


def deferred_seq_scan(mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p,
                      zs, valid, ids, R, *, known: bool = True,
                      match_gate: float = 0.01, new_gate: float = 60.0,
                      wrap_innovation: bool = False,
                      symmetrize: bool = True,
                      use_kernel: bool | None = None, gate_margins=None,
                      cluster: int | None = None):
    """Run the tick's measurement scan (comp layouts), for one robot or
    for B worlds at once.

    Args: mean_r (3,), mm2 (2, N), cov_rr (3, 3), rm6 (6, N), diag4 (4, N),
    seen (N,) bool, n_seen () int32, mm0p (4, N, N) -- the frozen
    post-predict grid planes as carried in ``BlockedState``, zs (M, 2),
    valid (M,) bool, ids (M,) int32 (known association; may be ``None``
    when ``known=False``), R (2, 2); or each but ``R`` with a leading B.
    ``match_gate`` / ``new_gate`` are the first-hit gates of unknown
    association.

    Returns (mean_r', mm2', cov_rr', rm6', diag4', seen', n_seen',
    Kb (M, 4, N), HSb (M, 4, N), CRb (M, 4, N), gb (M,), kindb (M,)),
    each with the leading B for B worlds.

    ``use_kernel`` follows the package rule (``ops/kernels/__init__.py``):
    auto launches the CUDA kernel for CUDA operands (f32 only; anything
    else raises) and the plain version on the CPU. The kernel takes B
    worlds in one launch, a cluster a world; the plain version runs the
    worlds one after another. ``deferred_seq_scan.launches`` counts
    kernel launches. ``gate_margins`` is :func:`reference_seq_scan`'s
    (plain version only; (B,) a measurement for B worlds).
    ``cluster`` overrides :func:`launch_plan`'s cluster size (kernel only;
    the outputs do not depend on it).
    """
    name = "seq_scan"
    batched = mm2.dim() == 3
    if not wants_kernel(mm2, use_kernel, name):
        kw = dict(known=known, match_gate=match_gate, new_gate=new_gate,
                  wrap_innovation=wrap_innovation, symmetrize=symmetrize)
        if not batched:
            return reference_seq_scan(
                mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p, zs,
                valid, ids, R, gate_margins=gate_margins, **kw)
        worlds, margins = [], []
        for b in range(mm2.shape[0]):
            margins.append([] if gate_margins is not None else None)
            worlds.append(reference_seq_scan(
                mean_r[b], mm2[b], cov_rr[b], rm6[b], diag4[b], seen[b],
                n_seen[b], mm0p[b], zs[b], valid[b],
                None if ids is None else ids[b], R,
                gate_margins=margins[-1], **kw))
        if gate_margins is not None:
            gate_margins.extend(torch.stack(g) for g in zip(*margins))
        return tuple(torch.stack(outs) for outs in zip(*worlds))
    require(gate_margins is None, name, "gate_margins needs the plain "
            "version")
    ops, N, M = kernel_operands(mean_r, mm2, cov_rr, rm6, diag4, seen,
                                n_seen, mm0p, zs, valid, ids, R, known)
    B = ops["mm2"].shape[0]
    plan = launch_plan(N, M, known, cluster, batch=B,
                       max_active=lambda pl: max_active_clusters(pl, M))
    outs = _launch(ops, N, M, plan, known, match_gate, new_gate,
                   wrap_innovation, symmetrize)
    deferred_seq_scan.launches += 1
    return outs if batched else tuple(x[0] for x in outs)


deferred_seq_scan.launches = 0


# the spans between the clocked instance's eight stamps of a measurement
PHASES = ("associate", "publish", "barrier_1", "geometry", "lane_pass_1",
          "barrier_2", "update_lane_pass_2")


def phase_clock(mean_r, mm2, cov_rr, rm6, diag4, seen, n_seen, mm0p, zs,
                valid, ids, R, *, known: bool = True):
    """Where a measurement's time goes, layer by layer: run the scan's
    clocked instance (the same kernel, which also records the SM clock at
    the end of each phase; plans of 1 or 2 lanes a thread) on the operands
    of :func:`deferred_seq_scan` for one robot, card only. Returns
    ``(outputs, cycles)``, ``cycles`` (M, 7) float64: SM cycles
    measurement j spent in each of ``PHASES``, as thread 0 of CTA 0 saw
    them."""
    require(mm2.dim() == 2, "seq_scan", "the phase clock runs one robot")
    ops, N, M = kernel_operands(mean_r, mm2, cov_rr, rm6, diag4, seen,
                                n_seen, mm0p, zs, valid, ids, R, known)
    require(mm2.is_cuda, "seq_scan", "the phase clock runs on the card")
    stamps = torch.zeros(M, 8, dtype=torch.int64, device=mm2.device)
    outs = _launch(ops, N, M, launch_plan(N, M, known), known, 0.01, 60.0,
                   False, True, stamps)
    return (tuple(x[0] for x in outs),
            (stamps[:, 1:] - stamps[:, :-1]).double())


PROBE_MODES = {"barrier": 0, "dependent_read": 1, "scalar_chain": 2}


def chain_probe(mode: str, cluster: int, threads: int, iters: int,
                device) -> None:
    """Launch the scan's probe kernel (``csrc/seq_scan.cu``): ``iters``
    rounds of one piece of the serial chain -- ``"barrier"`` (the cluster
    barrier, ``__syncthreads()`` for a cluster of 1), ``"dependent_read"``
    (a pointer chase through device memory), ``"scalar_chain"`` (an
    update's replicated scalar arithmetic alone, the kernel's own
    functions, in every thread). The caller times it with CUDA events;
    card only."""
    device = resolve(device)
    require(device.type == "cuda", "seq_scan", "the probe runs on the card")
    # 64 MB of indices (more than L2 holds), a fixed odd-stride permutation
    words = 1 << 24
    if chain_probe.buf is None or chain_probe.buf.device != device:
        chain_probe.buf = ((torch.arange(words, device=device,
                                         dtype=torch.int64)
                            * 7919 + 104729) % words).to(torch.int32)
    check("seq_scan_probe", library().seq_scan_probe(
        PROBE_MODES[mode], cluster, threads, iters,
        chain_probe.buf.data_ptr(), words, stream_handle(device)))


chain_probe.buf = None
