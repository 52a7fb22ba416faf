#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: known- and
unknown-association serving and the dense EKF engine.

    python3 chip_smoke.py

Run from the repository root. It needs a CUDA card and the port package
beside this file; without either it exits nonzero and prints no result.
It imports nothing of JAX. Phases, one JSON line each:

1. device  -- card name and power limit (nvidia-smi), torch/CUDA versions,
              the TF32 switches (all off);
2. build   -- the three CUDA kernels built from ``csrc/``, one ``nvcc``
              each, all at once (seconds, ptxas);
3. grid_update against its plain version at N=2048, M=8 on the card;
4. seq_scan against its plain version at N=2048, M=8, from a state after
   300 ticks with unseen slots left, on a tick that mixes updates, inits,
   a repeated slot, an out-of-range id and an invalid slot;
5. main path -- ``ServingEngine`` at N=2048, M=8 for T=320 ticks through
   the kernels (every landmark is initialized in the first N/M=256 ticks,
   the rest are update-only): both launch counters equal T, ``n_seen`` is
   N, the state matches the plain path run on the card and the JAX
   reference's golden fixture ``tests/fixtures/serving_n2048_golden.json``;
6. timing  -- ms per tick for the kernel and plain paths, and ms per call
   of each kernel and its plain version (medians over repeats);
7. cov_update against its plain version at D=4224 (the padded dense state
   of N=2048), with the update flag on and off;
8. seq_scan_unknown against its plain version at N=2048, M=8 on (a) the
   state of phase 4 on a tick that mixes an exact revisit (match), a point
   between the gates (skip), a far point (new) and an invalid slot, and
   (b) the full map of phase 5, where a far point first overflows and the
   rest of the tick is inert;
9. serving_unknown -- the unknown-association main path,
   ``bigmap.make_unknown_runner`` at N=2048, M=8 for T=320 ticks from an
   empty map through the kernels: the seq_scan counter equals T,
   ``n_seen`` and ``seen`` equal the plain path on the card after every
   tick, the state is within the scale tolerance of the plain path and
   matches ``tests/fixtures/serving_unknown_n2048_golden.json`` with equal
   decisions; the smallest relative gate margin of the plain path is
   printed, so a rounding tie can be told from a fault;
10. dense -- the dense-engine main path on ``benchmarks/
   bench_dense_serving.py``'s workload (N=2048, a converged map, exact
   measurements, twist 0): ``pallas_update='on'`` padded to D=4224 for 32
   ticks (the cov_update counter equals 32 x 8), against ``'off'`` on the
   card, against serving (known) on the same workload through
   ``state_from_dense`` / ``state_to_dense``, and against
   ``tests/fixtures/dense_n2048_golden.json``;
11. dense_timing -- ms per tick of the four rows of that benchmark (dense
   'off', dense 'on', serving known, serving unknown) and of serving
   unknown's plain path, and ms per call of cov_update and of the unknown
   scan beside their plain versions.

Then the card line as nvidia-smi prints it, the kernels line, and last
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import shermbot_navigation_tpu_torch  # noqa: F401  (pins f32 on the card)
from shermbot_navigation_tpu_torch.models import ekf_slam
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops import se2
from shermbot_navigation_tpu_torch.ops.kernels import _build
from shermbot_navigation_tpu_torch.ops.kernels import cov_update as cu
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as gu
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as sq
from shermbot_navigation_tpu_torch.parallel import bigmap, blocked_ekf
from shermbot_navigation_tpu_torch.pipeline import serving

ROOT = Path(__file__).resolve().parent
PKG = "shermbot_navigation_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = FIXTURES / "serving_n2048_golden.json"
GOLDEN_UNKNOWN = FIXTURES / "serving_unknown_n2048_golden.json"
GOLDEN_DENSE = FIXTURES / "dense_n2048_golden.json"
N, M, T = 2048, 8, 320
D_PAD = 4224       # the benchmark's padded dense state: 3+2N up to k*128
T_DENSE = 32

# seq_scan kernel vs its plain version on identical inputs, and the kernel
# path vs the plain path over the main run: both f32, differing in
# summation order, in libm ulps of atan2f/sinf/cosf and, for the scan, in
# reading grid column g as row g of the planes (PARITY D13). After 300
# ticks the planes' f32 asymmetry has grown to ~3e-5 (printed below), and
# the gain K = S H^T psi^-1 with psi ~ R = 1e-3 amplifies it: the plain
# version itself moves Kb by 4.2e-4 (of 19.7) when handed the transposed
# planes. So each output is held to max|kernel - plain| <= SCAN_TOL *
# max(1, max|plain|); diag4 over seen slots (unseen ones hold the INT_MAX
# prior and must match exactly). A wrong replay term or component moves
# an output by a fraction of its scale, orders above this bound.
SCAN_TOL = 1e-4
# grid_update with random O(1) operands: the K=16 product sums ~10 in
# magnitude, so 16 f32 roundings bound the order difference near 1e-5.
GRID_ATOL = 1e-4

# The card's run against the JAX golden fixture (XLA path, CPU, f32) after
# 320 ticks: two f32 implementations with different summation orders and
# libm, over a chain of 2560 updates. The port's plain path on a CPU
# lands at pose_xy 7.0e-6 m, heading 1.4e-6, cov_rr 1.6e-8, relative sums
# 2.3e-6 (mean_m), 2.6e-6 (diag4), 1.1e-5 (grid), grid samples 3.7e-5
# (entries 0.003..4.3). The bounds leave more than 10x of headroom and
# stay far below the scale of a wrong update (metres for positions, 5e-4
# for the robot covariance, 0.1..4 for the grid).
GOLD_TOL = {"pose_xy": 1e-4, "heading": 1e-4, "cov_rr": 2e-7,
            "sum_mean_m_rel": 5e-5, "sum_diag4_rel": 5e-5,
            "sum_cov_mm_rel": 2e-4, "grid_samples": 5e-4}

# cov_update with random O(1) operands at D=4224: each output is a
# 2-term sum of products of magnitude ~10 subtracted from an O(1) entry, so
# the kernel and the plain version's two matmuls differ by a few f32 ulps
# of 10 (~1e-6). With the flag off the kernel must copy exactly.
COV_ATOL = 1e-5

# The unknown path against the JAX golden fixture (XLA path, CPU, f32)
# after 320 ticks: association decisions (n_seen after every tick) must be
# equal; the state differs by summation order and libm over 2560 gated
# measurements. The port's plain path on a CPU keeps every decision and
# lands at pose_xy 4.7e-6 m, heading 2.6e-7, cov_rr 3.6e-8 (entries
# 1e-4..5e-3), grid samples 2.1e-6, relative sums 1.2e-6 (mean_m) and,
# over the seen slots, 2.8e-7 (diag4), 3.2e-6 (grid), 1.6e-5 (cov_rm, a
# signed sum). Its smallest relative margin of a score to a gate is
# 1.8e-4. The bounds leave more than 10x of headroom; a changed decision
# is caught exactly by n_seen, and by the state's distance from the plain
# path on the card.
GOLD_UNKNOWN_TOL = {"pose_xy": 5e-5, "heading": 5e-6, "cov_rr": 5e-7,
                    "sum_mean_m_rel": 2e-5, "sum_diag4_seen_rel": 5e-6,
                    "sum_cov_mm_seen_rel": 5e-5, "sum_cov_rm_seen_rel": 2e-4,
                    "grid_samples": 5e-5}

# The dense engine on the card, 32 ticks of the benchmark workload:
# exact measurements, so the updates shrink and correlate the covariance
# while the means move only by rounding (dz is the f32 rounding of z,
# <= 4e-6 at 65 m, so a landmark coordinate |x| <= 46 may move by one ulp,
# 3.8e-6, in one implementation and not the other). The covariance carries
# the check: a missed or doubled update moves a landmark block by ~1e-3.
# On a CPU the port's plain routes differ by: 'on' vs 'off' mean 0.0, cov
# 9.3e-10; serving vs 'off' mean 7.1e-15, cov 1.1e-8; against the JAX
# golden fixture 'off' / 'on' / serving land at mean_r 1.7e-9, cov_rr
# 2.5e-11, relative sums of means 1.6e-13, of the diagonal 8.6e-11 /
# 6.2e-11 / 2.2e-9, of all entries 4.0e-11 / 4.9e-11 / 3.1e-9, cov samples
# 9.3e-10 / 9.3e-10 / 4.7e-9. Bounds: >= 10x those on the covariance; five
# ulps of the largest coordinate on the means.
DENSE_TOL = {"mean": 2e-5, "cov": 2e-7}
GOLD_DENSE_TOL = {"mean_r": 1e-7, "max_abs_mean_shift": 2e-5,
                  "cov_rr": 1e-9, "sum_mean_m_rel": 1e-6,
                  "sum_diag_rel": 1e-7, "sum_cov_rel": 1e-7,
                  "cov_samples": 1e-7}

KERNELS = {
    "grid_update": {
        "source": f"{PKG}/csrc/grid_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/grid_update.py:87"},
    "seq_scan": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
    "seq_scan_unknown": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
    "cov_update": {
        "source": f"{PKG}/csrc/cov_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/cov_update.py:70"},
}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close_err(got, want, atol):
    """(max |got - want|, within atol everywhere)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err <= atol


def scale_err(got, want, seen=None):
    """(max |got - want|, within SCAN_TOL * max(1, max |want|)); with
    ``seen``, lanes (last axis) outside it must be equal exactly."""
    if seen is not None:
        if not torch.equal(got[..., ~seen], want[..., ~seen]):
            return float("inf"), False
        got, want = got[..., seen], want[..., seen]
    err = float((got.double() - want.double()).abs().max())
    return err, err <= SCAN_TOL * max(1.0, float(want.abs().max()))


def cuda_ms(fn, inner: int, repeats: int = 5) -> float:
    """Median over repeats of (CUDA-event time of ``inner`` calls) / inner."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def grid_operands(rng, dev):
    """Random grid-pass operands at N, M with rowT/colT holding ties,
    repeated op indices and -1."""
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(dev)
    rowt = rng.integers(-1, M, N).astype(np.int32)
    colt = rng.integers(-1, M, N).astype(np.int32)
    colt[::7] = rowt[::7]                      # ties at equal op index
    return (f(2, 2, N, N), f(2, N, 2 * M), f(2, 2 * M, N), f(2, 2, M, N),
            f(2, 2, N, M), torch.from_numpy(rowt).to(dev),
            torch.from_numpy(colt).to(dev))


def phase_grid(dev):
    ops = grid_operands(np.random.default_rng(0), dev)
    want = gu.reference_grid_update(*ops)
    got = gu.fused_grid_update(ops[0].clone(), *ops[1:], use_kernel=True)
    torch.cuda.synchronize()
    err, ok = close_err(got, want, GRID_ATOL)
    # the overwrite replay alone must be exact (no arithmetic)
    zero_a, zero_b = torch.zeros_like(ops[1]), torch.zeros_like(ops[2])
    rep = (ops[0], zero_a, zero_b) + ops[3:]
    replay_err = float((gu.fused_grid_update(rep[0].clone(), *rep[1:],
                                             use_kernel=True)
                        - gu.reference_grid_update(*rep)).abs().max())
    emit(phase="grid_update", N=N, M=M, max_abs_err=err, atol=GRID_ATOL,
         replay_max_abs_err=replay_err)
    if not ok or replay_err != 0.0:
        fail(f"grid_update disagrees with its plain version: {err}, "
             f"replay {replay_err}")
    return ops, err


def scan_inputs(dev, cfg):
    """A state after T-20 ticks (300) of a schedule that leaves the top
    eighth of the slots unseen, and one tick mixing updates, inits, a
    repeated slot, an out-of-range id and an invalid slot."""
    eng = serving.ServingEngine(cfg, M, *bigmap.noise(device=dev),
                                robot_pose=[0.0, 0.0, 0.0], device=dev)
    wl = bigmap.make_workload(N, T, M, device=dev)
    u = N - N // 8
    wl = wl._replace(schedule=wl.schedule % u)
    for t in range(T - 20):
        zs, ids, tw = bigmap.measurements(wl, t)
        eng.tick(tw, zs, ids=ids)
    st = eng.state
    ids = torch.tensor([5, u + 4, 5, u + 4, N + 5, N // 2, u + 5, 7],
                       dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.bool,
                         device=dev)
    # measurements of these ids (the out-of-range one clamped)
    wl = wl._replace(schedule=ids.clamp(0, N - 1)[None].expand(T, M))
    zs, _, _ = bigmap.measurements(wl, T - 20)
    _, R = bigmap.noise(device=dev)
    return (st.mean_r[0], st.mean_m[0].T.contiguous(), st.cov_rr[0],
            st.cov_rm[0].permute(0, 2, 1).reshape(6, N), st.diag4[0],
            st.seen[0], st.n_seen[0], st.cov_mm[0].reshape(4, N, N), zs,
            valid, ids, R)


def phase_scan(args):
    want = sq.reference_seq_scan(*args)
    got = sq.deferred_seq_scan(*args, use_kernel=True)
    torch.cuda.synchronize()
    names = ("mean_r", "mm2", "cov_rr", "rm6", "diag4", "seen", "n_seen",
             "Kb", "HSb", "CRb", "gb", "kindb")
    discrete = {"seen", "n_seen", "gb", "kindb"}
    errs, bad = {}, []
    for name, g, w in zip(names, got, want):
        if name in discrete:
            if not torch.equal(g, w):
                bad.append(name)
            continue
        errs[name], ok = scale_err(g, w, want[5] if name == "diag4" else None)
        if not ok:
            bad.append(name)
    planes = args[7].reshape(2, 2, N, N)
    asym = float((planes - planes.permute(1, 0, 3, 2)).abs().max())
    emit(phase="seq_scan", N=N, M=M, kinds=got[-1].tolist(),
         gb=got[-2].tolist(), discrete_equal=not any(b in discrete
                                                     for b in bad),
         max_abs_err=errs, scale_tol=SCAN_TOL, grid_asymmetry=asym)
    if bad:
        fail(f"seq_scan disagrees with its plain version on {bad}")
    kinds = set(got[-1].tolist())
    if not {0, 1, 2} <= kinds:
        fail(f"the scan test tick lacks a branch: kinds {kinds}")
    return max(errs.values())


def serve(dev, cfg, wl, ticks, use_kernel):
    eng = serving.ServingEngine(cfg, M, *bigmap.noise(device=dev),
                                robot_pose=[0.0, 0.0, 0.0], device=dev,
                                seq_kernel=use_kernel, grid_kernel=use_kernel)
    for t in range(ticks):
        zs, ids, tw = bigmap.measurements(wl, t)
        eng.tick(tw, zs, ids=ids)
    torch.cuda.synchronize()
    return eng


def golden_errors(st, golden):
    """Differences of a final state from the golden fixture."""
    mean_r = st.mean_r[0].double().cpu()
    true = torch.tensor(golden["true_pose"], dtype=torch.float64)
    pos = golden["grid_samples"]["positions"]
    grid = st.cov_mm[0]
    samples = torch.stack([grid[a, b, r, c] for a, b, r, c in pos]
                          ).double().cpu()
    rel = lambda x, y: abs(x - y) / abs(y)
    pose_err = float(torch.hypot(*(mean_r[1:] - true[1:])))
    return {
        "pose_xy": float((mean_r[1:] - torch.tensor(golden["mean_r"][1:],
                                                    dtype=torch.float64)
                          ).abs().max()),
        "heading": abs(float(se2.normalize_angle(
            mean_r[0] - golden["mean_r"][0]))),
        "cov_rr": float((st.cov_rr[0].double().cpu().reshape(-1)
                         - torch.tensor(golden["cov_rr"], dtype=torch.float64)
                         ).abs().max()),
        "sum_mean_m_rel": rel(float(st.mean_m.double().sum()),
                              golden["sum_mean_m"]),
        "sum_diag4_rel": rel(float(st.diag4.double().sum()),
                             golden["sum_diag4"]),
        "sum_cov_mm_rel": rel(float(st.cov_mm.double().sum()),
                              golden["sum_cov_mm"]),
        "grid_samples": float((samples - torch.tensor(
            golden["grid_samples"]["values"], dtype=torch.float64)
                               ).abs().max()),
    }, pose_err


def phase_main(dev, cfg):
    golden = json.loads(GOLDEN.read_text())
    if (golden["N"], golden["M"], golden["T"]) != (N, M, T):
        fail(f"golden fixture is for {golden['N'], golden['M'], golden['T']}")
    wl = bigmap.make_workload(N, T, M, device=dev)

    gu.fused_grid_update.launches = 0
    sq.deferred_seq_scan.launches = 0
    t0 = time.perf_counter()
    eng = serve(dev, cfg, wl, T, None)
    seconds = time.perf_counter() - t0
    launches = {"grid_update": gu.fused_grid_update.launches,
                "seq_scan": sq.deferred_seq_scan.launches}
    plain = serve(dev, cfg, wl, T, False)

    st, ps = eng.state, plain.state
    vs_plain, plain_bad = {}, []
    for k in st._fields:
        a, b = getattr(st, k), getattr(ps, k)
        if a.dtype in (torch.bool, torch.int32):
            vs_plain[k], ok = bool(torch.equal(a, b)), bool(torch.equal(a, b))
        else:
            vs_plain[k], ok = scale_err(a, b)
        if not ok:
            plain_bad.append(k)
    gold, pose_err = golden_errors(st, golden)
    finite = all(bool(torch.isfinite(x).all()) for x in st
                 if x.dtype.is_floating_point)
    emit(phase="main_path", N=N, M=M, T=T, seconds=seconds,
         launches=launches, n_seen=eng.n_seen, pose_err=pose_err,
         golden_pose_err=golden["pose_err"], finite=finite,
         vs_plain_on_card=vs_plain, scale_tol=SCAN_TOL, vs_golden=gold, golden_tol=GOLD_TOL)
    if launches != {"grid_update": T, "seq_scan": T}:
        fail(f"main path launched {launches}, want {T} each")
    if eng.n_seen != N or not finite or not math.isfinite(pose_err):
        fail(f"main path state: n_seen {eng.n_seen}, finite {finite}, "
             f"pose_err {pose_err}")
    if plain_bad:
        fail(f"kernel path and plain path disagree on {plain_bad}")
    for k, tol in GOLD_TOL.items():
        if not gold[k] <= tol:
            fail(f"golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return eng, plain, wl, launches


def phase_timing(eng, plain, wl, grid_ops, scan_args):

    def tick_ms(e, t0, ticks, repeats=5):
        out = []
        t = t0
        for _ in range(repeats):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(ticks):
                zs, ids, tw = bigmap.measurements(wl, t)
                e.tick(tw, zs, ids=ids)
                t += 1
            torch.cuda.synchronize()
            out.append((time.perf_counter() - start) * 1e3 / ticks)
        return statistics.median(out)

    per_tick = {"kernel": tick_ms(eng, T, 50), "plain": tick_ms(plain, T, 10)}
    cov, rest = grid_ops[0], grid_ops[1:]
    per_call = {
        "grid_update": {
            "ms": cuda_ms(lambda: gu.fused_grid_update(cov, *rest,
                                                       use_kernel=True), 50),
            "plain_ms": cuda_ms(lambda: gu.reference_grid_update(cov, *rest),
                                5)},
        "seq_scan": {
            "ms": cuda_ms(lambda: sq.deferred_seq_scan(*scan_args,
                                                       use_kernel=True), 50),
            "plain_ms": cuda_ms(lambda: sq.reference_seq_scan(*scan_args),
                                5)},
    }
    emit(phase="timing", N=N, M=M, ms_per_tick=per_tick,
         ms_per_call=per_call,
         note="ms per tick: host clock around synchronized blocks of "
              "update-only ticks; ms per call: CUDA events, medians of 5")
    return per_call


def phase_cov(dev):
    """cov_update against its plain version at D=4224, flag on and off."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(dev)
    ops = (f(D_PAD, D_PAD), f(D_PAD, 2),
           torch.tensor([[2.0, -0.3], [-0.3, 1.5]], device=dev), f(2),
           f(D_PAD))
    errs = {}
    for flag in (True, False):
        apply = torch.tensor(flag, device=dev)
        want = cu.reference_kalman_update(*ops, apply=apply)
        got = cu.fused_kalman_update(*ops, apply=apply, use_kernel=True)
        torch.cuda.synchronize()
        errs[flag] = max(close_err(g, w, COV_ATOL)[0]
                         for g, w in zip(got, want))
    emit(phase="cov_update", D=D_PAD, max_abs_err=errs[True],
         flag_off_max_abs_err=errs[False], atol=COV_ATOL)
    if not errs[True] <= COV_ATOL or errs[False] != 0.0:
        fail(f"cov_update disagrees with its plain version: {errs}")
    return ops, errs[True]


def _z_at(mean_r, p):
    """Exact range-bearing (f64) of point ``p`` (2,) from pose ``mean_r``."""
    dx, dy = p[0] - mean_r[1], p[1] - mean_r[2]
    return torch.stack([torch.hypot(dx, dy), se2.normalize_angle(
        torch.atan2(dy, dx) - mean_r[0])])


def pick_slots(args):
    """Seen slots of the scan's input state whose exact revisit is a
    first-hit MATCH at that slot, and whose 5-cm-long revisit lands
    between the gates (a SKIP) -- chosen with the plain association,
    because the reference's first-hit rule lets an earlier, uncertain
    landmark take a measurement. Returns (match slots, skip slots)."""
    mean_r, mm2, cov_rr, rm6, diag4, seen = args[:6]
    R = args[11]
    mr, mm = mean_r.double(), mm2.double()
    match, skip = [], []
    for s in torch.nonzero(seen).flatten().tolist()[::7]:
        for long_, out in ((0.0, match), (0.05, skip)):
            z = (_z_at(mr, mm[:, s]) + torch.tensor([long_, 0.0],
                                                    device=mm.device)).float()
            hit, first, d, _ = blocked_ekf._associate_comp(
                mean_r, mm2, cov_rr, rm6, seen, z, R, diag4, new_gate=60.0,
                wrap_innovation=False)
            if long_ == 0.0 and bool(hit) and int(first) == s and \
                    float(d) < 0.001:
                out.append(s)
            if long_ and bool(hit) and 0.05 < float(d) < 30.0:
                out.append(s)
        if len(match) >= 3 and len(skip) >= 2:
            break
    return match, skip


def unknown_tick(args, plan):
    """The scan's arguments with this tick's measurements: ``plan`` lists
    ``(what, slot)`` -- "match" the exact range-bearing of landmark
    ``slot`` from the input state, "skip" that range 5 cm long, "far" a
    point 1 km off the map, "invalid" a valid=False slot; no ids."""
    mr, mm = args[0].double(), args[1].double()
    zs, valid = [], []
    for what, s in plan:
        p = mm[:, s] + (1000.0 if what == "far" else 0.0)
        zs.append(_z_at(mr, p) + torch.tensor(
            [0.05 if what == "skip" else 0.0, 0.0], device=mm.device))
        valid.append(what != "invalid")
    return args[:8] + (torch.stack(zs).float(),
                       torch.tensor(valid, device=mm.device), None, args[11])


def phase_scan_unknown(partial_args, full_args):
    """The unknown branch against its plain version on (a) and (b)."""
    match, skip = pick_slots(partial_args)
    if len(match) < 2 or not skip:
        fail(f"no clean match/skip slots in the scan state: {match}, {skip}")
    plans = {
        "partial": [("match", match[0]), ("skip", skip[0]), ("far", 20),
                    ("invalid", 3), ("match", match[1]), ("far", 40),
                    ("skip", skip[-1]), ("match", match[0])],
        "full_overflow": [("far", 20), ("match", match[0]),
                          ("skip", skip[0]), ("match", match[1]),
                          ("far", 30), ("invalid", 3), ("match", match[-1]),
                          ("skip", skip[-1])],
    }
    names = ("mean_r", "mm2", "cov_rr", "rm6", "diag4", "seen", "n_seen",
             "Kb", "HSb", "CRb", "gb", "kindb")
    discrete = {"seen", "n_seen", "gb", "kindb"}
    out, kinds_all, worst = {}, set(), 0.0
    for case, base in (("partial", partial_args),
                       ("full_overflow", full_args)):
        args = unknown_tick(base, plans[case])
        margins = []
        want = sq.reference_seq_scan(*args, known=False,
                                     gate_margins=margins)
        got = sq.deferred_seq_scan(*args, known=False, use_kernel=True)
        torch.cuda.synchronize()
        errs, bad = {}, []
        for name, g, w in zip(names, got, want):
            if name in discrete:
                if not torch.equal(g, w):
                    bad.append(name)
                continue
            errs[name], ok = scale_err(g, w, want[5] if name == "diag4"
                                       else None)
            if not ok:
                bad.append(name)
        kinds = got[-1].tolist()
        kinds_all |= set(kinds)
        worst = max(worst, max(errs.values()))
        out[case] = dict(plan=plans[case], kinds=kinds, gb=got[-2].tolist(),
                         n_seen_in=int(base[6]), n_seen_out=int(got[6]),
                         discrete_equal=not any(b in discrete for b in bad),
                         max_abs_err=errs,
                         min_gate_margin=float(torch.stack(margins).min()))
        if bad:
            emit(phase="seq_scan_unknown", **out)
            fail(f"seq_scan (unknown, {case}) disagrees with its plain "
                 f"version on {bad}")
    emit(phase="seq_scan_unknown", N=N, M=M, scale_tol=SCAN_TOL, **out)
    if not {0, 1, 2} <= kinds_all:
        fail(f"the unknown scan ticks lack a branch: kinds {kinds_all}")
    full = out["full_overflow"]
    if full["kinds"] != [0] * M or full["n_seen_out"] != N:
        fail(f"overflow did not stop the tick: {full['kinds']}")
    return worst, unknown_tick(partial_args, plans["partial"])


def unknown_golden_errors(st, golden):
    """Differences of the unknown path's final state from its fixture
    (sums over the seen slots, which fill in order)."""
    ns = int(st.n_seen[0])
    gold, _ = golden_errors(st, golden)
    rel = lambda x, y: abs(x - y) / abs(y)
    gold.pop("sum_diag4_rel")
    gold.pop("sum_cov_mm_rel")
    gold["sum_diag4_seen_rel"] = rel(float(st.diag4[0, :, :ns].double()
                                           .sum()), golden["sum_diag4_seen"])
    gold["sum_cov_mm_seen_rel"] = rel(
        float(st.cov_mm[0, :, :, :ns, :ns].double().sum()),
        golden["sum_cov_mm_seen"])
    gold["sum_cov_rm_seen_rel"] = rel(float(st.cov_rm[0, :, :ns].double()
                                            .sum()),
                                      golden["sum_cov_rm_seen"])
    return gold


def run_unknown(dev, cfg, wl, use_kernel, margins=None):
    """T unknown ticks from an empty map, one runner call a tick; returns
    the final state and (n_seen, seen) after every tick, on the card."""
    run = bigmap.make_unknown_runner(cfg, M, dev, seq_kernel=use_kernel,
                                     grid_kernel=use_kernel,
                                     gate_margins=margins)
    Q, R = bigmap.noise(device=dev)
    st = blocked_ekf.init(cfg, 1, device=dev)
    hist = []
    for t in range(T):
        st = run(st, wl, Q, R, t, 1)
        hist.append((st.n_seen.clone(), st.seen.clone()))
    torch.cuda.synchronize()
    return st, hist


def phase_serving_unknown(dev, cfg):
    golden = json.loads(GOLDEN_UNKNOWN.read_text())
    if (golden["N"], golden["M"], golden["T"]) != (N, M, T):
        fail(f"golden fixture is for {golden['N'], golden['M'], golden['T']}")
    wl = bigmap.make_workload(N, T, M, device=dev)

    gu.fused_grid_update.launches = 0
    sq.deferred_seq_scan.launches = 0
    t0 = time.perf_counter()
    st, hist = run_unknown(dev, cfg, wl, None)
    seconds = time.perf_counter() - t0
    launches = {"grid_update": gu.fused_grid_update.launches,
                "seq_scan": sq.deferred_seq_scan.launches}
    margins = []
    ps, phist = run_unknown(dev, cfg, wl, False, margins)

    per_tick_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                         for a, b in zip(hist, phist))
    n_seen_ticks = [int(x[0][0]) for x in hist]
    decisions_equal = n_seen_ticks == golden["n_seen_per_tick"]
    first_diff = next((t for t, (a, b) in enumerate(
        zip(n_seen_ticks, golden["n_seen_per_tick"])) if a != b), None)
    vs_plain, plain_bad = {}, []
    for k in st._fields:
        a, b = getattr(st, k), getattr(ps, k)
        if a.dtype in (torch.bool, torch.int32):
            vs_plain[k] = ok = bool(torch.equal(a, b))
        else:
            vs_plain[k], ok = scale_err(a, b)
        if not ok:
            plain_bad.append(k)
    gold = unknown_golden_errors(st, golden)
    finite = all(bool(torch.isfinite(x).all()) for x in st
                 if x.dtype.is_floating_point)
    margin = float(torch.stack(margins).min())
    emit(phase="serving_unknown", N=N, M=M, T=T, seconds=seconds,
         launches=launches, n_seen=int(st.n_seen[0]),
         golden_n_seen=golden["n_seen"], finite=finite,
         seen_equal_plain_every_tick=per_tick_equal,
         decisions_equal_golden=decisions_equal,
         first_tick_differing_from_golden=first_diff,
         min_gate_margin_plain=margin, vs_plain_on_card=vs_plain,
         scale_tol=SCAN_TOL, vs_golden=gold, golden_tol=GOLD_UNKNOWN_TOL)
    if launches != {"grid_update": T, "seq_scan": T}:
        fail(f"unknown path launched {launches}, want {T} each")
    if not per_tick_equal or plain_bad:
        fail(f"unknown kernel path and plain path disagree: per-tick seen "
             f"{per_tick_equal}, fields {plain_bad}")
    if not finite or not decisions_equal:
        fail(f"unknown path state: finite {finite}, decisions equal to the "
             f"golden fixture {decisions_equal} (first tick {first_diff})")
    for k, tol in GOLD_UNKNOWN_TOL.items():
        if not gold[k] <= tol:
            fail(f"unknown golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return launches


def seeded_dense(cfg, dev):
    """``bench_dense_serving.make_seeded_state``: every landmark seen at
    its grid position, covariance diag 0.01 on the logical dims, zero on
    the padded tail. Returns (state, landmarks (N, 2) f64)."""
    D = cfg.dim
    side = math.ceil(math.sqrt(N))
    ii = torch.arange(N, dtype=torch.float64)
    lms = torch.stack([(torch.remainder(ii, side) - side / 2) * 2.0,
                       (torch.div(ii, side, rounding_mode="floor")
                        - side / 2) * 2.0], dim=-1)
    st = ekf_slam.init(cfg, [0.0, 0.0, 0.0], device=dev)
    mean = st.mean.clone()
    mean[3:3 + 2 * N] = lms.reshape(-1).to(dev, torch.float32)
    diag = torch.zeros(D, device=dev)
    diag[:3 + 2 * N] = 0.01
    return st._replace(mean=mean, cov=torch.diag(diag),
                       n_seen=torch.tensor(N, dtype=torch.int32, device=dev),
                       seen=torch.ones(N, dtype=torch.bool, device=dev)), lms


def dense_schedule(lms, ticks, dev):
    """``bench_dense_serving.make_schedule``: tick t measures ids
    [tM, tM+M) mod N exactly (computed in f64, stored f32)."""
    ids = (torch.arange(ticks)[:, None] * M + torch.arange(M)[None]) % N
    p = lms[ids]
    zs = torch.stack([torch.hypot(p[..., 0], p[..., 1]),
                      torch.atan2(p[..., 1], p[..., 0])], dim=-1)
    return zs.to(dev, torch.float32), ids.to(dev, torch.int32)


def dense_noise(dev):
    return (torch.eye(3, device=dev) * 1e-6, torch.eye(2, device=dev) * 1e-3)


def run_dense(cfg, st, sched, t0, ticks):
    zs, ids = sched
    dev = st.mean.device
    Q, R = dense_noise(dev)
    tw = torch.zeros(3, device=dev)
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    n = zs.shape[0]
    for t in range(t0, t0 + ticks):
        st = ekf_slam.known_association_step(cfg, st, tw, zs[t % n], valid,
                                             ids[t % n], Q, R)
    return st


def dense_configs():
    """'on' (padded, the kernel), 'off' (unpadded, plain), serving."""
    return (EKFConfig(num_landmarks=N, pad_state_to=D_PAD,
                      pallas_update="on", symmetrize=False),
            EKFConfig(num_landmarks=N, pallas_update="off",
                      symmetrize=False),
            EKFConfig(num_landmarks=N, symmetrize=False))


def serving_on_dense(cfg_srv, cfg_off, dev, known=True, use_kernel=None):
    seeded, _ = seeded_dense(cfg_off, dev)
    return serving.ServingEngine(cfg_srv, M, *dense_noise(dev), known=known,
                                 dense_state=seeded, device=dev,
                                 seq_kernel=use_kernel,
                                 grid_kernel=use_kernel)


def dense_golden_errors(st, golden):
    """Differences of a dense final state (logical part) from the
    fixture."""
    D = golden["D"]
    mean, cov = st.mean[:D].double().cpu(), st.cov[:D, :D].double().cpu()
    seeded, _ = seeded_dense(dense_configs()[1], "cpu")
    rel = lambda x, y: abs(x - y) / abs(y)
    pos = torch.tensor(golden["cov_samples"]["positions"])
    return {
        "mean_r": float((mean[:3] - torch.tensor(golden["mean_r"],
                                                 dtype=torch.float64)
                         ).abs().max()),
        "max_abs_mean_shift": abs(float((mean - seeded.mean.double())
                                        .abs().max())
                                  - golden["max_abs_mean_shift"]),
        "cov_rr": float((cov[:3, :3].reshape(-1) - torch.tensor(
            golden["cov_rr"], dtype=torch.float64)).abs().max()),
        "sum_mean_m_rel": rel(float(mean[3:].sum()), golden["sum_mean_m"]),
        "sum_diag_rel": rel(float(torch.diagonal(cov).sum()),
                            golden["sum_diag"]),
        "sum_cov_rel": rel(float(cov.sum()), golden["sum_cov"]),
        "cov_samples": float((cov[pos[:, 0], pos[:, 1]] - torch.tensor(
            golden["cov_samples"]["values"], dtype=torch.float64)
                              ).abs().max()),
    }


def phase_dense(dev):
    golden = json.loads(GOLDEN_DENSE.read_text())
    cfg_on, cfg_off, cfg_srv = dense_configs()
    if (golden["N"], golden["M"], golden["T"], golden["D"]) != (
            N, M, T_DENSE, 3 + 2 * N):
        fail(f"dense golden fixture is for {golden['N'], golden['T']}")
    seeded_on, lms = seeded_dense(cfg_on, dev)
    sched = dense_schedule(lms, T_DENSE, dev)

    cu.fused_kalman_update.launches = 0
    t0 = time.perf_counter()
    on = run_dense(cfg_on, seeded_on, sched, 0, T_DENSE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cu.fused_kalman_update.launches

    off = run_dense(cfg_off, seeded_dense(cfg_off, dev)[0], sched, 0,
                    T_DENSE)
    srv = serving_on_dense(cfg_srv, cfg_off, dev)
    zs, ids = sched
    for t in range(T_DENSE):
        srv.tick(torch.zeros(3, device=dev), zs[t], ids=ids[t])
    srv_dense = serving.state_to_dense(cfg_off, srv.state)
    torch.cuda.synchronize()

    D = 3 + 2 * N
    diff = lambda a, b: float((a.double() - b.double()).abs().max())
    vs_off = {"mean": diff(on.mean[:D], off.mean),
              "cov": diff(on.cov[:D, :D], off.cov)}
    vs_srv = {"mean": diff(on.mean[:D], srv_dense.mean),
              "cov": diff(on.cov[:D, :D], srv_dense.cov)}
    tail_zero = not bool(on.mean[D:].any() or on.cov[D:].any()
                         or on.cov[:, D:].any())
    discrete = (int(on.n_seen) == int(off.n_seen) == int(srv.n_seen) == N
                and bool(on.seen.all()))
    finite = bool(torch.isfinite(on.cov).all() and torch.isfinite(on.mean)
                  .all())
    gold = dense_golden_errors(on, golden)
    emit(phase="dense", N=N, M=M, T=T_DENSE, D=D_PAD, seconds=seconds,
         launches={"cov_update": launches}, finite=finite,
         padded_tail_zero=tail_zero, vs_off_on_card=vs_off,
         vs_serving_on_card=vs_srv, tol=DENSE_TOL, vs_golden=gold,
         golden_tol=GOLD_DENSE_TOL)
    if launches != T_DENSE * M:
        fail(f"dense path launched cov_update {launches} times, want "
             f"{T_DENSE * M}")
    if not (finite and tail_zero and discrete):
        fail(f"dense state: finite {finite}, tail zero {tail_zero}, "
             f"n_seen/seen {discrete}")
    for name, errs in (("'off'", vs_off), ("serving", vs_srv)):
        for k, tol in DENSE_TOL.items():
            if not errs[k] <= tol:
                fail(f"dense 'on' vs {name}: {k} {errs[k]} > {tol}")
    for k, tol in GOLD_DENSE_TOL.items():
        if not gold[k] <= tol:
            fail(f"dense golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return launches, (on, off, srv, sched)


def phase_dense_timing(dev, dense, cov_ops, unk_args):
    """ms per tick of the benchmark's four rows and of serving unknown's
    plain path, taken in turns (each round times one block of every row,
    the order reversed every other round) so that host noise falls on all
    rows alike; host clock around synchronized blocks, medians. ms per
    call of cov_update and the unknown scan beside their plain versions
    (CUDA events)."""
    on, off, srv, _ = dense
    cfg_on, cfg_off, cfg_srv = dense_configs()
    _, lms = seeded_dense(cfg_off, "cpu")
    zs, ids = dense_schedule(lms, 512, dev)
    tw = torch.zeros(3, device=dev)
    state = {"on": on, "off": off}

    def dense_tick(key, cfg):
        def tick(t):
            state[key] = run_dense(cfg, state[key], (zs, ids), t, 1)
        return tick

    unk = serving_on_dense(cfg_srv, cfg_off, dev, known=False)
    unk_plain = serving_on_dense(cfg_srv, cfg_off, dev, known=False,
                                 use_kernel=False)
    for e in (unk, unk_plain):
        e.tick(tw, zs[0])                       # warm
    # row: (tick function, ticks a block, rounds)
    rows = {
        "dense_off": (dense_tick("off", cfg_off), 8, 6),
        "dense_on": (dense_tick("on", cfg_on), 8, 6),
        "serving_known": (lambda t: srv.tick(tw, zs[t % 512],
                                             ids=ids[t % 512]), 20, 6),
        "serving_unknown": (lambda t: unk.tick(tw, zs[t % 512]), 20, 6),
        "serving_unknown_plain": (
            lambda t: unk_plain.tick(tw, zs[t % 512]), 3, 2),
    }
    clock = {k: T_DENSE for k in rows}
    times = {k: [] for k in rows}
    order = list(rows)
    for rnd in range(6):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            tick, ticks, rounds = rows[k]
            if rnd >= rounds:
                continue
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(ticks):
                tick(clock[k])
                clock[k] += 1
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - start) * 1e3 / ticks)
    per_tick = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: [min(v), max(v)] for k, v in times.items()}
    per_call = {
        "cov_update": {
            "ms": cuda_ms(lambda: cu.fused_kalman_update(
                *cov_ops, use_kernel=True), 50),
            "plain_ms": cuda_ms(lambda: cu.reference_kalman_update(
                *cov_ops), 20)},
        "seq_scan_unknown": {
            "ms": cuda_ms(lambda: sq.deferred_seq_scan(
                *unk_args, known=False, use_kernel=True), 50),
            "plain_ms": cuda_ms(lambda: sq.reference_seq_scan(
                *unk_args, known=False), 5)},
    }
    emit(phase="dense_timing", N=N, M=M, D_on=D_PAD, D_off=3 + 2 * N,
         ms_per_tick=per_tick, ms_per_tick_min_max=spread,
         ms_per_call=per_call, n_seen_unknown=unk.n_seen,
         note="bench_dense_serving workload, symmetrize=False; ms per "
              "tick: host clock around synchronized blocks taken in turns, "
              "median of 6 blocks (plain: of 2); ms per call: CUDA events, "
              "medians of 5")
    return per_call


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = nvidia_smi()

    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("TF32 is on")

    built = _build.build()
    emit(phase="build", seconds=built["seconds"], libraries=built["paths"],
         ptxas=[ln.strip() for ln in built["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])

    cfg = EKFConfig(num_landmarks=N)
    grid_ops, grid_err = phase_grid(dev)
    scan_args = scan_inputs(dev, cfg)
    scan_err = phase_scan(scan_args)
    eng, plain, wl, launches = phase_main(dev, cfg)
    # the full map of the main path, before the timing ticks change it
    full = eng.state
    full_args = (full.mean_r[0], full.mean_m[0].T.contiguous(),
                 full.cov_rr[0], full.cov_rm[0].permute(0, 2, 1)
                 .reshape(6, N), full.diag4[0].clone(), full.seen[0].clone(),
                 full.n_seen[0].clone(), full.cov_mm[0].reshape(4, N, N)
                 .clone()) + scan_args[8:]
    per_call = phase_timing(eng, plain, wl, grid_ops, scan_args)

    cov_ops, cov_err = phase_cov(dev)
    unk_err, unk_args = phase_scan_unknown(scan_args, full_args)
    unk_launches = phase_serving_unknown(dev, cfg)
    dense_launches, dense = phase_dense(dev)
    per_call.update(phase_dense_timing(dev, dense, cov_ops, unk_args))

    launches = dict(launches, seq_scan_unknown=unk_launches["seq_scan"],
                    cov_update=dense_launches)
    errs = {"grid_update": grid_err, "seq_scan": scan_err,
            "seq_scan_unknown": unk_err, "cov_update": cov_err}
    paths = {"grid_update": "serving known", "seq_scan": "serving known",
             "seq_scan_unknown": "serving unknown",
             "cov_update": "dense pallas_update='on'"}
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=launches[k],
                    max_abs_err=errs[k], ms=per_call[k]["ms"],
                    plain_ms=per_call[k]["plain_ms"], path=paths[k])
               for k, v in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
