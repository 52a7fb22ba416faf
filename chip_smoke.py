#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card.

    python3 chip_smoke.py

Run from the repository root. It needs a CUDA card and the port package
beside this file; without either it exits nonzero and prints no result.
It imports nothing of JAX. Phases, one JSON line each:

1. device  -- card name and power limit (nvidia-smi), torch/CUDA versions,
              the TF32 switches (all off);
2. build   -- both CUDA kernels built from ``csrc/`` (seconds, ptxas);
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
   of each kernel and its plain version (medians over repeats).

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
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops import se2
from shermbot_navigation_tpu_torch.ops.kernels import _build
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as gu
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as sq
from shermbot_navigation_tpu_torch.parallel import bigmap
from shermbot_navigation_tpu_torch.pipeline import serving

ROOT = Path(__file__).resolve().parent
PKG = "shermbot_navigation_tpu_torch"
GOLDEN = ROOT / "tests" / "fixtures" / "serving_n2048_golden.json"
N, M, T = 2048, 8, 320

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

KERNELS = {
    "grid_update": {
        "source": f"{PKG}/csrc/grid_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/grid_update.py:87"},
    "seq_scan": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
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
    emit(phase="build", seconds=built["seconds"], library=built["path"],
         ptxas=[ln.strip() for ln in built["ptxas"].splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])

    cfg = EKFConfig(num_landmarks=N)
    grid_ops, grid_err = phase_grid(dev)
    scan_args = scan_inputs(dev, cfg)
    scan_err = phase_scan(scan_args)
    eng, plain, wl, launches = phase_main(dev, cfg)
    per_call = phase_timing(eng, plain, wl, grid_ops, scan_args)

    errs = {"grid_update": grid_err, "seq_scan": scan_err}
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=launches[k],
                    max_abs_err=errs[k], ms=per_call[k]["ms"],
                    plain_ms=per_call[k]["plain_ms"])
               for k, v in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
