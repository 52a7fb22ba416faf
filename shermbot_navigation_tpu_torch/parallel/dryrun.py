"""Multi-process dry run of the map-sharded paths (port of the sharded part
of ``shermbot_navigation_tpu.parallel.dryrun``), at tiny shapes.

P processes form a ``torch.distributed`` gloo cluster on localhost, each
holding L map shards, and run two layouts in turn: ``{'data': P, 'map':
L}`` (each process a map group of its own, with its own worlds) and
``{'data': 1, 'map': P L}`` (one map group across the processes). On each
they run the sequential and the deferred blocked ticks, known and unknown
association, from this process's shards of one global state, and hold
each tick's decisions and the gathered state to the same ticks of the
global state in this process (``mesh=None``); on the card the deferred
tick's grid pass is kernel 1, launched once a tick for every shard and
world. Then config 5's sharded refinement (``megamap.run_megamap``) on
the layout, against the one-process run. Each process prints one line;
any failure exits non-zero::

    python -m shermbot_navigation_tpu_torch.parallel.dryrun \\
        --processes 2 --local-shards 4 [--device cpu]

Without ``--device`` it runs on the card (every process on ``cuda:0``,
the collectives staged through the host).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig
from . import blocked_ekf, megamap
from .mesh import make_mesh, run_cluster

M, B, TICKS = 3, 2, 3


def _inputs(N: int, dtype, device):
    """Twists, measurements, validity and ids of TICKS ticks (B worlds),
    made from a seed: known ids revisit slots 0..5 and shift per world."""
    g = torch.Generator().manual_seed(0)
    tw = (torch.rand((B, TICKS, 3), generator=g) - 0.5) * 0.1
    zs = torch.stack([0.3 + 0.7 * torch.rand((B, TICKS, M), generator=g),
                      (torch.rand((B, TICKS, M), generator=g) - 0.5) * 6],
                     dim=-1)
    valid = torch.rand((B, TICKS, M), generator=g) < 0.9
    ids = ((torch.arange(TICKS)[:, None] + torch.arange(M)) % 6)[None] \
        + torch.arange(B)[:, None, None]
    to = lambda x: x.to(device=device, dtype=dtype)
    return (to(tw), to(zs), valid.to(device), (ids % N).int().to(device),
            to(torch.eye(3) * 1e-2), to(torch.eye(2) * 1e-3))


def _ticks(cfg, known, deferred, mesh, inputs, device):
    """The tick over TICKS ticks from the global prior: (state, decisions,
    grid-kernel launches); ``mesh`` gets its shards, gathered after."""
    from ..ops.kernels.grid_update import fused_grid_update
    tw, zs, valid, ids, Q, R = inputs
    dec = []
    make = (blocked_ekf.make_deferred_step if deferred
            else blocked_ekf.make_sequential_step)
    step = make(cfg, M, device, known=known, decisions=dec, mesh=mesh)
    st = blocked_ekf.init(cfg, B, dtype=zs.dtype, device=device)
    if mesh is not None:
        st = blocked_ekf.shard_state(st, mesh)
    before = fused_grid_update.launches
    for t in range(TICKS):
        a = (ids[:, t],) if known else ()
        st = step(st, tw[:, t], zs[:, t], valid[:, t], *a, Q, R)
    launches = fused_grid_update.launches - before
    if mesh is not None:
        st = blocked_ekf.unshard_state(st, mesh)
    return st, dec, launches


def _layout(procs, local, data, device, tol):
    """One layout's checks; returns its summary."""
    S = local * procs // data
    mesh = make_mesh(data=data, map_=S, local_shards=local, device=device)
    N = 4 * S
    cfg = EKFConfig(num_landmarks=N)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    inputs = _inputs(N, dtype, device)
    out = {}
    for deferred in (False, True):
        for known in (True, False):
            got, dgot, launches = _ticks(cfg, known, deferred, mesh, inputs,
                                         device)
            want, dwant, _ = _ticks(cfg, known, deferred, None, inputs,
                                    device)
            name = (f"{'deferred' if deferred else 'sequential'} "
                    f"{'known' if known else 'unknown'}")
            if not all(torch.equal(a, b) for x, y in zip(dgot, dwant)
                       for a, b in zip(x, y)):
                raise AssertionError(f"{name}: decisions differ at S={S}")
            err = max(float((getattr(got, f) - getattr(want, f)).abs().max())
                      for f in blocked_ekf.BlockedState._fields
                      if getattr(got, f).is_floating_point())
            if not err <= tol:
                raise AssertionError(f"{name}: state off by {err} at S={S}")
            if deferred and device.type == "cuda" and launches != TICKS:
                raise AssertionError(f"{name}: kernel 1 launched {launches} "
                                     f"times in {TICKS} ticks")
            out[name] = err
    _, ref = megamap.run_megamap(N=N, T=8, obs_per_pose=2, mesh=S,
                                 pg_iters=2, gn_iters=1, cg_iters=8,
                                 dtype=dtype, device=device)
    _, got = megamap.run_megamap(N=N, T=8, obs_per_pose=2, mesh=mesh,
                                 pg_iters=2, gn_iters=1, cg_iters=8,
                                 dtype=dtype, device=device)
    lo = mesh.rank * local * (N // S)
    err = max(float((got.poses - ref.poses).abs().max()),
              float((got.landmarks - ref.landmarks[lo:lo + len(got.landmarks)])
                    .abs().max()))
    if not (torch.isfinite(got.poses).all() and err <= tol):
        raise AssertionError(f"config 5 over {S} shards off by {err}")
    out["config5"] = err
    return {"data": data, "map": S, "N": N, "max_err": out,
            "collectives": mesh.collectives, "host_copies": mesh.host_copies}


def worker(rank: int, procs: int, local: int, device: str) -> dict:
    """One process of the dry run: both layouts."""
    device = resolve(device)
    tol = 1e-4 if device.type == "cuda" else 1e-9
    rows = [_layout(procs, local, data, device, tol)
            for data in (procs, 1)]
    print(f"dryrun OK: rank={rank}/{procs} local_shards={local} "
          f"device={device} layouts={rows}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    device = str(resolve(a.device))
    run_cluster(worker, a.processes, a.processes, a.local_shards, device,
                timeout=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
