"""A two-process ``torch.distributed`` gloo cluster on the CPU: the port's
counterpart of ``tests/test_multihost.py``.

Two OS processes (this file run as a script, below its ``__main__`` check;
it imports no JAX) join a cluster over localhost TCP and build a mesh whose
map shards span both, 4 local shards each (``parallel/mesh.py``). Every
collective of the sharded ticks and of the Schur refinement then crosses a
real process boundary. The cases:

- ``full``: the sequential and the deferred blocked ticks, known and
  unknown association, and the sharded Schur GN step, on 2 processes x 4
  shards against 1 process x 8 shards (computed in each worker): within
  1e-12 in f64, decisions equal;
- ``bign``: config 4's width (N=2048, M=8), 3 deferred ticks, the
  per-tick strip gathers crossing the process boundary;
- ``ckpt_save`` / ``ckpt_resume``: both ranks ``save_sharded`` mid-run
  and are killed by exact PID while still computing; a fresh cluster
  ``load_sharded``s and finishes bit for bit equal to an uninterrupted
  run on the same layout, and a changed layout is refused.

And the dry run (``parallel/dryrun.py``) with 2 processes. Each worker has
a timeout of its own.
"""

import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode, *extra):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank), "2",
         str(port), *map(str, extra)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for rank in range(2)]


def _wait_ok(procs, marker):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out}"
        assert f"rank={rank} {marker}" in out, out


def test_two_process_cluster():
    _wait_ok(_spawn("full"), "TORCH_MULTIHOST_OK")


def test_two_process_cluster_config4_scale():
    _wait_ok(_spawn("bign"), "TORCH_MULTIHOST_BIGN_OK")


def test_two_process_checkpoint_restart(tmp_path):
    save_dir = str(tmp_path)
    procs = _spawn("ckpt_save", save_dir)
    try:
        want = [os.path.join(save_dir, f"saved.{r}") for r in range(2)]
        deadline = time.time() + TIMEOUT
        while not all(os.path.exists(f) for f in want):
            assert time.time() < deadline, "checkpoint files never appeared"
            early = [p for p in procs if p.poll() is not None]
            assert not early, "ckpt_save worker exited early:\n" + "\n".join(
                p.communicate()[0] for p in early)
            time.sleep(0.2)
        # both checkpoints written, the workers still computing: kill them
        assert all(p.poll() is None for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
    _wait_ok(_spawn("ckpt_resume", save_dir), "TORCH_MULTIHOST_CKPT_OK")


def test_dryrun_two_processes():
    out = subprocess.run(
        [sys.executable, "-m", "shermbot_navigation_tpu_torch.parallel.dryrun",
         "--processes", "2", "--local-shards", "4", "--device", "cpu",
         "--timeout", str(TIMEOUT - 30)],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    for rank in range(2):
        assert f"dryrun OK: rank={rank}/2" in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# The worker: python tests/test_torch_multihost.py <mode> <rank> <procs>
# <port> [dir]
# ---------------------------------------------------------------------------

def _inputs(N, M, B, T, known, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g, dtype=torch.float64)
    if known:
        zs = torch.stack([0.3 + 0.7 * u(B, T, M), (u(B, T, M) - 0.5) * 6], -1)
        ids = ((3 * torch.arange(T)[:, None] + 5 * torch.arange(M)) % N
               )[None].repeat(B, 1, 1) + torch.arange(B)[:, None, None]
        return ((u(B, T, 3) - 0.5) * 0.1, zs, u(B, T, M) < 0.9,
                (ids % N).int())
    ang = torch.arange(6, dtype=torch.float64) * torch.pi / 3
    world = torch.stack([4 + 3 * torch.cos(ang), 3 * torch.sin(ang)], -1)
    pts = world[(torch.arange(T)[:, None] * M + torch.arange(M)) % 6]
    pts = pts[None] + (u(B, T, M, 2) - 0.5) * 2e-4
    zs = torch.stack([pts.norm(dim=-1), torch.atan2(pts[..., 1],
                                                    pts[..., 0])], -1)
    return (torch.zeros(B, T, 3, dtype=torch.float64), zs,
            torch.ones(B, T, M, dtype=torch.bool), None)


def _run_ticks(cfg, M, mesh, inputs, deferred, known, st=None, t0=0,
               ticks=None):
    import torch
    from shermbot_navigation_tpu_torch.parallel import blocked_ekf as be
    tw, zs, valid, ids = inputs
    dec = []
    make = be.make_deferred_step if deferred else be.make_sequential_step
    step = make(cfg, M, "cpu", known=known, decisions=dec, mesh=mesh)
    if st is None:
        st = be.shard_state(be.init(cfg, tw.shape[0], dtype=torch.float64,
                                    device="cpu"), mesh)
    Q, R = torch.eye(3, dtype=torch.float64) * 1e-2, \
        torch.eye(2, dtype=torch.float64) * 1e-3
    for t in range(t0, t0 + (ticks or tw.shape[1] - t0)):
        a = (ids[:, t],) if known else ()
        st = step(st, tw[:, t], zs[:, t], valid[:, t], *a, Q, R)
    return st, dec


def _max_err(a, b):
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(a, b))


def _check_pair(name, got, want, dec, dec1, tol):
    import torch
    for f in ("n_seen", "seen"):
        assert torch.equal(getattr(got, f), getattr(want, f)), (name, f)
    for (k, g), (k1, g1) in zip(dec, dec1):
        assert torch.equal(k, k1) and torch.equal(g, g1), name
    err = _max_err(got, want)
    assert err <= tol, (name, err)
    return err


def _mode_full(mesh, rank):
    import torch
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.parallel import blocked_ekf as be
    from shermbot_navigation_tpu_torch.parallel import megamap, schur_dist
    from shermbot_navigation_tpu_torch.parallel.mesh import MapMesh
    N, M, B, T = 16, 3, 2, 4
    cfg = EKFConfig(num_landmarks=N)
    one = MapMesh(8, "cpu")
    for deferred in (False, True):
        for known in (True, False):
            inputs = _inputs(N, M, B, T, known)
            st, dec = _run_ticks(cfg, M, mesh, inputs, deferred, known)
            ref, dec1 = _run_ticks(cfg, M, one, inputs, deferred, known)
            got = be.unshard_state(st, mesh)
            err = _check_pair(f"deferred={deferred} known={known}", got,
                              be.unshard_state(ref, one), dec, dec1, 1e-12)
            print(f"rank={rank} deferred={deferred} known={known} "
                  f"n_seen={got.n_seen.tolist()} max_err={err}", flush=True)
    # the Schur GN step: 2 x 4 shards against 1 x 8
    prob = megamap.synthesize(32, 16, 3, dtype=torch.float64)
    part = schur_dist.partition_problem(prob.bundle, 8)
    kw = dict(T=16, N=32, M=part.obs_t.shape[0], cg_iters=24, gn_steps=2)
    got = schur_dist.make_sharded_gn(mesh, **kw)(part)
    want = schur_dist.make_sharded_gn(one, **kw)(part)
    lo = rank * 16
    err = max(_max_err([got.poses], [want.poses]),
              _max_err([got.landmarks], [want.landmarks[lo:lo + 16]]))
    assert err <= 1e-12, ("schur", err)
    print(f"rank={rank} schur max_err={err} collectives={mesh.collectives}",
          flush=True)
    print(f"rank={rank} TORCH_MULTIHOST_OK", flush=True)


def _mode_bign(mesh, rank):
    import torch
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.parallel import bigmap
    from shermbot_navigation_tpu_torch.parallel import blocked_ekf as be
    from shermbot_navigation_tpu_torch.parallel.mesh import MapMesh
    N, M, T = 2048, 8, 3
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, T, M, dtype=torch.float64, device="cpu")
    Q, R = bigmap.noise(torch.float64, "cpu")
    outs = []
    for m in (mesh, MapMesh(8, "cpu")):
        st = be.shard_state(be.init(cfg, 1, dtype=torch.float64,
                                    device="cpu"), m)
        st = bigmap.make_runner(cfg, M, "cpu", mesh=m)(st, wl, Q, R, 0, T)
        outs.append(be.unshard_state(st, m))
        del st
    got, want = outs
    err = _check_pair("bign", got, want, [], [], 1e-12)
    assert got.n_seen.tolist() == [T * M]
    print(f"rank={rank} bign max_err={err} gathers={mesh.collectives}",
          flush=True)
    print(f"rank={rank} TORCH_MULTIHOST_BIGN_OK", flush=True)


CKPT = dict(N=16, M=3, B=2, T=6, half=3)


def _mode_ckpt_save(mesh, rank, out_dir):
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.pipeline import checkpoint
    N, M, B, T, half = (CKPT[k] for k in ("N", "M", "B", "T", "half"))
    cfg = EKFConfig(num_landmarks=N)
    inputs = _inputs(N, M, B, T, True, seed=3)
    st, _ = _run_ticks(cfg, M, mesh, inputs, True, True, ticks=half)
    checkpoint.save_sharded(os.path.join(out_dir, "ckpt"), st, mesh,
                            step=half)
    open(os.path.join(out_dir, f"saved.{rank}"), "w").close()
    while True:      # keep computing until the parent kills this process
        st, _ = _run_ticks(cfg, M, mesh, inputs, True, True, st=st,
                           t0=half)


def _mode_ckpt_resume(mesh, rank, out_dir):
    import torch
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.parallel import blocked_ekf as be
    from shermbot_navigation_tpu_torch.parallel import mesh as ml
    from shermbot_navigation_tpu_torch.pipeline import checkpoint
    N, M, B, T, half = (CKPT[k] for k in ("N", "M", "B", "T", "half"))
    cfg = EKFConfig(num_landmarks=N)
    inputs = _inputs(N, M, B, T, True, seed=3)
    like = be.shard_state(be.init(cfg, B, dtype=torch.float64, device="cpu"),
                          mesh)
    path = os.path.join(out_dir, "ckpt")
    st, step = checkpoint.load_sharded(path, like, mesh)
    assert step == half, step
    resumed, _ = _run_ticks(cfg, M, mesh, inputs, True, True, st=st, t0=half)
    straight, _ = _run_ticks(cfg, M, mesh, inputs, True, True)
    for f in be.BlockedState._fields:
        assert torch.equal(getattr(resumed, f), getattr(straight, f)), f
    # another layout of the same two processes: refused
    other = ml.make_mesh(data=2, map_=4, local_shards=4, device="cpu")
    try:
        checkpoint.load_sharded(path, like, other)
    except ValueError as e:
        assert "layout" in str(e), e
    else:
        raise AssertionError("a changed layout was not refused")
    print(f"rank={rank} n_seen={straight.n_seen[0].tolist()}", flush=True)
    print(f"rank={rank} TORCH_MULTIHOST_CKPT_OK", flush=True)


def _worker(mode, rank, procs, port, *extra):
    sys.path.insert(0, ROOT)
    import torch
    from shermbot_navigation_tpu_torch.parallel import mesh as ml
    torch.set_num_threads(1)
    ml.initialize_distributed("gloo", f"tcp://localhost:{port}", rank, procs)
    mesh = ml.make_mesh(map_=8, local_shards=4, device="cpu")
    assert (mesh.shards, mesh.procs, mesh.rank) == (8, 2, rank)
    modes = {"full": _mode_full, "bign": _mode_bign,
             "ckpt_save": _mode_ckpt_save, "ckpt_resume": _mode_ckpt_resume}
    modes[mode](mesh, rank, *extra)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), *sys.argv[5:])
