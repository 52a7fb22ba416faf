"""Config 4 over S map shards (parallel/mesh.py, parallel/blocked_ekf.py,
parallel/bigmap.py) against the JAX package on the conftest's 8 virtual
CPU devices, in f64.

The port holds S = 1, 2, 4, 8 shards in one process (a leading
local-shard axis); the JAX package holds one shard a device of a
``map = S`` mesh. The same numpy inputs (B=2 worlds that differ, M=3, 4
ticks; known ids with a repeated slot and out-of-range ids, or unknown
association with inits and revisits) go through the sequential and the
deferred ticks of both. Tolerances are the JAX package's own pins
(``tests/test_blocked_ekf.py``): means 1e-9, covariances 1e-8; ``n_seen``
and ``seen`` exactly, and each tick's decisions equal to the port's
unsharded tick's. The shard grid operands (local ``rowT``, global
``colT``) are held to the JAX lines that build them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_parity import jax_to_numpy
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu.parallel import bigmap as jbigmap
from shermbot_navigation_tpu.parallel import blocked_ekf as jblocked
from shermbot_navigation_tpu.parallel.mesh import make_mesh as jmake_mesh
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.parallel import bigmap as tbigmap
from shermbot_navigation_tpu_torch.parallel import blocked_ekf as tblocked
from shermbot_navigation_tpu_torch.parallel import mesh as tmesh

N, M, B, T = 32, 3, 2, 4
SHARDS = [1, 2, 4, 8]
Q = np.diag([1e-2] * 3)
R2 = np.diag([1e-3, 1e-3])
MEAN_TOL, COV_TOL = 1e-9, 1e-8
TOLS = {"mean_r": MEAN_TOL, "mean_m": MEAN_TOL, "cov_rr": COV_TOL,
        "cov_rm": COV_TOL, "cov_mm": COV_TOL, "diag4": COV_TOL}


def _inputs(known: bool, seed=0):
    """(twists (B, T, 3), zs (B, T, M, 2), valid, ids) from a seed. Known:
    world b revisits slots 3b..3b+7 (spread over the shards), tick 0
    repeats a slot, ticks 1 and 2 carry ids -1 and N. Unknown: points 0.9
    m apart on a circle, revisited from tick 2 on."""
    rng = np.random.default_rng(seed)
    if known:
        twists = rng.uniform(-0.05, 0.05, (B, T, 3))
        zs = np.stack([rng.uniform(0.3, 1.0, (B, T, M)),
                       rng.uniform(-3, 3, (B, T, M))], axis=-1)
        ids = ((5 * np.arange(T)[:, None] + 3 * np.arange(M)) % N)[None] \
            + 3 * np.arange(B)[:, None, None]
        ids = ids % N
        ids[:, 0] = np.array([7, 7, 21])[None] + np.arange(B)[:, None]
        ids[:, 1, 0] = -1
        ids[:, 2, 2] = N
        valid = rng.uniform(size=(B, T, M)) < 0.9
        return twists, zs, valid, ids.astype(np.int32)
    zs = []
    for b in range(B):
        ang = np.arange(6) * 2 * np.pi / 6 + 0.2 * b
        world = np.stack([4 + 3 * np.cos(ang), 3 * np.sin(ang)], axis=-1)
        pts = world[(np.arange(T)[:, None] * M + np.arange(M)) % 6] \
            + rng.normal(0, 1e-4, (T, M, 2))
        zs.append(np.stack([np.hypot(pts[..., 0], pts[..., 1]),
                            np.arctan2(pts[..., 1], pts[..., 0])], axis=-1))
    valid = np.ones((B, T, M), bool)
    valid[1, 3, 1] = False
    return (np.zeros((B, T, 3)), np.stack(zs), valid,
            np.zeros((B, T, M), np.int32))


JAX_STEPS = {
    (False, True): jblocked.make_sharded_step,
    (False, False): jblocked.make_sharded_unknown_step,
    (True, True): jblocked.make_sharded_deferred_step,
    (True, False): jblocked.make_sharded_deferred_unknown_step,
}


def _jax_run(S, deferred, known, inputs):
    jcfg = jekf.EKFConfig(num_landmarks=N)
    mesh = jmake_mesh(jax.devices()[:S], data=1, map_=S)
    step = JAX_STEPS[deferred, known](jcfg, mesh, B, M)
    st = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        jblocked.init(jcfg, B, dtype=jnp.float64),
        jblocked.state_sharding(mesh))
    for t in range(T):
        args = [jnp.asarray(x[:, t]) for x in inputs]
        st = step(st, *args[:4 if known else 3], jnp.asarray(Q),
                  jnp.asarray(R2))
    return jax_to_numpy(st)


def _port_run(mesh, deferred, known, inputs):
    """The port's tick from the global prior, on ``mesh``'s shards (or the
    global state with ``mesh=None``): (global state, decisions)."""
    cfg = tekf.EKFConfig(num_landmarks=N)
    dec = []
    make = (tblocked.make_deferred_step if deferred
            else tblocked.make_sequential_step)
    step = make(cfg, M, "cpu", known=known, decisions=dec, mesh=mesh)
    st = tblocked.init(cfg, B, dtype=torch.float64, device="cpu")
    if mesh is not None:
        st = tblocked.shard_state(st, mesh)
    twists, zs, valid, ids = (torch.from_numpy(x) for x in inputs)
    for t in range(T):
        idt = (ids[:, t],) if known else ()
        st = step(st, twists[:, t], zs[:, t], valid[:, t], *idt,
                  torch.from_numpy(Q), torch.from_numpy(R2))
    if mesh is not None:
        assert st.cov_mm.shape == (mesh.local_shards, B, 2, 2,
                                   N // mesh.shards, N)
        st = tblocked.unshard_state(st, mesh)
    return st, dec


def _one_process(S):
    return tmesh.make_mesh(map_=S, local_shards=S, device="cpu")


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["sequential", "deferred"])
def test_sharded_ticks_match_jax_mesh(deferred, known, S):
    """S local shards of the port against the JAX tick on a map=S mesh:
    means 1e-9, covariances 1e-8, n_seen and seen exactly; decisions equal
    to the port's unsharded tick at every tick."""
    inputs = _inputs(known)
    want = _jax_run(S, deferred, known, inputs)
    got, dec = _port_run(_one_process(S), deferred, known, inputs)
    _, dec1 = _port_run(None, deferred, known, inputs)
    for f, w in want.items():
        g = getattr(got, f).numpy()
        if f in TOLS:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOLS[f],
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert len(dec) == len(dec1) == T
    for (k, g), (k1, g1) in zip(dec, dec1):
        assert torch.equal(k, k1) and torch.equal(g, g1)
    kinds = set(torch.stack([k for k, _ in dec]).unique().tolist())
    assert kinds == {0, 1, 2}
    assert (want["n_seen"] > 0).all()


def _jax_grid_operands(mesh, Kb, HSb, CRb, gb, kb):
    """The JAX deferred tick's grid-pass operands, its lines verbatim
    (``blocked_ekf._make_sharded_deferred``, after the scan), on a
    map-sharded mesh: Kb/HSb/CRb (M, 4, N) sharded on the lanes."""
    M_, _, Ntot = Kb.shape
    n_local = Ntot // mesh.shape["map"]

    def fn(Kb, HSb, CRb, gb, kb):
        off = jax.lax.axis_index("map").astype(jnp.int32) * n_local
        HSfull = jax.lax.all_gather(HSb, "map", axis=2, tiled=True)
        CRfull = jax.lax.all_gather(CRb, "map", axis=2, tiled=True)
        iota = jnp.arange(M_, dtype=jnp.int32)
        is_init_op = kb == 2
        grow = off + jnp.arange(n_local, dtype=jnp.int32)
        gcol = jnp.arange(Ntot, dtype=jnp.int32)
        rowT = jnp.max(jnp.where(is_init_op[:, None]
                                 & (gb[:, None] == grow[None, :]),
                                 iota[:, None], -1), axis=0)
        colT = jnp.max(jnp.where(is_init_op[:, None]
                                 & (gb[:, None] == gcol[None, :]),
                                 iota[:, None], -1), axis=0)
        Kmask = Kb * (iota[:, None] > rowT[None, :])[:, None, :].astype(
            Kb.dtype)
        HSmask = HSfull * (iota[:, None] > colT[None, :])[:, None, :].astype(
            HSfull.dtype)
        A = jnp.transpose(Kmask.reshape(M_, 2, 2, n_local),
                          (1, 3, 0, 2)).reshape(2, n_local, 2 * M_)
        Bm = jnp.transpose(HSmask.reshape(M_, 2, 2, Ntot),
                           (1, 0, 2, 3)).reshape(2, 2 * M_, Ntot)
        crow = jnp.transpose(CRfull.reshape(M_, 2, 2, Ntot), (1, 2, 0, 3))
        ccol = jnp.transpose(CRb.reshape(M_, 2, 2, n_local), (2, 1, 3, 0))
        return (A[None], Bm[None], crow[None], ccol[None], rowT[None],
                colT[None])

    lane = P(None, None, "map")
    out = P("map")
    f = shard_map(fn, mesh=mesh, in_specs=(lane, lane, lane, P(), P()),
                  out_specs=(out,) * 6, check_vma=False)
    return [np.asarray(x) for x in jax.jit(f)(Kb, HSb, CRb, gb, kb)]


@pytest.mark.parametrize("S", [2, 8])
def test_shard_grid_operands_match_jax(S):
    """``grid_operands`` of S local shards (rowT over each shard's local
    rows, colT over the global columns) against the JAX lines, shard by
    shard, bit for bit: a tick that inits slot 3 twice and slots in other
    shards between updates."""
    rng = np.random.default_rng(4)
    Mo = 6
    bufs = [rng.normal(size=(Mo, 4, N)) for _ in range(3)]
    gb = np.array([3, 1, N - 2, 3, N // 2 + 1, -1], np.int32)
    kb = np.array([2, 1, 2, 2, 1, 0], np.int32)
    mesh = jmake_mesh(jax.devices()[:S], data=1, map_=S)
    want = _jax_grid_operands(mesh, *(jnp.asarray(x) for x in bufs),
                              jnp.asarray(gb), jnp.asarray(kb))
    Nl = N // S
    # this process's shards of the scan's buffers: (L, B=1, M, 4, Nl)
    local = [torch.from_numpy(x).reshape(Mo, 4, S, Nl).permute(2, 0, 1, 3)
             [:, None] for x in bufs]
    got = tblocked.grid_operands(*local, torch.from_numpy(gb)[None],
                                 torch.from_numpy(kb)[None],
                                 mesh=_one_process(S))
    # the (L * B) fold, B=1: plane set s is shard s
    names = ("A", "Bm", "crow", "ccol", "rowT", "colT")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[4][3 // Nl, 3 % Nl]) == 3
    assert int(got[5][0, N - 2]) == 2


@pytest.mark.parametrize("S", SHARDS)
def test_shard_then_unshard_is_the_identity(S):
    rng = np.random.default_rng(S)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = tblocked.init(cfg, B, dtype=torch.float64, device="cpu")
    st = tblocked.BlockedState(*(
        torch.from_numpy(rng.normal(size=x.shape)) if x.is_floating_point()
        else torch.from_numpy(rng.integers(0, 2, x.shape)).to(x.dtype)
        for x in st))
    mesh = _one_process(S)
    sharded = tblocked.shard_state(st, mesh)
    assert sharded.cov_mm.shape == (S, B, 2, 2, N // S, N)
    assert sharded.mean_r.shape == (S, B, 3)
    back = tblocked.unshard_state(sharded, mesh)
    for f in tblocked.BlockedState._fields:
        assert torch.equal(getattr(back, f), getattr(st, f)), f


def test_seq_kernel_at_several_shards_raises_and_auto_is_plain():
    cfg = tekf.EKFConfig(num_landmarks=N)
    mesh = _one_process(2)
    with pytest.raises(ValueError, match="one map shard"):
        tblocked.make_deferred_step(cfg, M, "cpu", gate_margins=[],
                                    mesh=mesh)
    with pytest.raises(ValueError, match="divisible"):
        tblocked.make_sequential_step(cfg, M, "cpu", mesh=_one_process(3))
    # auto: the plain sharded scan, no kernel
    tblocked.make_deferred_step(cfg, M, "cpu", mesh=mesh)


@pytest.mark.parametrize("deferred", [True, False],
                         ids=["deferred", "sequential"])
def test_run_bigmap_over_shards_matches_jax(deferred):
    """``run_bigmap(mesh=...)`` at 4 shards, 2 worlds, T=12 > N/M ticks,
    against the JAX ``run_bigmap`` on a map=4 mesh."""
    Nb, Tb, Mb = 32, 12, 4
    jmesh = jmake_mesh(jax.devices()[:4], data=1, map_=4)
    js, _ = jbigmap.run_bigmap(N=Nb, T=Tb, M=Mb, batch=2, mesh=jmesh,
                               dtype=jnp.float64)
    mesh = _one_process(4)
    ts, _ = tbigmap.run_bigmap(N=Nb, T=Tb, M=Mb, batch=2, deferred=deferred,
                               dtype=torch.float64, mesh=mesh)
    ts = tblocked.unshard_state(ts, mesh)
    want = jax_to_numpy(js)
    assert ts.n_seen.tolist() == [Nb, Nb]
    for f, w in want.items():
        g = getattr(ts, f).numpy()
        if f in TOLS:
            np.testing.assert_allclose(g, w, rtol=0, atol=TOLS[f],
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_sharded_checkpoint_crosses_packages(direction, tmp_path):
    """A ``save_sharded`` file of one package loads into the other's
    ``load_sharded`` bit for bit: the JAX package on a 1 x 2 ('data',
    'map') mesh of two virtual CPU devices, the port on a 1 x 2
    ``MapMesh`` (one process, two local shards); random values in every
    field, f32 as the card keeps them."""
    from shermbot_navigation_tpu.pipeline import checkpoint as jckpt
    from shermbot_navigation_tpu_torch.pipeline import checkpoint as tckpt
    rng = np.random.default_rng(11)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = tblocked.init(cfg, B, device="cpu")
    st = tblocked.BlockedState(*(
        torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
        if x.is_floating_point()
        else torch.from_numpy(rng.integers(0, 2 * N, x.shape)).to(x.dtype)
        for x in st))
    jmesh = jmake_mesh(jax.devices()[:2], data=1, map_=2)
    specs = jblocked.state_sharding(jmesh)
    jst = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.asarray(x.numpy()),
                                    NamedSharding(jmesh, s)),
        jblocked.BlockedState(*st), specs)
    mesh = tmesh.make_mesh(data=1, map_=2, local_shards=2, device="cpu")
    path = str(tmp_path / "ckpt")
    if direction == "jax_to_torch":
        jckpt.save_sharded(path, jst, step=5)
        like = tblocked.shard_state(tblocked.init(cfg, B, device="cpu"), mesh)
        got, step = tckpt.load_sharded(path, like, mesh)
        got = tblocked.unshard_state(got, mesh)
    else:
        tckpt.save_sharded(path, tblocked.shard_state(st, mesh), mesh, step=5)
        jlike = jblocked.init(jekf.EKFConfig(num_landmarks=N), B,
                              dtype=jnp.float32)
        got, step = jckpt.load_sharded(path, jlike, jmesh, specs)
        assert got.cov_mm.sharding.is_equivalent_to(
            NamedSharding(jmesh, specs.cov_mm), 5)
        got = jblocked.BlockedState(*(torch.from_numpy(np.array(x))
                                      for x in got))
    assert step == 5
    for f in tblocked.BlockedState._fields:
        g, w = getattr(got, f), getattr(st, f)
        assert g.dtype == w.dtype and torch.equal(g, w), f
