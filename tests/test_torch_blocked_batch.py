"""Config 4 for B worlds (parallel/blocked_ekf.py, parallel/bigmap.py)
against the JAX reference, on the CPU.

The port's sequential tick (``make_sequential_step``) and its batched
deferred tick (``make_deferred_step`` at B worlds, the plain scan and grid
pass) take the same numpy inputs as the JAX package's ``make_sharded_step``
/ ``make_sharded_unknown_step`` / ``make_sharded_deferred_step`` /
``make_sharded_deferred_unknown_step`` on a one-device mesh (the XLA scan
and ``reference_grid_update``), at f64 and B=3 worlds that differ in
state, twists, measurements, ids and validity. The two packages differ in
summation order only: 1e-9 on every field, the decisions (``n_seen``,
``seen``) exactly. The port's deferred tick is held to its sequential one
at the JAX package's own tolerances (``test_deferred_matches_sequential``:
1e-10 on means, 1e-9 on the robot blocks, 1e-8 on the seen grid), and a
batched tick to B separate one-world ticks bit for bit.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import assert_state_close, jax_to_numpy
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu.parallel import bigmap as jbigmap
from shermbot_navigation_tpu.parallel import blocked_ekf as jblocked
from shermbot_navigation_tpu.parallel.mesh import make_mesh
from shermbot_navigation_tpu.pipeline import metrics as jmetrics
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as tgu
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as tsq
from shermbot_navigation_tpu_torch.parallel import bigmap as tbigmap
from shermbot_navigation_tpu_torch.parallel import blocked_ekf as tblocked
from shermbot_navigation_tpu_torch.pipeline import metrics as tmetrics
from shermbot_navigation_tpu_torch.utils import convert

N, M, B = 32, 4, 3
Q_KNOWN = np.diag([0.01, 0.01, 0.01])
Q_UNKNOWN = np.diag([1e-4] * 3)
R2 = np.diag([1e-3, 1e-3])
F64 = torch.float64


def _known_inputs(T, seed=0):
    """(twists (B, T, 3), zs (B, T, M, 2), valid (B, T, M), ids (B, T, M))
    from a numpy seed: world b revisits slots b..b+7, so later ticks update
    what earlier ones init; tick 0 repeats a slot (init, then updates in
    the same tick), and ticks 1 and 2 carry ids -1 and N (no-ops)."""
    rng = np.random.default_rng(seed)
    twists = rng.uniform(-0.05, 0.05, (B, T, 3))
    zs = np.stack([rng.uniform(0.3, 1.0, (B, T, M)),
                   rng.uniform(-3, 3, (B, T, M))], axis=-1)
    valid = rng.uniform(size=(B, T, M)) < 0.9
    ids = ((np.arange(T)[:, None] + np.arange(M)[None, :]) % 8)[None] \
        + np.arange(B)[:, None, None]
    ids[:, 0] = np.array([0, 0, 1, 0])[None] + np.arange(B)[:, None]
    ids[:, 1 % T, 0] = -1
    ids[:, 2 % T, 3] = N
    return twists, zs, valid, ids.astype(np.int32)


def _unknown_inputs(T, n_points=40, seed=2):
    """Unknown association: still robots measuring (noise 1e-4) ``n_points``
    > N world points 0.79 m apart on a circle, world b's circle turned by
    0.1 b rad, in a sweep: first sightings create landmarks until the map
    is full and then overflow (stopping their world's tick), later ones
    revisit. Valid except one slot a world."""
    rng = np.random.default_rng(seed)
    zs = []
    for b in range(B):
        ang = np.arange(n_points) * 2 * np.pi / n_points + 0.1 * b
        world = np.stack([7 + 5 * np.cos(ang), 5 * np.sin(ang)], axis=-1)
        pts = world[(np.arange(T)[:, None] * M + np.arange(M)[None, :])
                    % n_points] + rng.normal(0, 1e-4, (T, M, 2))
        zs.append(np.stack([np.hypot(pts[..., 0], pts[..., 1]),
                            np.arctan2(pts[..., 1], pts[..., 0])], axis=-1))
    valid = np.ones((B, T, M), bool)
    valid[np.arange(B), (1 + np.arange(B)) % T, 2] = False
    return (np.zeros((B, T, 3)), np.stack(zs), valid,
            np.zeros((B, T, M), np.int32))


def _jax_state(cfg, mesh):
    st = jblocked.init(cfg, B, dtype=jnp.float64)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), st,
        jblocked.state_sharding(mesh))


JAX_STEPS = {
    (False, True): jblocked.make_sharded_step,
    (False, False): jblocked.make_sharded_unknown_step,
    (True, True): jblocked.make_sharded_deferred_step,
    (True, False): jblocked.make_sharded_deferred_unknown_step,
}


def _port_step(deferred, known, decisions=None):
    cfg = tekf.EKFConfig(num_landmarks=N)
    make = (tblocked.make_deferred_step if deferred
            else tblocked.make_sequential_step)
    return make(cfg, M, "cpu", known=known, decisions=decisions)


def _run_port(step, inputs, known, state=None, ticks=None):
    twists, zs, valid, ids = (torch.from_numpy(x) for x in inputs)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = state if state is not None else tblocked.init(
        cfg, twists.shape[0], dtype=F64, device="cpu")
    Q = torch.from_numpy(Q_KNOWN if known else Q_UNKNOWN)
    R = torch.from_numpy(R2)
    for t in range(ticks or twists.shape[1]):
        idt = (ids[:, t],) if known else ()
        st = step(st, twists[:, t], zs[:, t], valid[:, t], *idt, Q, R)
    return st


@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["sequential", "deferred"])
def test_steps_match_jax_f64(deferred, known):
    """The port's sequential and batched deferred ticks against their JAX
    counterparts over 5 known ticks (inits, a repeated slot, updates,
    out-of-range ids) or 12 unknown ticks (creation, overflow, revisits),
    B=3 worlds that differ: decisions equal, state to 1e-9."""
    T = 5 if known else 12
    inputs = _known_inputs(T) if known else _unknown_inputs(T)
    jcfg = jekf.EKFConfig(num_landmarks=N)
    mesh = make_mesh(jax.devices()[:1], data=1)
    jstep = JAX_STEPS[deferred, known](jcfg, mesh, B, M)
    jst = _jax_state(jcfg, mesh)
    Q = jnp.asarray(Q_KNOWN if known else Q_UNKNOWN)
    R = jnp.asarray(R2)
    for t in range(T):
        args = [jnp.asarray(x[:, t]) for x in inputs]
        jst = jstep(jst, *args[:4 if known else 3], Q, R)
    want = jax_to_numpy(jst)
    got = _run_port(_port_step(deferred, known), inputs, known)
    assert np.abs(want["mean_m"][0] - want["mean_m"][1]).max() > 0.1
    if not known:
        assert (want["n_seen"] == N).all()            # the maps filled
    assert_state_close(got, want, 1e-9)


@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
def test_deferred_matches_sequential(known):
    """The port's copy of the JAX package's
    ``test_deferred_matches_sequential``, at B=3 and its tolerances; and
    each measurement's recorded decision (kind and slot) equal at every
    tick, with every kind present."""
    T = 5 if known else 12
    inputs = _known_inputs(T, seed=5) if known else _unknown_inputs(T)
    dec_a, dec_b = [], []
    a = _run_port(_port_step(False, known, dec_a), inputs, known)
    b = _run_port(_port_step(True, known, dec_b), inputs, known)
    assert len(dec_a) == len(dec_b) == T
    for (ka, ga), (kb, gb) in zip(dec_a, dec_b):
        assert ka.shape == (B, M) and torch.equal(ka, kb)
        assert torch.equal(ga, gb)
        assert torch.equal(ga >= 0, ka > 0)
    assert set(torch.stack([k for k, _ in dec_a]).unique().tolist()) == {
        0, 1, 2}
    assert torch.equal(a.n_seen, b.n_seen)
    assert torch.equal(a.seen, b.seen)
    for f, tol in (("mean_r", 1e-10), ("mean_m", 1e-10), ("cov_rr", 1e-9),
                   ("cov_rm", 1e-9), ("diag4", 1e-9)):
        np.testing.assert_allclose(getattr(a, f).numpy(),
                                   getattr(b, f).numpy(), atol=tol,
                                   rtol=0, err_msg=f)
    for w in range(B):
        ns = int(a.n_seen[w])
        np.testing.assert_allclose(a.cov_mm[w][:, :, :ns, :ns].numpy(),
                                   b.cov_mm[w][:, :, :ns, :ns].numpy(),
                                   atol=1e-8, rtol=0)


@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
@pytest.mark.parametrize("deferred", [False, True],
                         ids=["sequential", "deferred"])
def test_batched_step_equals_separate_worlds(deferred, known):
    """A tick of B worlds that differ (each starts from its own state and
    takes its own inputs) equals B separate one-world ticks: no world reads
    another's operands. f32, as on the card, bit for bit."""
    T = 4 if known else 10
    inputs = _known_inputs(T, seed=9) if known else _unknown_inputs(T)
    inputs = tuple(x.astype(np.float32) if x.dtype == np.float64 else x
                   for x in inputs)
    cfg = tekf.EKFConfig(num_landmarks=N)
    step = _port_step(deferred, known)

    def run(x, st):
        twists, zs, valid, ids = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in x)
        Q = torch.from_numpy(Q_KNOWN if known else Q_UNKNOWN).float()
        R = torch.from_numpy(R2).float()
        for t in range(twists.shape[1]):
            idt = (ids[:, t],) if known else ()
            st = step(st, twists[:, t], zs[:, t], valid[:, t], *idt, Q, R)
        return st

    # world b starts from the state its own inputs leave after b ticks
    starts = [run(tuple(x[b:b + 1, :b] for x in inputs),
                  tblocked.init(cfg, 1, device="cpu")) for b in range(B)]
    start = tblocked.BlockedState(*(torch.cat(f) for f in zip(*starts)))
    rest = tuple(x[:, B:] for x in inputs)
    together = run(rest, tblocked.BlockedState(*(f.clone() for f in start)))
    for b in range(B):
        alone = run(tuple(x[b:b + 1] for x in rest),
                    tblocked.BlockedState(*(f[b:b + 1].clone()
                                            for f in start)))
        for f in tblocked.BlockedState._fields:
            g, w = getattr(together, f)[b:b + 1], getattr(alone, f)
            assert torch.equal(g, w), f


@pytest.mark.parametrize("deferred", [True, False],
                         ids=["deferred", "sequential"])
def test_run_bigmap_batch_matches_jax_f64(deferred):
    """``run_bigmap(batch=2)`` end to end against the JAX ``run_bigmap`` at
    batch 2 (deferred; the sequential tick has its semantics), T=12 > N/M
    ticks so the last ones update a full map; the pose error via
    ``ate``."""
    Nb, T, Mb = 32, 12, 4
    js, jwl = jbigmap.run_bigmap(N=Nb, T=T, M=Mb, batch=2,
                                 dtype=jnp.float64)
    ts, twl = tbigmap.run_bigmap(N=Nb, T=T, M=Mb, batch=2, deferred=deferred,
                                 dtype=F64, device="cpu")
    assert ts.n_seen.tolist() == [Nb, Nb]
    assert_state_close(ts, jax_to_numpy(js), 1e-9)
    jtrue = jbigmap._true_pose(jwl.cmd, jnp.float64(T), jnp.float64)
    ttrue = tbigmap._true_pose(twl.cmd, torch.tensor(float(T), dtype=F64))
    jerr = float(jmetrics.ate(js.mean_r[:, 1:], jtrue[None, 1:]))
    terr = float(tmetrics.ate(ts.mean_r[:, 1:], ttrue[None, 1:]))
    assert np.isfinite(terr)
    np.testing.assert_allclose(terr, jerr, atol=1e-9)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("known", [True, False], ids=["known", "unknown"])
def test_batched_ticks_loop_over_no_world(known):
    """No loop over the worlds: the sequential tick, and the deferred
    tick's own part (predict and the grid pass's operands) with the
    kernels' plain versions, which run one world at a time on the CPU, left
    out, dispatch as many ATen ops at B=3 as at B=2; a ``torch.func``
    fallback warning (a batching rule missing, so a loop over the worlds)
    would be an error."""
    T = 3
    inputs = _known_inputs(T) if known else _unknown_inputs(T)
    counts = []
    for b in (2, B):
        x = tuple(a[:b] for a in inputs)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            with _CountOps() as ops:
                _run_port(_port_step(False, known), x, known)
            st = _run_port(_port_step(False, known), x, known, ticks=1)
            with _CountOps() as glue:
                tblocked._predict_shard(
                    tekf.EKFConfig(num_landmarks=N), st,
                    torch.from_numpy(x[0][:, 0]), torch.from_numpy(Q_KNOWN))
                tblocked.grid_operands(
                    *(torch.zeros((b, M, 4, N), dtype=F64) for _ in range(3)),
                    torch.zeros((b, M), dtype=torch.int32),
                    torch.zeros((b, M), dtype=torch.int32))
        counts.append((ops.n, glue.n))
    assert counts[0] == counts[1], counts


def test_blocked_state_convert_carries_worlds():
    """``utils/convert`` carries a B-world state both ways, bit for bit
    and dtype for dtype: a JAX state after two known ticks at B=3 in, the
    port's out."""
    inputs = _known_inputs(2)
    jcfg = jekf.EKFConfig(num_landmarks=N)
    mesh = make_mesh(jax.devices()[:1], data=1)
    jstep = jblocked.make_sharded_step(jcfg, mesh, B, M)
    jst = _jax_state(jcfg, mesh)
    for t in range(2):
        jst = jstep(jst, *(jnp.asarray(x[:, t]) for x in inputs),
                    jnp.asarray(Q_KNOWN), jnp.asarray(R2))
    want = jax_to_numpy(jst)
    st = convert.blocked_state_from_numpy(want, "cpu")
    assert st.cov_mm.shape == (B, 2, 2, N, N) and st.n_seen.shape == (B,)
    back = convert.blocked_state_to_numpy(st)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        assert back[k].dtype == want[k].dtype, k
    # and the port steps it on to the JAX result
    got = _port_step(False, True)(
        st, *(torch.from_numpy(x[:, 1]) for x in inputs),
        torch.from_numpy(Q_KNOWN), torch.from_numpy(R2))
    jst = jstep(jst, *(jnp.asarray(x[:, 1]) for x in inputs),
                jnp.asarray(Q_KNOWN), jnp.asarray(R2))
    assert_state_close(got, jax_to_numpy(jst), 1e-9)


def test_kernel_wrappers_take_worlds_and_keep_one_world():
    """The two kernels' plain versions and operand checks at B worlds: the
    batched grid pass and scan equal their one-world calls world by world
    (the plain scan runs the worlds in turn), the one-world forms keep
    their shapes, and the kernels' operand checks take either form."""
    inputs = _known_inputs(3)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = _run_port(_port_step(True, True), inputs, True, ticks=2)
    st = st._replace(cov_mm=st.cov_mm.float(), **{
        f: getattr(st, f).float() for f in ("mean_r", "mean_m", "cov_rr",
                                            "cov_rm", "diag4")})
    args = (st.mean_r, st.mean_m.transpose(1, 2).contiguous(), st.cov_rr,
            st.cov_rm.permute(0, 1, 3, 2).reshape(B, 6, N), st.diag4,
            st.seen, st.n_seen, st.cov_mm.reshape(B, 4, N, N),
            torch.from_numpy(inputs[1][:, 2]).float(),
            torch.from_numpy(inputs[2][:, 2]),
            torch.from_numpy(inputs[3][:, 2]), torch.from_numpy(R2).float())
    both = tsq.deferred_seq_scan(*args)
    assert both[6].shape == (B,) and both[7].shape == (B, M, 4, N)
    ops = tblocked.grid_operands(*both[7:])
    cov = st.cov_mm.clone()
    tgu.fused_grid_update(cov, *ops)
    for b in range(B):
        one = tsq.deferred_seq_scan(*(a[b] for a in args[:-1]), args[-1])
        assert one[6].shape == () and one[7].shape == (M, 4, N)
        for x, y in zip(both, one):
            assert torch.equal(x[b], y)
        ops1 = tblocked.grid_operands(*one[7:])
        for x, y in zip(ops, ops1):
            assert torch.equal(x[b], y)
        torch.testing.assert_close(
            cov[b], tgu.reference_grid_update(st.cov_mm[b], *ops1),
            rtol=0, atol=1e-6)
    got, n, m = tsq.kernel_operands(*args)
    assert (n, m) == (N, M) and got["mm0p"].shape == (B, 4, N, N)
    got, nl, n, m = tgu.kernel_operands(cov, *ops)
    assert (nl, n, m) == (N, N, M) and got["a"].shape == (B, 2, N, 2 * M)
    with pytest.raises(ValueError, match="rowt must be"):
        tgu.kernel_operands(cov, *ops[:4], ops[4][:1], ops[5])
    with pytest.raises(ValueError, match="valid must be"):
        tsq.kernel_operands(*args[:9], args[9][:1], *args[10:])


def test_launch_plans_take_worlds():
    """Kernel 1's plan counts the worlds' blocks and walks no shorter for
    them; kernel 2's plan keeps its default cluster while the card holds
    every world's cluster at once, and otherwise takes the largest smaller
    cluster that fits them all (none fitting: the default), from the
    card's answer ``max_active``."""
    one = tgu.launch_plan(2048, 2048, 8)
    eight = tgu.launch_plan(2048, 2048, 8, batch=8)
    assert eight["blocks"] == 8 * one["blocks"]
    assert eight["rows_per_block"] == one["rows_per_block"]
    assert tgu.launch_plan(256, 512, 8)["rows_per_block"] == 16
    assert tgu.launch_plan(256, 512, 8, batch=8)["rows_per_block"] == 32
    with pytest.raises(ValueError, match=">= 1"):
        tgu.launch_plan(64, 64, 4, batch=0)

    default = tsq.launch_plan(2048, 8)
    assert default["cluster"] == 8
    fits = {8: 33, 4: 33, 2: 66, 1: 132}
    active = lambda plan: fits[plan["cluster"]]
    assert tsq.launch_plan(2048, 8, batch=33, max_active=active) == default
    assert tsq.launch_plan(2048, 8, batch=60,
                           max_active=active)["cluster"] == 2
    assert tsq.launch_plan(2048, 8, batch=128,
                           max_active=active)["cluster"] == 1
    assert tsq.launch_plan(2048, 8, batch=500, max_active=active) == default
    assert tsq.launch_plan(2048, 8, cluster=4, batch=500,
                           max_active=active)["cluster"] == 4
    with pytest.raises(ValueError, match="batch"):
        tsq.launch_plan(2048, 8, batch=0)


@pytest.mark.parametrize("pose", [None, [0.3, -1.5, 2.25]],
                         ids=["origin", "pose"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_equals_jax_bit_for_bit(dtype, pose):
    """``blocked_ekf.init`` at N=64, B=2 against the JAX ``init``: every
    field equal bit for bit, dtype for dtype (the INT_MAX prior on the
    planes' two diagonals and in ``diag4``, zeros elsewhere)."""
    n, b = 64, 2
    want = jblocked.init(jekf.EKFConfig(num_landmarks=n), b, robot_pose=pose,
                         dtype=getattr(jnp, dtype))
    got = tblocked.init(tekf.EKFConfig(num_landmarks=n), b, robot_pose=pose,
                        dtype=getattr(torch, dtype), device="cpu")
    for f in tblocked.BlockedState._fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f)


class _Allocations(TorchDispatchMode):
    """Bytes of every storage the dispatched ops create (views and
    in-place ops create none); the outputs are kept alive so no address is
    reused and counted once for two allocations."""

    def __init__(self):
        super().__init__()
        self.storages, self._keep = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.storages.setdefault(s.data_ptr(), s.nbytes())
                self._keep.append(t)
        return out


def test_init_allocates_only_the_state():
    """``blocked_ekf.init`` creates no temporary of the grid's size: all it
    allocates is within 1% of the state's own bytes (an ``eye(N)``, a
    broadcast product or a ``repeat`` of the planes would add 0.1-1.0x).
    The card's peak allocation is held the same way by
    ``tests/test_torch_cuda.py::test_init_peak_memory_is_the_state``."""
    cfg = tekf.EKFConfig(num_landmarks=64)
    with _Allocations() as mode:
        st = tblocked.init(cfg, 2, robot_pose=[0.0, 1.0, 2.0], device="cpu")
    state_bytes = sum(x.untyped_storage().nbytes() for x in st)
    assert state_bytes >= 16 * 64 * 64 * 2
    assert sum(mode.storages.values()) <= 1.01 * state_bytes
