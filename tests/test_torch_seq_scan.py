"""The port's measurement scan (ops/kernels/seq_scan.py) against the JAX
reference's Pallas scan (ops/pallas/seq_scan.py, interpret mode), known
and unknown association: the same numpy inputs through both. The unknown
branch is also held against the JAX XLA deferred unknown tick.

Discrete outputs (slot kinds, slots, ``seen``, ``n_seen``) must be equal.
Continuous outputs get atol 1e-5, the tolerance
tests/test_seq_scan_kernel.py already uses between the Pallas scan and the
XLA scan: the Pallas kernel uses a polynomial atan2 (PARITY D14) and reads
grid column g as row g (D13), where the port's plain version, a twin of
the XLA scan, uses libm atan2 and exact columns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from _torch_parity import (_swept_state, jax_to_numpy, scan_inputs,
                           unknown_scan_inputs)
from shermbot_navigation_tpu.models.ekf_slam import EKFConfig as JConfig
from shermbot_navigation_tpu.ops.pallas import seq_scan as jsq
from shermbot_navigation_tpu.parallel import blocked_ekf as jblocked
from shermbot_navigation_tpu.parallel.mesh import make_mesh
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as tsq
from shermbot_navigation_tpu_torch.parallel import blocked_ekf

N, M = 64, 4
U = N - N // 8          # slots >= U stay unseen in the scan inputs' state
NAMES = ("mean_r", "mm2", "cov_rr", "rm6", "diag4", "seen", "n_seen", "Kb",
         "HSb", "CRb", "gb", "kindb")
DISCRETE = {"seen", "n_seen", "gb", "kindb"}


def _scan_inputs(ids, valid):
    return scan_inputs(N, M, ids, valid)


CASES = {
    # init then update of one slot, an update replaying that init's row
    "init_then_update": ([U + 4, 5, U + 4, 3], [1, 1, 1, 1]),
    # out-of-range ids and an invalid slot are no-ops around an init
    "noop_ids": ([N, U + 5, -1, 7], [1, 1, 1, 0]),
    "updates_only": ([1, 2, 1, 9], [1, 1, 1, 1]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_pallas_interpret(case):
    ids, valid = CASES[case]
    x = _scan_inputs(ids, valid)
    want = jsq.deferred_seq_scan(
        *(jnp.asarray(x[k]) for k in x), known=True,
        match_gate=0.01, new_gate=60.0, wrap_innovation=False,
        symmetrize=True, interpret=True)
    got = tsq.reference_seq_scan(
        *(torch.from_numpy(np.array(x[k])) for k in x))
    for name, g, w in zip(NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in DISCRETE:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=name)
    kinds = got[-1].tolist()
    if case == "init_then_update":
        assert kinds == [2, 1, 1, 1]
    elif case == "noop_ids":
        assert kinds == [0, 2, 0, 0] and got[-2].tolist() == [-1, U + 5,
                                                              -1, -1]


def test_out_of_range_id_is_noop():
    """Known association: an id outside [0, N) is a full no-op on the
    port's tick as on the JAX XLA tick (no phantom n_seen bump, no write
    to slot 0 or N-1)."""
    mesh = make_mesh(jax.devices()[:1], data=1)
    jcfg = JConfig(num_landmarks=N)
    jst = jblocked.init(jcfg, 1)
    specs = jblocked.state_sharding(mesh)
    jst = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jst, specs)
    jstep = jblocked.make_sharded_deferred_step(jcfg, mesh, 1, M)
    tw = np.zeros((1, 3), np.float32)
    zs = np.array([[[1.0, 0.1], [1.2, -0.4], [0.8, 0.9], [1.5, 2.0]]],
                  np.float32)
    valid = np.ones((1, M), bool)
    ids = np.array([[0, 1, N, -1]], np.int32)
    Q = np.diag([1e-4] * 3).astype(np.float32)
    R = np.diag([1e-3] * 2).astype(np.float32)
    a = jstep(jst, *map(jnp.asarray, (tw, zs, valid, ids, Q, R)))

    cfg = EKFConfig(num_landmarks=N)
    step = blocked_ekf.make_deferred_step(cfg, M, "cpu")
    b = step(blocked_ekf.init(cfg, 1, device="cpu"),
             *map(torch.from_numpy, (tw, zs, valid, ids, Q, R)))
    assert int(a.n_seen[0]) == int(b.n_seen[0]) == 2
    np.testing.assert_array_equal(np.asarray(a.seen), b.seen.numpy())
    assert b.seen[0, :2].all() and not bool(b.seen[0, N - 1])
    want = jax_to_numpy(a)
    for k in ("mean_r", "mean_m"):
        np.testing.assert_allclose(getattr(b, k).numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)


def test_wrapper_routes_cpu_to_plain():
    x = _scan_inputs(*CASES["init_then_update"])
    args = [torch.from_numpy(np.array(v)) for v in x.values()]
    before = tsq.deferred_seq_scan.launches
    got = tsq.deferred_seq_scan(*args)
    want = tsq.reference_seq_scan(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tsq.deferred_seq_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tsq.deferred_seq_scan(*args, use_kernel=True)


# unknown association: (what, slot) per measurement (see
# unknown_scan_inputs); the expected kinds (1 update / 2 init / 0 none)
UNKNOWN_CASES = {
    # match, skip (between the gates), new (at slot n_seen = U), invalid
    "mixed": (False, [("match", 5), ("skip", 9), ("new", 20),
                      ("invalid", 3)], [1, 0, 2, 0]),
    # first hits at two slots, then a skip and a new landmark
    "two_matches": (False, [("match", 30), ("match", 5), ("skip", 12),
                            ("new", 2)], [1, 1, 0, 2]),
    # full map: the new point overflows and stops the tick, so the exact
    # revisits after it are inert
    "overflow_then_stop": (True, [("match", 7), ("new", 20), ("match", 5),
                                  ("new", 30)], [1, 0, 0, 0]),
}


def _run_unknown(x, ids=None, **kw):
    return tsq.reference_seq_scan(
        *(torch.from_numpy(np.array(x[k])) for k in x if k != "ids"
          and k != "R"), ids, torch.from_numpy(x["R"]), known=False, **kw)


@pytest.mark.parametrize("case", list(UNKNOWN_CASES))
def test_unknown_reference_matches_jax_pallas_interpret(case):
    """Discrete outputs equal, continuous atol 1e-5 (as the known case)."""
    full, plan, kinds = UNKNOWN_CASES[case]
    x = unknown_scan_inputs(N, M, plan, full=full)
    want = jsq.deferred_seq_scan(
        *(jnp.asarray(x[k]) for k in x), known=False,
        match_gate=0.01, new_gate=60.0, wrap_innovation=False,
        symmetrize=True, interpret=True)
    margins = []
    got = _run_unknown(x, gate_margins=margins)
    for name, g, w in zip(NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in DISCRETE:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=name)
    assert got[-1].tolist() == kinds
    assert int(got[6]) == int(x["n_seen"]) + kinds.count(2)
    if case == "mixed":
        assert got[-2].tolist() == [5, -1, U, -1]
    # every active measurement's scores sit at least 10% away from both
    # gates, far beyond what f32 rounding (~1e-6 relative) could cross
    active = [m for m in margins if torch.isfinite(m)]
    assert active and min(float(m) for m in active) > 0.1


@pytest.mark.parametrize("case", ["mixed", "overflow_then_stop"])
def test_unknown_tick_matches_jax_xla_f64(case):
    """The port's unknown deferred tick (plain scan + grid pass) against
    the JAX XLA ``make_sharded_deferred_unknown_step`` at map=1, f64, from
    the same state: kinds decide identically, state to atol 1e-9."""
    full, plan, _ = UNKNOWN_CASES[case]
    x = unknown_scan_inputs(N, M, plan, full=full)
    st, _ = _swept_state(N, M, 24, full)
    st64 = {k: (v.double() if v.is_floating_point() else v).numpy()
            for k, v in st._asdict().items()}
    tw = np.zeros((1, 3))
    zs = x["zs"].astype(np.float64)[None]
    valid = x["valid"][None]
    Q = np.diag([1e-4] * 3)
    R = np.diag([1e-3] * 2)

    mesh = make_mesh(jax.devices()[:1], data=1)
    jcfg = JConfig(num_landmarks=N)
    specs = jblocked.state_sharding(mesh)
    jst = jblocked.BlockedState(**{k: jnp.asarray(v)
                                   for k, v in st64.items()})
    jst = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), jst, specs)
    jstep = jblocked.make_sharded_deferred_unknown_step(jcfg, mesh, 1, M)
    want = jax_to_numpy(jstep(jst, *map(jnp.asarray, (tw, zs, valid, Q, R))))

    step = blocked_ekf.make_deferred_step(EKFConfig(num_landmarks=N), M,
                                          "cpu", known=False)
    got = step(blocked_ekf.BlockedState(
        **{k: torch.from_numpy(v) for k, v in st64.items()}),
        *map(torch.from_numpy, (tw, zs, valid, Q, R)))
    for k in want:
        g, w = getattr(got, k).numpy(), want[k]
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9,
                                       err_msg=k)
    if case == "overflow_then_stop":
        assert int(got.n_seen[0]) == N


def test_unknown_wrapper_routes_cpu_to_plain_without_ids():
    x = unknown_scan_inputs(N, M, UNKNOWN_CASES["mixed"][1])
    args = [torch.from_numpy(np.array(v)) for v in x.values()]
    args[10] = None                               # ids
    before = tsq.deferred_seq_scan.launches
    got = tsq.deferred_seq_scan(*args, known=False)
    want = _run_unknown(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tsq.deferred_seq_scan.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tsq.deferred_seq_scan(*args, known=False, use_kernel=True)
