"""The port's measurement scan (ops/kernels/seq_scan.py) against the JAX
reference's Pallas scan (ops/pallas/seq_scan.py, known=True, interpret
mode): the same numpy inputs through both.

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

from _torch_parity import jax_to_numpy, scan_inputs
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
    b = step(blocked_ekf.init(cfg, 1),
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
