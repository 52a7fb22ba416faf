"""The port's serving slice as a whole (pipeline/serving.py,
parallel/bigmap.py) against the JAX reference, on the CPU.

The same numpy inputs go through ``make_serving_step`` / ``ServingEngine``
of both packages, known and unknown association. At f64 the port's plain
path and the JAX XLA path differ only in summation order (atol 1e-9 on the
means, and on the covariance over seen slots; unseen diagonals hold the
INT_MAX prior, 2.1e9). At f32 the JAX side runs its Pallas kernels in
interpret mode. Serving is also held against the port's own dense engine,
as the JAX package's tests/test_serving.py holds its serving against its
dense engine (the same tolerances: 1e-8 on the mean, 1e-6 on the seen
covariance block).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_state_close, jax_to_numpy
from shermbot_navigation_tpu.models import ekf_slam as jekf
from shermbot_navigation_tpu.parallel import bigmap as jbigmap
from shermbot_navigation_tpu.parallel import blocked_ekf as jblocked_ekf
from shermbot_navigation_tpu.pipeline import metrics as jmetrics
from shermbot_navigation_tpu.pipeline import serving as jserving
from shermbot_navigation_tpu_torch.models import ekf_slam as tekf
from shermbot_navigation_tpu_torch.parallel import bigmap as tbigmap
from shermbot_navigation_tpu_torch.parallel import blocked_ekf as tblocked_ekf
from shermbot_navigation_tpu_torch.pipeline import metrics as tmetrics
from shermbot_navigation_tpu_torch.pipeline import serving as tserving
from shermbot_navigation_tpu_torch.utils import convert

ROOT = Path(__file__).resolve().parents[1]
N = 16
M = 4
Q3 = np.diag([0.01, 0.01, 0.01])
R2 = np.diag([0.001, 0.001])


def _inputs(T, seed=0):
    """Twists, measurements, validity and ids from a numpy seed; ids
    revisit slots 0..7 so later ticks update what earlier ones init."""
    rng = np.random.default_rng(seed)
    twists = rng.uniform(-0.05, 0.05, (T, 3))
    zs = np.stack([rng.uniform(0.3, 1.0, (T, M)),
                   rng.uniform(-3, 3, (T, M))], axis=-1)
    valid = rng.uniform(size=(T, M)) < 0.9
    ids = ((np.arange(T)[:, None] + np.arange(M)[None, :]) % 8
           ).astype(np.int32)
    return twists, zs, valid, ids


def _unknown_inputs(T, n_points=20, seed=2):
    """Unknown association: a still robot and measurements (noise 1e-4) of
    ``n_points`` > N world points 0.94 m apart on a circle, in a sweep --
    first sightings create landmarks until the map is full and then
    overflow (stopping their tick), later ones revisit. Valid except one
    slot. Same tuple layout as :func:`_inputs`, ids unused."""
    rng = np.random.default_rng(seed)
    ang = np.arange(n_points) * 2 * np.pi / n_points
    world = np.stack([5 + 3 * np.cos(ang), 3 * np.sin(ang)], axis=-1)
    pts = world[(np.arange(T)[:, None] * M + np.arange(M)[None, :])
                % n_points] + rng.normal(0, 1e-4, (T, M, 2))
    zs = np.stack([np.hypot(pts[..., 0], pts[..., 1]),
                   np.arctan2(pts[..., 1], pts[..., 0])], axis=-1)
    valid = np.ones((T, M), bool)
    valid[1, 2] = False
    return np.zeros((T, 3)), zs, valid, np.zeros((T, M), np.int32)


def _converged_dense(n_init, dtype, seed=1):
    """A JAX dense state with ``n_init`` landmarks initialized (a served
    map), as numpy fields."""
    cfg = jekf.EKFConfig(num_landmarks=N)
    rng = np.random.default_rng(seed)
    st = jekf.init(cfg, jnp.array([0.1, 0.2, -0.1], dtype), dtype=dtype)
    for _ in range(n_init):
        z = jnp.asarray(rng.uniform([0.3, -3], [1.0, 3]), dtype)
        st, _ = jekf.step_measurement(cfg, st, z, jnp.bool_(True),
                                      jnp.bool_(False),
                                      jnp.asarray(R2, dtype))
    return jax_to_numpy(st)


def _run_both(T, np_dtype, jax_kw, known=True):
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    jcfg = jekf.EKFConfig(num_landmarks=N)
    tcfg = tekf.EKFConfig(num_landmarks=N)
    twists, zs, valid, ids = _inputs(T) if known else _unknown_inputs(T)
    dense = _converged_dense(3, jdt)
    Q = Q3 if known else np.diag([1e-4] * 3)
    Q, R = Q.astype(np_dtype), R2.astype(np_dtype)

    jst = jserving.state_from_dense(
        jcfg, jekf.EKFState(**{k: jnp.asarray(v) for k, v in dense.items()}))
    jtick = jserving.make_serving_step(jcfg, M, known=known, dtype=jdt,
                                       donate=False, **jax_kw)
    eng = tserving.ServingEngine(
        tcfg, M, torch.from_numpy(Q), torch.from_numpy(R), dtype=tdt,
        known=known, dense_state=convert.ekf_state_from_numpy(dense, "cpu"),
        device="cpu")
    for t in range(T):
        args = (twists[t].astype(np_dtype), zs[t].astype(np_dtype), valid[t],
                ids[t])[:4 if known else 3]
        jst = jtick(jst, *map(jnp.asarray, args), jnp.asarray(Q),
                    jnp.asarray(R))
        eng.tick(args[0], args[1], valid=args[2],
                 ids=args[3] if known else None)
    return jax_to_numpy(jst), eng.state


def _assert_serving_close(got, want, atol):
    """Means to ``atol`` and covariance blocks over seen slots only."""
    assert_state_close(got, want, atol, fields=("n_seen", "seen", "mean_r",
                                                "mean_m", "cov_rr"))
    seen = want["seen"][0]
    np.testing.assert_allclose(got.cov_rm.numpy()[0][:, seen],
                               want["cov_rm"][0][:, seen], rtol=0, atol=atol)
    grid = got.cov_mm.numpy()[0][:, :, seen][:, :, :, seen]
    np.testing.assert_allclose(grid, want["cov_mm"][0][:, :, seen][
        :, :, :, seen], rtol=0, atol=atol)
    np.testing.assert_allclose(got.diag4.numpy()[0][:, seen],
                               want["diag4"][0][:, seen], rtol=0, atol=atol)


def test_serving_matches_jax_xla_f64():
    want, got = _run_both(6, np.float64, {})
    assert int(got.n_seen[0]) > 3          # the ticks init and update
    _assert_serving_close(got, want, 1e-9)


def test_unknown_serving_matches_jax_xla_f64():
    """Unknown association over ticks that create, overflow (the map has
    16 slots for 20 points) and match; the decisions (``n_seen``,
    ``seen``) equal and the state to 1e-9."""
    want, got = _run_both(7, np.float64, {}, known=False)
    assert int(got.n_seen[0]) == N
    _assert_serving_close(got, want, 1e-9)


def test_serving_matches_jax_kernel_interpret_f32():
    """f32 against the JAX kernel path (Pallas scan and grid pass in
    interpret mode): atol 1e-5, the scan-kernel tolerance (polynomial
    atan2, row-for-column reads) over 3 ticks."""
    want, got = _run_both(3, np.float32,
                          dict(seq_kernel=True, seq_interpret=True,
                               grid_kernel=True, kernel_interpret=True))
    _assert_serving_close(got, want, 1e-5)


def test_state_roundtrip_bitwise():
    dense = _converged_dense(5, jnp.float64)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = convert.ekf_state_from_numpy(dense, "cpu")
    blocked = tserving.state_from_dense(cfg, st)
    back = convert.ekf_state_to_numpy(tserving.state_to_dense(cfg, blocked))
    for k in dense:
        np.testing.assert_array_equal(back[k], dense[k], err_msg=k)
    # the blocked layout is the JAX package's, bit for bit
    jb = jserving.state_from_dense(
        jekf.EKFConfig(num_landmarks=N),
        jekf.EKFState(**{k: jnp.asarray(v) for k, v in dense.items()}))
    assert_state_close(blocked, jax_to_numpy(jb), 0.0)


def test_init_and_convert_match_jax():
    """Both initial states equal the JAX ones bit for bit, cross through
    ``utils/convert`` unchanged, and the dense prior re-lays out into the
    blocked prior."""
    pose = [0.1, 0.2, -0.1]
    jcfg = jekf.EKFConfig(num_landmarks=N)
    tcfg = tekf.EKFConfig(num_landmarks=N)
    jdense = jax_to_numpy(jekf.init(jcfg, jnp.array(pose), dtype=jnp.float64))
    tdense = tekf.init(tcfg, pose, dtype=torch.float64, device="cpu")
    assert_state_close(tdense, jdense, 0.0)
    jblocked = jax_to_numpy(jblocked_ekf.init(jcfg, 1, robot_pose=pose,
                                              dtype=jnp.float64))
    tblocked = tblocked_ekf.init(tcfg, 1, robot_pose=pose,
                                 dtype=torch.float64, device="cpu")
    assert_state_close(tblocked, jblocked, 0.0)
    back = convert.blocked_state_to_numpy(
        convert.blocked_state_from_numpy(jblocked, "cpu"))
    for k in jblocked:
        np.testing.assert_array_equal(back[k], jblocked[k], err_msg=k)
        assert back[k].dtype == jblocked[k].dtype, k
    assert_state_close(tserving.state_from_dense(tcfg, tdense), jblocked, 0.0)


def test_run_bigmap_matches_jax_f64():
    """The config-4 entry point end to end at a small size: T=12 > N/M=8
    ticks, so the last ticks update a full map; pose error via ``ate``."""
    Nb, T, Mb = 32, 12, 4
    js, jwl = jbigmap.run_bigmap(N=Nb, T=T, M=Mb, dtype=jnp.float64)
    ts, twl = tbigmap.run_bigmap(N=Nb, T=T, M=Mb, dtype=torch.float64,
                                 device="cpu")
    assert int(ts.n_seen[0]) == Nb
    assert_state_close(ts, jax_to_numpy(js), 1e-9)
    jtrue = jbigmap._true_pose(jwl.cmd, jnp.float64(T), jnp.float64)
    ttrue = tbigmap._true_pose(twl.cmd, torch.tensor(float(T),
                                                     dtype=torch.float64))
    np.testing.assert_allclose(ttrue.numpy(), np.asarray(jtrue), atol=1e-12)
    jerr = float(jmetrics.ate(js.mean_r[:, 1:], jtrue[None, 1:]))
    terr = float(tmetrics.ate(ts.mean_r[:, 1:], ttrue[None, 1:]))
    assert np.isfinite(terr)
    np.testing.assert_allclose(terr, jerr, atol=1e-9)


@pytest.mark.parametrize("known", [True, False])
def test_serving_matches_port_dense_engine(known):
    """The port's serving tick against the port's dense tick
    (``known_association_step`` / ``step``) from the same migrated map."""
    cfg = tekf.EKFConfig(num_landmarks=N)
    T = 4 if known else 7
    twists, zs, valid, ids = _inputs(T) if known else _unknown_inputs(T)
    dense = convert.ekf_state_from_numpy(_converged_dense(3, jnp.float64),
                                         "cpu")
    srv = tserving.state_from_dense(cfg, dense)
    tick = tserving.make_serving_step(cfg, M, known=known,
                                      dtype=torch.float64, device="cpu",
                                      donate=False)
    Q = torch.from_numpy(Q3 if known else np.diag([1e-4] * 3))
    R = torch.from_numpy(R2)
    for t in range(T):
        a = [torch.from_numpy(x[t]) for x in (twists, zs, valid, ids)]
        if known:
            dense = tekf.known_association_step(cfg, dense, *a, Q, R)
            srv = tick(srv, *a, Q, R)
        else:
            dense = tekf.step(cfg, dense, *a[:3], Q, R)
            srv = tick(srv, *a[:3], Q, R)
    got = tserving.state_to_dense(cfg, srv)
    assert int(got.n_seen) == int(dense.n_seen) > 3
    assert torch.equal(got.seen, dense.seen)
    np.testing.assert_allclose(got.mean.numpy(), dense.mean.numpy(),
                               rtol=0, atol=1e-8)
    k = 3 + 2 * int(dense.n_seen)
    np.testing.assert_allclose(got.cov[:k, :k].numpy(),
                               dense.cov[:k, :k].numpy(), rtol=0, atol=1e-6)


def test_unknown_runner_matches_jax_f64():
    """``bigmap.make_unknown_runner`` at N=64, M=8 and map=1 (the JAX
    tests/test_blocked_unknown.py runner test's workload, one map shard),
    T=12 > N/M: the sweep creates through the first-hit gate, then
    revisits; decisions equal, state to 1e-9."""
    from jax.sharding import NamedSharding
    from shermbot_navigation_tpu.parallel.mesh import make_mesh
    import jax
    Nb, Mb, T = 64, 8, 12
    mesh = make_mesh(jax.devices()[:1], data=1)
    jcfg = jekf.EKFConfig(num_landmarks=Nb)
    jwl = jbigmap.make_workload(Nb, T, Mb, jax.random.PRNGKey(0),
                                dtype=jnp.float64)
    jst = jblocked_ekf.init(jcfg, 1, dtype=jnp.float64)
    jst = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), jst,
        jblocked_ekf.state_sharding(mesh))
    Q = np.diag([1e-4] * 3)
    R = np.diag([1e-3] * 2)
    want = jax_to_numpy(jbigmap.make_unknown_runner(jcfg, mesh, 1, Mb)(
        jst, jwl, jnp.asarray(Q), jnp.asarray(R), jnp.int32(0), T))

    tcfg = tekf.EKFConfig(num_landmarks=Nb)
    twl = tbigmap.make_workload(Nb, T, Mb, dtype=torch.float64,
                                device="cpu")
    got = tbigmap.make_unknown_runner(tcfg, Mb, "cpu")(
        tblocked_ekf.init(tcfg, 1, dtype=torch.float64, device="cpu"), twl,
        torch.from_numpy(Q), torch.from_numpy(R), 0, T)
    assert int(got.n_seen[0]) > Nb // 2
    _assert_serving_close(got, want, 1e-9)


def test_engine_pads_measurements_and_rejects_unknown():
    """Short measurement lists are padded; the known engine rejects a tick
    without ids, the unknown engine takes none (and ignores any)."""
    cfg = tekf.EKFConfig(num_landmarks=N)
    eng = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2,
                                 robot_pose=[0.0, 0.0, 0.0],
                                 dtype=torch.float64, device="cpu")
    eng.tick([0.0, 0.0, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    assert eng.n_seen == 2
    assert torch.isfinite(eng.pose).all()
    with pytest.raises(ValueError, match="needs ids"):
        eng.tick([0.0, 0.0, 0.0], [[0.7, 0.5]])
    unk = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2, known=False,
                                 robot_pose=[0.0, 0.0, 0.0],
                                 dtype=torch.float64, device="cpu")
    unk.tick([0.0, 0.0, 0.0], [[0.7, 0.5], [0.9, -1.0]])
    unk.tick([0.0, 0.0, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[5, 6])
    assert unk.n_seen == 2          # the revisits matched


def test_entry_points_default_to_the_card_not_the_cpu():
    """The fault and its repair: an entry point called without a device
    runs on the card; where there is none it raises, naming
    ``device="cpu"``, and never carries on on the CPU by itself. Asked for
    the CPU, it runs there."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tbigmap.run_bigmap(N=64, T=2, M=8)
    st, _ = tbigmap.run_bigmap(N=64, T=2, M=8, device="cpu")
    assert int(st.n_seen[0]) == 16 and st.mean_r.device.type == "cpu"
    cfg = tekf.EKFConfig(num_landmarks=N)
    for call in (
            lambda: tekf.init(cfg, [0.0, 0.0, 0.0]),
            lambda: tblocked_ekf.init(cfg, 1),
            lambda: tbigmap.make_workload(64, 2, 8),
            lambda: tbigmap.noise(),
            lambda: tserving.make_serving_step(cfg, M),
            lambda: tserving.ServingEngine(cfg, M, Q3, R2),
            lambda: convert.ekf_state_from_numpy({}),
            lambda: convert.blocked_state_from_numpy({})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("spelling", ["cpu:0", torch.device("cpu", 0)])
def test_any_cpu_spelling_runs_the_serving_tick(spelling):
    """The CPU mirror of the unindexed-card fault: a CPU tensor reports
    ``cpu``, so a step built for ``cpu:0`` once refused its own state on
    the first tick. Devices are compared resolved: every spelling runs, in
    the engine and in ``run_bigmap``."""
    cfg = tekf.EKFConfig(num_landmarks=64)
    eng = tserving.ServingEngine(cfg, max_meas=8, Q=Q3, R=R2,
                                 robot_pose=[0.0, 0.0, 0.0], device=spelling)
    assert eng.device == torch.device("cpu")
    for _ in range(3):
        eng.tick([0.0, 0.1, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    assert eng.n_seen == 2 and torch.isfinite(eng.pose).all()
    st, _ = tbigmap.run_bigmap(N=64, T=2, M=8, device=spelling)
    assert int(st.n_seen[0]) == 16 and st.mean_r.device.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys, shermbot_navigation_tpu_torch.pipeline.serving, "
            "shermbot_navigation_tpu_torch.utils.convert, "
            "shermbot_navigation_tpu_torch.ops.kernels.cov_update, "
            "shermbot_navigation_tpu_torch.parallel.bigmap, "
            "shermbot_navigation_tpu_torch.ops.landmark_detection, "
            "shermbot_navigation_tpu_torch.ops.kernels._build; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_engine_serves_a_given_state_without_a_copy():
    """``ServingEngine(state=...)`` serves another engine's blocked state
    as it is (the single-card edge has no room for a second map): a known
    engine builds the map, an unknown engine takes its state without a
    copy and ticks on it, equal to a copy run through its own engine from
    that state; a state of another size, or beside ``dense_state``,
    raises."""
    cfg = tekf.EKFConfig(num_landmarks=N)
    eng = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2,
                                 robot_pose=[0.0, 0.0, 0.0],
                                 dtype=torch.float64, device="cpu")
    eng.tick([0.0, 0.0, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    copy = tblocked_ekf.BlockedState(*(x.clone() for x in eng.state))
    unk = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2, known=False,
                                 dtype=torch.float64, device="cpu",
                                 state=eng.state)
    assert unk.state.cov_mm.data_ptr() == eng.state.cov_mm.data_ptr()
    ref = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2, known=False,
                                 dtype=torch.float64, device="cpu",
                                 state=copy)
    for e in (unk, ref):
        e.tick([0.01, 0.1, 0.0], [[0.7, 0.45], [2.0, 2.0]])
    assert unk.n_seen == 3
    assert_state_close(unk.state, jax_to_numpy(ref.state), 0.0)
    with pytest.raises(ValueError, match="one world"):
        tserving.ServingEngine(tekf.EKFConfig(num_landmarks=N + 1), M, Q3,
                               R2, dtype=torch.float64, device="cpu",
                               state=eng.state)
