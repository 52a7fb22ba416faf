"""The port's serving slice as a whole (pipeline/serving.py,
parallel/bigmap.py) against the JAX reference, on the CPU.

The same numpy inputs go through ``make_serving_step`` / ``ServingEngine``
of both packages. At f64 the port's plain path and the JAX XLA path differ
only in summation order (atol 1e-9 on the means, and on the covariance over
seen slots; unseen diagonals hold the INT_MAX prior, 2.1e9). At f32 the
JAX side runs its Pallas kernels in interpret mode.
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


def _run_both(T, np_dtype, jax_kw, torch_kw):
    jdt = jnp.float64 if np_dtype == np.float64 else jnp.float32
    tdt = torch.float64 if np_dtype == np.float64 else torch.float32
    jcfg = jekf.EKFConfig(num_landmarks=N)
    tcfg = tekf.EKFConfig(num_landmarks=N)
    twists, zs, valid, ids = _inputs(T)
    dense = _converged_dense(3, jdt)
    Q, R = Q3.astype(np_dtype), R2.astype(np_dtype)

    jst = jserving.state_from_dense(
        jcfg, jekf.EKFState(**{k: jnp.asarray(v) for k, v in dense.items()}))
    jtick = jserving.make_serving_step(jcfg, M, dtype=jdt, donate=False,
                                       **jax_kw)
    eng = tserving.ServingEngine(
        tcfg, M, torch.from_numpy(Q), torch.from_numpy(R), dtype=tdt,
        dense_state=convert.ekf_state_from_numpy(dense), **torch_kw)
    for t in range(T):
        args = (twists[t].astype(np_dtype), zs[t].astype(np_dtype), valid[t],
                ids[t])
        jst = jtick(jst, *map(jnp.asarray, args), jnp.asarray(Q),
                    jnp.asarray(R))
        eng.tick(args[0], args[1], valid=args[2], ids=args[3])
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
    want, got = _run_both(6, np.float64, {}, {})
    assert int(got.n_seen[0]) > 3          # the ticks init and update
    _assert_serving_close(got, want, 1e-9)


def test_serving_matches_jax_kernel_interpret_f32():
    """f32 against the JAX kernel path (Pallas scan and grid pass in
    interpret mode): atol 1e-5, the scan-kernel tolerance (polynomial
    atan2, row-for-column reads) over 3 ticks."""
    want, got = _run_both(3, np.float32,
                          dict(seq_kernel=True, seq_interpret=True,
                               grid_kernel=True, kernel_interpret=True), {})
    _assert_serving_close(got, want, 1e-5)


def test_state_roundtrip_bitwise():
    dense = _converged_dense(5, jnp.float64)
    cfg = tekf.EKFConfig(num_landmarks=N)
    st = convert.ekf_state_from_numpy(dense)
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
    tdense = tekf.init(tcfg, pose, dtype=torch.float64)
    assert_state_close(tdense, jdense, 0.0)
    jblocked = jax_to_numpy(jblocked_ekf.init(jcfg, 1, robot_pose=pose,
                                              dtype=jnp.float64))
    tblocked = tblocked_ekf.init(tcfg, 1, robot_pose=pose,
                                 dtype=torch.float64)
    assert_state_close(tblocked, jblocked, 0.0)
    back = convert.blocked_state_to_numpy(
        convert.blocked_state_from_numpy(jblocked))
    for k in jblocked:
        np.testing.assert_array_equal(back[k], jblocked[k], err_msg=k)
        assert back[k].dtype == jblocked[k].dtype, k
    assert_state_close(tserving.state_from_dense(tcfg, tdense), jblocked, 0.0)


def test_run_bigmap_matches_jax_f64():
    """The config-4 entry point end to end at a small size: T=12 > N/M=8
    ticks, so the last ticks update a full map; pose error via ``ate``."""
    Nb, T, Mb = 32, 12, 4
    js, jwl = jbigmap.run_bigmap(N=Nb, T=T, M=Mb, dtype=jnp.float64)
    ts, twl = tbigmap.run_bigmap(N=Nb, T=T, M=Mb, dtype=torch.float64)
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


def test_engine_pads_measurements_and_rejects_unknown():
    cfg = tekf.EKFConfig(num_landmarks=N)
    eng = tserving.ServingEngine(cfg, max_meas=M, Q=Q3, R=R2,
                                 robot_pose=[0.0, 0.0, 0.0],
                                 dtype=torch.float64)
    eng.tick([0.0, 0.0, 0.0], [[0.7, 0.5], [0.9, -1.0]], ids=[0, 1])
    assert eng.n_seen == 2
    assert torch.isfinite(eng.pose).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserving.make_serving_step(cfg, M, known=False)


def test_port_imports_no_jax():
    code = ("import sys, shermbot_navigation_tpu_torch.pipeline.serving, "
            "shermbot_navigation_tpu_torch.utils.convert, "
            "shermbot_navigation_tpu_torch.ops.kernels._build; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
