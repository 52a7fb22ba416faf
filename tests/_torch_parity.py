"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy
inputs go through the JAX reference and the PyTorch port."""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)


def jax_to_numpy(state) -> dict:
    """A JAX NamedTuple state as the dict of numpy arrays that
    ``shermbot_navigation_tpu_torch.utils.convert`` reads (a nested state
    as a nested dict)."""
    return {k: (jax_to_numpy(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in state._asdict().items()}


def assert_state_close(got, want: dict, atol: float, fields=None):
    """Port state ``got`` against JAX numpy fields ``want``: integer and
    bool fields exactly, float fields to ``atol``."""
    for k in fields or want:
        g = getattr(got, k).detach().cpu().numpy()
        w = want[k]
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def grid_operands(Nl, N, M, seed=0, dtype=np.float64):
    """Random grid-pass operands (numpy): planes, A, B, crow, ccol, and
    last-init tables with a quarter of the rows and columns set."""
    rng = np.random.default_rng(seed)
    ops = [rng.normal(size=s).astype(dtype) for s in
           [(2, 2, Nl, N), (2, Nl, 2 * M), (2, 2 * M, N), (2, 2, M, N),
            (2, 2, Nl, M)]]
    rowt = np.full(Nl, -1, np.int32)
    colt = np.full(N, -1, np.int32)
    rows = rng.choice(Nl, size=max(1, Nl // 4), replace=False)
    rowt[rows] = rng.integers(0, M, rows.size)
    cols = rng.choice(N, size=max(1, N // 4), replace=False)
    colt[cols] = rng.integers(0, M, cols.size)
    return ops + [rowt, colt]


def _swept_state(N, M, ticks, full):
    """The port's plain-path (f32) state after ``ticks`` (> N/M) known ticks
    of the sweep; the top eighth of the slots stays unseen unless ``full``.
    Returns (state, workload)."""
    from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
    from shermbot_navigation_tpu_torch.parallel import bigmap, blocked_ekf
    cfg = EKFConfig(num_landmarks=N)
    wl = bigmap.make_workload(N, ticks, M, device="cpu")
    if not full:
        wl = wl._replace(schedule=wl.schedule % (N - N // 8))
    Q, R = bigmap.noise(device="cpu")
    st = bigmap.make_runner(cfg, M, "cpu")(
        blocked_ekf.init(cfg, 1, device="cpu"), wl, Q, R, 0, ticks)
    return st, wl


def scan_inputs(N, M, ids, valid, ticks=24, seed=0) -> dict:
    """Numpy inputs of one measurement scan: the state after ``ticks``
    (> N/M) ticks of the port's plain path (f32) on a schedule that leaves
    the top eighth of the slots unseen, and noisy measurements of ``ids``
    (clamped into range)."""
    from shermbot_navigation_tpu_torch.parallel import bigmap
    st, wl = _swept_state(N, M, ticks, full=False)
    ids_t = torch.tensor(ids, dtype=torch.int32)
    wl = wl._replace(schedule=ids_t.clamp(0, N - 1)[None].expand(ticks, M))
    zs, _, _ = bigmap.measurements(wl, ticks)
    rng = np.random.default_rng(seed)
    zs = zs.numpy() + rng.normal(scale=1e-2, size=(M, 2)).astype(np.float32)
    return _scan_dict(st, zs, valid, ids)


def unknown_scan_inputs(N, M, plan, full=False, ticks=24) -> dict:
    """Numpy inputs of one unknown-association scan on the state of
    :func:`scan_inputs` (every slot seen if ``full``). ``plan`` lists one
    ``(what, slot)`` per measurement, measured from the scan's input
    state: ``"match"`` the exact range-bearing of landmark ``slot``,
    ``"skip"`` that range 5 cm long (a distance between the gates),
    ``"new"`` a point 1 m off the landmark grid beside ``slot`` (far above
    the new gate), ``"invalid"`` a valid=False slot."""
    st, _ = _swept_state(N, M, ticks, full)
    th, x, y = st.mean_r[0].double().tolist()
    mm = st.mean_m[0].double().numpy()
    zs, valid = [], []
    for what, slot in plan:
        px, py = mm[slot]
        if what == "new":
            px, py = px + 1.0, py + 1.0
        r = np.hypot(px - x, py - y) + (0.05 if what == "skip" else 0.0)
        b = np.arctan2(py - y, px - x) - th
        zs.append([r, np.arctan2(np.sin(b), np.cos(b))])
        valid.append(what != "invalid")
    return _scan_dict(st, np.asarray(zs, np.float32), valid, None)


def _scan_dict(st, zs, valid, ids) -> dict:
    N = st.mean_m.shape[1]
    s = {k: v[0].numpy() for k, v in st._asdict().items()}
    return dict(
        mean_r=s["mean_r"], mm2=np.ascontiguousarray(s["mean_m"].T),
        cov_rr=s["cov_rr"],
        rm6=np.ascontiguousarray(s["cov_rm"].transpose(0, 2, 1)).reshape(6, N),
        diag4=s["diag4"], seen=s["seen"], n_seen=s["n_seen"],
        mm0p=s["cov_mm"].reshape(4, N, N), zs=zs,
        valid=np.asarray(valid, bool),
        ids=np.zeros(len(zs), np.int32) if ids is None
        else np.asarray(ids, np.int32),
        R=np.diag([1e-3, 1e-3]).astype(np.float32))


def replay_tick_noise(keys, ticks, substeps, num_rays, num_tubes,
                      dtype=np.float32):
    """The standard draws the JAX driver makes from PRNG ``keys`` (B, 2)
    over ``ticks`` SLAM ticks, as numpy arrays with leading ``(T, B)`` in
    the layout of the port's ``TickNoise``: the key tree of
    ``pipeline/driver.sense_tick`` (split into ``substeps + 2``),
    ``tube_world.step_dynamics`` (split in two; ``normal(kt, (2,))``,
    ``normal(ks, (2,))``) and ``tube_world.observe`` (split in three;
    lidar normals, marker-keep and scan-keep uniforms) is walked with
    ``jax.random`` itself."""
    import jax
    import jax.numpy as jnp
    jdt = jnp.dtype(dtype)

    def tick(key, _):
        key, k_obs, *sub = jax.random.split(key, substeps + 2)
        pairs = [jax.random.split(k, 2) for k in sub]
        k_lidar, k_drop_m, k_drop_s = jax.random.split(k_obs, 3)
        out = dict(
            twist=jnp.stack([jax.random.normal(p[0], (2,), jdt)
                             for p in pairs]),
            slip=jnp.stack([jax.random.normal(p[1], (2,), jdt)
                            for p in pairs]),
            scan=jax.random.normal(k_lidar, (num_rays,), jdt),
            marker_keep=jax.random.uniform(k_drop_m, (num_tubes,)
                                           ).astype(jdt),
            scan_keep=jax.random.uniform(k_drop_s, (num_rays,)).astype(jdt))
        return key, out

    def one(key):
        return jax.lax.scan(tick, key, None, length=ticks)[1]

    out = jax.jit(jax.vmap(one))(jnp.asarray(keys))
    return {k: np.swapaxes(np.asarray(v), 0, 1) for k, v in out.items()}


def tick_noise_from_numpy(arrays: dict, device="cpu"):
    """A numpy noise dict (fields of ``TickNoise``) as the port's
    ``TickNoise``."""
    from shermbot_navigation_tpu_torch.sim.tube_world import TickNoise
    return TickNoise(**{k: torch.from_numpy(np.array(arrays[k])).to(device) for k in TickNoise._fields})
