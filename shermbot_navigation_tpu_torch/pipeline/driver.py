"""The in-process pipeline driver: sim -> (perception) -> odometry -> EKF
(port of ``shermbot_navigation_tpu.pipeline.driver``).

Wiring per tick (mirrors the reference's ``unknown_data_assoc.launch``):

1. run ``sim_substeps`` tube-world steps holding the command twist;
2. odometry: wheel deltas from the *commanded* joint states -> twist ->
   DiffDrive update (ref slam.cpp:231-265);
3. measurements: either the fake sensor markers (configs 1-2) or the full
   lidar -> clustering -> circle-fit stage (config 3);
4. EKF predict + sequential measurement updates (ref slam.cpp:269-318).

Differences from the JAX module, none of them semantic:

- ``lax.scan`` over ticks is a Python loop that writes each tick's outputs
  into preallocated ``(T, ...)`` / ``(B, T, ...)`` tensors; nothing goes
  back to the host inside a tick.
- The sim and perception are batch-first instead of vmapped, so one
  :func:`sense_tick` serves a single world and a batch.
- Randomness is an explicit input (``sim/tube_world.TickNoise``): the
  drivers take a ``torch.Generator`` on the run's device, or a precomputed
  noise sequence (a :class:`TickNoise` whose fields have a leading T).
- :func:`run_scenario_batch` keeps the JAX driver's two engines apart: the
  filter is the single-world dense engine under ``torch.func.vmap``
  (covariances ``(B, D, D)``), while the sim and perception run
  batch-first as in :func:`run_scenario_batch_lanes` (no vmap needed).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve
from ..models import ekf_batch
from ..models import ekf_slam as ekf
from ..ops import diff_drive as dd
from ..ops.kernels import ekf_tick, sim_tick
from ..ops.landmark_detection import detect_landmarks
from ..sim import tube_world as tw
from ..utils.tracing import stage
from .config import ScenarioConfig
from .metrics import nees as nees_fn


class PipelineState(NamedTuple):
    world: tw.WorldState
    odom: dd.DiffDriveState
    filt: ekf.EKFState


class TickOutput(NamedTuple):
    true_pose: torch.Tensor   # (..., 3) [th, x, y] ground truth
    odom_pose: torch.Tensor   # (..., 3) odometry-only estimate
    slam_pose: torch.Tensor   # (..., 3) EKF estimate
    n_seen: torch.Tensor      # (...,) landmarks initialized so far
    nees: torch.Tensor        # (...,) robot-block NEES


class SenseState(NamedTuple):
    """Everything except the filter: sim world and odometry (the JAX
    ``SenseState`` also carries the PRNG key; here noise is an input)."""

    world: tw.WorldState
    odom: dd.DiffDriveState


def init_sense(params: tw.WorldParams, dtype, batch=()) -> SenseState:
    dev = params.tube_locs.device
    return SenseState(world=tw.init_state(params, dtype, batch),
                      odom=dd.init_state(dtype=dtype, device=dev,
                                         batch=batch))


def init_pipeline(scn: ScenarioConfig, dtype=torch.float32, device=None
                  ) -> PipelineState:
    """One world's initial state; ``device=None`` is the card."""
    device = resolve(device)
    sense = init_sense(scn.world_params(dtype, device), dtype)
    return PipelineState(
        world=sense.world, odom=sense.odom,
        filt=ekf.init(scn.ekf_config(), [0.0, 0.0, 0.0], dtype=dtype,
                      device=device))


def command_twist(scn: ScenarioConfig, t, dtype=torch.float32, device=None):
    """Teleop replacement: the command twists ``(T, 3)`` at SLAM ticks
    ``t`` (a tensor or an int count of ticks from 0).

    ``("circle", w, v)``: constant arc. Twists are [dth, dx, dy]
    velocities (rad/s, m/s)."""
    kind = scn.command[0]
    if kind != "circle":
        raise ValueError(f"unknown command kind {kind!r}")
    if not torch.is_tensor(t):
        t = torch.arange(t, device=resolve(device))
    w, v = scn.command[1], scn.command[2]
    z = torch.zeros_like(t, dtype=dtype)
    return torch.stack([torch.full_like(z, w), torch.full_like(z, v), z],
                       dim=-1)


def draw_noise(scn: ScenarioConfig, generator: torch.Generator, batch=(),
               dtype=torch.float32) -> tw.TickNoise:
    """One tick's standard draws for this scenario's worlds."""
    return tw.draw_tick_noise(
        generator, batch, scn.sim_substeps, scn.world_config().num_rays,
        len(scn.tubes), dtype)


def sense_tick(scn: ScenarioConfig, params: tw.WorldParams,
               state: SenseState, cmd, noise: tw.TickNoise,
               margins: dict | None = None):
    """The non-filter part of one SLAM tick: ``sim_substeps`` 50 Hz sim
    steps + odometry + the measurement stage (fake sensor or the full
    lidar -> cluster -> circle-fit chain), for worlds of any leading batch
    shape. Only the last substep's observations are consumed (latest-topic
    sampling), so the substeps advance dynamics only; on the card the sim
    is one kernel launch for all worlds (``ops/kernels/sim_tick``).
    Returns ``(new SenseState, twist, zs (..., M, 2), valid (..., M),
    obs)``."""
    dev = params.tube_locs.device
    with stage("tick.sim", dev):
        # the substeps, observe and the odometry from the commanded joint
        # states (ref slam.cpp:264-265): one launch on the card
        world, obs, odom, twist = sim_tick.step(
            scn.world_config(), params, state.world, cmd, scn.dt, noise,
            scn.sim_substeps, state.odom)

    # --- measurements
    with stage("tick.perception", dev):
        if scn.use_lidar:
            det = detect_landmarks(
                obs.scan, params.scan_min, params.scan_max,
                max_clusters=scn.max_clusters,
                max_points=scn.max_cluster_points, margins=margins)
            positions, valid = det.positions, det.valid
        else:
            positions, valid = obs.fake_sensor, obs.fake_sensor_valid

        zs = ekf.cartesian2polar(positions[..., 0], positions[..., 1])
    return SenseState(world=world, odom=odom), twist, zs, valid, obs


def filter_tick(scn: ScenarioConfig, Q, R, filt: ekf.EKFState, twist, zs,
                valid) -> ekf.EKFState:
    """The dense engine's part of one world's tick: predict and the
    sequential updates, with known (ids = measurement order) or unknown
    association."""
    ecfg = scn.ekf_config()
    if scn.known_association:
        ids = torch.arange(zs.shape[0], dtype=torch.int32, device=zs.device)
        return ekf.known_association_step(ecfg, filt, twist, zs, valid, ids,
                                          Q, R)
    return ekf.step(ecfg, filt, twist, zs, valid, Q, R)


def slam_tick(scn: ScenarioConfig, params: tw.WorldParams, Q, R,
              state: PipelineState, cmd, noise: tw.TickNoise) -> tuple:
    """One 10 Hz SLAM tick of a single world on the dense engine
    (= ``sim_substeps`` 50 Hz sim ticks + odometry + EKF)."""
    sense, twist, zs, valid, obs = sense_tick(
        scn, params, SenseState(state.world, state.odom), cmd, noise)
    filt = filter_tick(scn, Q, R, state.filt, twist, zs, valid)
    slam_pose = filt.mean[:3]
    out = TickOutput(
        true_pose=obs.true_pose,
        odom_pose=sense.odom.pose,
        slam_pose=slam_pose,
        n_seen=filt.n_seen,
        nees=nees_fn(slam_pose, obs.true_pose, filt.cov[:3, :3]),
    )
    return PipelineState(world=sense.world, odom=sense.odom, filt=filt), out


class NoiseSource:
    """A run's noise, tick by tick: drawn from a generator, or read from a
    precomputed sequence (fields with a leading T)."""

    def __init__(self, scn, noise, batch, dtype, device):
        if isinstance(noise, torch.Generator):
            if resolve(noise.device) != resolve(device):
                raise ValueError(f"generator on {noise.device}, run on "
                                 f"{device}")
            self._draw = lambda t: draw_noise(scn, noise, batch, dtype)
        elif isinstance(noise, tw.TickNoise):
            self._draw = lambda t: tw.TickNoise(*(f[t] for f in noise))
        else:
            raise TypeError("noise must be a torch.Generator or a TickNoise "
                            f"sequence, got {type(noise).__name__}")

    def tick(self, t: int) -> tw.TickNoise:
        return self._draw(t)


def alloc_outputs(lead, T, dtype, device) -> TickOutput:
    f = lambda *s: torch.empty((*lead, T, *s), dtype=dtype, device=device)
    return TickOutput(true_pose=f(3), odom_pose=f(3), slam_pose=f(3),
                      n_seen=torch.empty((*lead, T), dtype=torch.int32,
                                         device=device),
                      nees=f())


def rollout(scn: ScenarioConfig, params: tw.WorldParams, Q, R,
            state: PipelineState, noise, steps=None, on_tick=None):
    """Run ``slam_tick`` over the scenario's command schedule. ``noise`` is
    a ``torch.Generator`` on the state's device or a :class:`TickNoise`
    sequence; ``on_tick(state, out)`` (optional) sees each tick's result.
    Returns (final PipelineState, stacked TickOutput (T, ...))."""
    T = scn.steps if steps is None else steps
    dtype = state.odom.pose.dtype
    dev = state.odom.pose.device
    cmds = command_twist(scn, T, dtype, dev)
    src = NoiseSource(scn, noise, (), dtype, dev)
    outs = alloc_outputs((), T, dtype, dev)
    for t in range(T):
        state, out = slam_tick(scn, params, Q, R, state, cmds[t],
                               src.tick(t))
        if on_tick is not None:
            on_tick(state, out)
        for dst, val in zip(outs, out):
            dst[t] = val
    return state, outs


def run_scenario(scn: ScenarioConfig, noise, dtype=torch.float32,
                 device=None, steps=None, on_tick=None) -> TickOutput:
    """End-to-end scenario run of a single world on the dense engine.
    ``noise``: a ``torch.Generator`` on ``device`` or a :class:`TickNoise`
    sequence; ``device=None`` is the card; ``on_tick`` as in
    :func:`rollout`. Returns stacked TickOutputs ``(T, ...)``; metrics are
    computed by the caller."""
    device = resolve(device)
    params = scn.world_params(dtype, device)
    Q, R = scn.noise_matrices(dtype, device)
    state = init_pipeline(scn, dtype, device)
    _, outs = rollout(scn, params, Q, R, state, noise, steps=steps,
                      on_tick=on_tick)
    return outs


def run_scenario_batch(scn: ScenarioConfig, noise, batch: int, steps=None,
                       dtype=torch.float32, device=None) -> TickOutput:
    """Batched scenario run on the dense engine: ``batch`` independent
    worlds advance in lockstep, each filter a single-world
    ``models.ekf_slam`` state under ``torch.func.vmap`` (mean ``(B, D)``,
    covariance ``(B, D, D)``), the sim and perception batch-first
    ``(B, ...)``. Semantics identical to :func:`run_scenario_batch_lanes`;
    returns the same ``(B, T, ...)`` TickOutputs.

    ``noise``: a ``torch.Generator`` on ``device`` or a :class:`TickNoise`
    sequence with fields ``(T, B, ...)``; ``device=None`` is the card.
    Scenarios take the plain update (``pallas_update='auto'``)."""
    device = resolve(device)
    ecfg = scn.ekf_config()
    params = scn.world_params(dtype, device)
    Q, R = scn.noise_matrices(dtype, device)
    T = scn.steps if steps is None else steps
    B = batch
    cmds = command_twist(scn, T, dtype, device)
    src = NoiseSource(scn, noise, (B,), dtype, device)

    sense = init_sense(params, dtype, (B,))
    one = ekf.init(ecfg, [0.0, 0.0, 0.0], dtype=dtype, device=device)
    filt = ekf.EKFState(*(f.expand(B, *f.shape).clone() for f in one))
    step = torch.func.vmap(
        lambda f, tw_, zs_, v_: filter_tick(scn, Q, R, f, tw_, zs_, v_))
    outs = alloc_outputs((B,), T, dtype, device)
    for t in range(T):
        sense, twist, zs, valid, obs = sense_tick(
            scn, params, sense, cmds[t], src.tick(t))
        filt = step(filt, twist, zs, valid)
        slam_pose = filt.mean[:, :3]
        outs.true_pose[:, t] = obs.true_pose
        outs.odom_pose[:, t] = sense.odom.pose
        outs.slam_pose[:, t] = slam_pose
        outs.n_seen[:, t] = filt.n_seen
        outs.nees[:, t] = nees_fn(slam_pose, obs.true_pose,
                                  filt.cov[:, :3, :3])
    return outs


def run_scenario_batch_lanes(scn: ScenarioConfig, noise, batch: int,
                             steps=None, dtype=torch.float32, device=None,
                             margins: dict | None = None,
                             on_tick=None,
                             gate_trace: list | None = None) -> TickOutput:
    """Batched scenario run on the batch-trailing engine
    (``models.ekf_batch``): ``batch`` independent worlds advance in
    lockstep; the sim and perception are batch-first ``(B, ...)``, the
    filter keeps ``(D, B)`` / ``(D, D, B)``, and the driver transposes
    exactly where the JAX driver does. Returns ``(B, T, ...)`` TickOutputs.

    ``noise``: a ``torch.Generator`` on ``device`` or a :class:`TickNoise`
    sequence with fields ``(T, B, ...)``; ``device=None`` is the card.
    ``margins`` (a dict, diagnostics) collects, over the run, the smallest
    distances of a split, a circle and a gate decision to their thresholds
    (tensors; no host sync). ``on_tick(t, obs, zs, valid)`` is called after
    each tick's measurement stage (a hook for callers that consume the
    scans). ``gate_trace`` (a list, diagnostics) receives each tick's
    smallest relative gate margin of every world, a (B,) tensor, on
    unknown association: where a world parts from another run, it tells a
    rounding tie at a gate from a fault.

    The filter's tick is one kernel launch for all B worlds on the card
    (``ops/kernels/ekf_tick``; it raises on a state it does not take,
    such as float64) and the plain ``ekf_batch`` tick on the CPU."""
    device = resolve(device)
    params = scn.world_params(dtype, device)
    Q, R = scn.noise_matrices(dtype, device)
    ecfg = scn.ekf_config()
    T = scn.steps if steps is None else steps
    B = batch
    cmds = command_twist(scn, T, dtype, device)
    src = NoiseSource(scn, noise, (B,), dtype, device)

    M = scn.max_clusters if scn.use_lidar else len(scn.tubes)
    # known association: the ids are the measurement order
    ids = torch.arange(M, dtype=torch.int32, device=device).expand(
        B, M).contiguous() if scn.known_association else None
    sense = init_sense(params, dtype, (B,))
    filt = ekf_batch.init(ecfg, B, dtype=dtype, device=device)
    outs = alloc_outputs((B,), T, dtype, device)
    gate_margins = [] if margins is not None or gate_trace is not None \
        else None
    tick_margins = {} if margins is not None else None

    for t in range(T):
        sense, twist, zs, valid, obs = sense_tick(
            scn, params, sense, cmds[t], src.tick(t), tick_margins)
        if on_tick is not None:
            on_tick(t, obs, zs, valid)
        with stage("tick.filter", device):
            filt = ekf_tick.step(ecfg, filt, twist, zs, valid, Q, R, ids,
                                 gate_margins)
        slam_pose = filt.mean[:3].T                         # (B, 3)
        cov_rr = filt.cov[:3, :3].permute(2, 0, 1)          # (B, 3, 3)
        outs.true_pose[:, t] = obs.true_pose
        outs.odom_pose[:, t] = sense.odom.pose
        outs.slam_pose[:, t] = slam_pose
        outs.n_seen[:, t] = filt.n_seen
        outs.nees[:, t] = nees_fn(slam_pose, obs.true_pose, cov_rr)
        if margins is not None:
            for k, v in tick_margins.items():
                margins[k] = torch.minimum(margins[k], v) if k in margins \
                    else v
        if gate_margins:
            g = torch.stack(gate_margins).amin(0)               # (B,)
            gate_margins.clear()
            if gate_trace is not None:
                gate_trace.append(g)
            if margins is not None:
                margins["gate"] = torch.minimum(margins["gate"], g.min()) \
                    if "gate" in margins else g.min()
    return outs
