"""Vectorized tube-world simulator (port of
``shermbot_navigation_tpu.sim.tube_world``): the ground-truth world as a
pure ``step(config, params, state, cmd, dt, noise) -> (state, obs)``
function, batch-first: the state carries leading batch dimensions (one
world each) where the JAX package is vmapped.

One call reproduces one tick of the reference ``tube_world`` node
(``nuturtlesim/src/tube_world.cpp:473-544``):

1. command twist + N(0, twist_noise) on (dth, dx)              (:177-189)
2. tube collision check -> tangential nudge                    (:371-389)
3. twist -> wheel velocities; commanded wheel angles += u*dt   (:516-525)
4. TRUE configuration update from slip-perturbed wheel angles  (:528-529)
5. observations from the updated true pose: relative landmark markers
   with range gate + tube_var offset (:270-329), and a simulated 360-ray
   lidar scan (:405-471).

The wheel-slip model is the reference's, quirk included: the true wheel
angle each tick is ``commanded_angle + u * eta`` with
``eta ~ N((slip_min+slip_max)/2, slip_max - mean)``. The two lidar quirks
of the reference sit behind ``reference_lidar_quirks`` as in the JAX
package.

**Randomness is an explicit input.** Where the JAX functions take a PRNG
key, these take standard draws (:class:`StepNoise`, :class:`ObsNoise`, or a
whole tick's :class:`TickNoise`) and scale them exactly as the JAX code
scales its own: twist normals by ``twist_noise``, slip normals to ``eta``,
scan normals by ``scan_noise``, and the keep uniforms against the dropout
rates. :func:`draw_tick_noise` makes a tick's draws from an explicit
``torch.Generator``; a test hands over the numbers the JAX key tree gives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from ..device import resolve
from ..ops import diff_drive as dd
from ..ops import se2


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static world configuration; field for field the JAX
    ``WorldConfig``. ``compute_scan`` / ``compute_fake_sensor`` gate the
    observation channels (a scenario that never consumes the lidar does
    not compute it)."""

    num_rays: int = 360                 # scan_params.yaml: sample_num
    reference_lidar_quirks: bool = False
    collision_nudge: float = 1.0 / 50.0  # tube_world.cpp:387 "tangent/50"
    compute_scan: bool = True
    compute_fake_sensor: bool = True
    # "reference": true wheel angle = commanded + u*eta (tube_world.cpp:528
    #   quirk: the noise telescopes, so odometry error stays bounded).
    # "multiplicative": per-tick wheel increment scaled by eta (physical
    #   slip whose odometry error accumulates).
    slip_mode: str = "reference"


class WorldParams(NamedTuple):
    """Runtime world parameters (ref ``tube_world_params.yaml`` +
    ``scan_params.yaml`` + ``diff_params.yaml``): ``tube_locs`` (K, 2) and
    0-dim tensors, all of one dtype on one device."""

    tube_locs: torch.Tensor    # (K, 2) tube centers in the world frame
    tube_rad: torch.Tensor     # 0.0381
    robot_rad: torch.Tensor    # 0.08
    max_range: torch.Tensor    # fake-sensor visibility gate, 1.0
    tube_var: torch.Tensor     # constant offset added to relative markers
    twist_noise: torch.Tensor  # stddev on commanded (dth, dx), 0.0
    slip_min: torch.Tensor     # 0.9
    slip_max: torch.Tensor     # 1.0
    scan_min: torch.Tensor     # 0.05
    scan_max: torch.Tensor     # 1.0
    scan_noise: torch.Tensor   # stddev on in-range lidar ranges
    sensor_dropout: torch.Tensor  # fault injection: P(drop a visible marker)
    scan_dropout: torch.Tensor    # fault injection: P(drop a lidar ray)
    wheel_base: torch.Tensor   # 0.16
    wheel_rad: torch.Tensor    # 0.033


def default_params(tube_locs=None, dtype=torch.float32, device=None,
                   **overrides) -> WorldParams:
    """The reference's stock world (6 tubes, tube_world_params.yaml:1-16);
    ``device=None`` is the card."""
    device = resolve(device)
    if tube_locs is None:
        tube_locs = [[0.5, 0.5], [-0.5, -0.5], [1.0, 1.0],
                     [-1.0, -1.0], [-0.75, 0.75], [0.75, -0.75]]
    vals = dict(
        tube_locs=tube_locs,
        tube_rad=0.0381, robot_rad=0.08, max_range=1.0, tube_var=0.001,
        twist_noise=0.0, slip_min=0.9, slip_max=1.0,
        scan_min=0.05, scan_max=1.0, scan_noise=0.0,
        sensor_dropout=0.0, scan_dropout=0.0,
        wheel_base=0.16, wheel_rad=0.033,
    )
    vals.update(overrides)
    # through float64 first, so an f32 parameter is the f32 rounding of the
    # decimal constant, as in the JAX package
    return WorldParams(**{
        k: torch.as_tensor(v, dtype=torch.float64).to(device=device,
                                                      dtype=dtype)
        for k, v in vals.items()})


class WorldState(NamedTuple):
    """Simulator state. ``drive`` holds the TRUE robot configuration
    (slip-perturbed wheels); ``cmd_wheels`` is the commanded/published
    wheel angle pair, which is what odometry consumers see."""

    drive: dd.DiffDriveState
    cmd_wheels: torch.Tensor  # (..., 2)


class Observation(NamedTuple):
    """Everything the reference publishes per tick, as tensors."""

    joint_states: torch.Tensor   # (..., 2) commanded wheel angles
    fake_sensor: torch.Tensor    # (..., K, 2) tube positions, robot frame
    fake_sensor_valid: torch.Tensor  # (..., K) bool: within max_range
    scan: torch.Tensor           # (..., num_rays) ranges
    true_pose: torch.Tensor      # (..., 3) [th, x, y] ground truth


class StepNoise(NamedTuple):
    """Standard normal draws of one :func:`step_dynamics` call."""

    twist: torch.Tensor  # (..., 2) for the commanded (dth, dx)
    slip: torch.Tensor   # (..., 2) for the two wheels' eta


class ObsNoise(NamedTuple):
    """Standard draws of one :func:`observe` call."""

    scan: torch.Tensor         # (..., n) normals for the lidar ranges
    marker_keep: torch.Tensor  # (..., K) uniforms in [0, 1)
    scan_keep: torch.Tensor    # (..., n) uniforms in [0, 1)


class TickNoise(NamedTuple):
    """Standard draws of one SLAM tick: ``S`` simulator substeps and one
    observation."""

    twist: torch.Tensor        # (..., S, 2)
    slip: torch.Tensor         # (..., S, 2)
    scan: torch.Tensor         # (..., n)
    marker_keep: torch.Tensor  # (..., K)
    scan_keep: torch.Tensor    # (..., n)

    def substep(self, k: int) -> StepNoise:
        return StepNoise(twist=self.twist[..., k, :],
                         slip=self.slip[..., k, :])

    @property
    def obs(self) -> ObsNoise:
        return ObsNoise(scan=self.scan, marker_keep=self.marker_keep,
                        scan_keep=self.scan_keep)


def draw_tick_noise(generator: torch.Generator, batch=(), substeps: int = 5,
                    num_rays: int = 360, num_tubes: int = 6,
                    dtype=torch.float32) -> TickNoise:
    """One tick's standard draws for worlds of shape ``batch``, from an
    explicit generator, on the generator's device."""
    dev = generator.device
    kw = dict(generator=generator, dtype=dtype, device=dev)
    return TickNoise(
        twist=torch.randn((*batch, substeps, 2), **kw),
        slip=torch.randn((*batch, substeps, 2), **kw),
        scan=torch.randn((*batch, num_rays), **kw),
        marker_keep=torch.rand((*batch, num_tubes), **kw),
        scan_keep=torch.rand((*batch, num_rays), **kw))


def init_state(params: WorldParams, dtype=torch.float32, batch=()
               ) -> WorldState:
    """Worlds at rest at the origin, on the params' device."""
    dev = params.tube_locs.device
    return WorldState(
        drive=dd.init_state(dtype=dtype, device=dev, batch=batch),
        cmd_wheels=torch.zeros((*batch, 2), dtype=dtype, device=dev))


def _resolve_collisions(config: WorldConfig, params: WorldParams, drive):
    """Slide along the tangent on tube contact (ref check_collision,
    tube_world.cpp:371-389). Vectorized over tubes: contributions from all
    colliding tubes sum, as in the JAX package."""
    pose = drive.pose
    delta = params.tube_locs - pose[..., None, 1:3]      # (..., K, 2)
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    dist = torch.clamp_min(dist, 1e-9)
    hit = dist <= (params.tube_rad + params.robot_rad)
    move = torch.stack([delta[..., 1], -delta[..., 0]], dim=-1
                       ) / dist[..., None]
    nudge = torch.sum(
        torch.where(hit[..., None], move * config.collision_nudge,
                    torch.zeros_like(move)), dim=-2)
    return dd.nudge(drive, nudge[..., 0], nudge[..., 1])


def _fake_sensor(params: WorldParams, pose):
    """Relative landmark markers (ref set_rel_markers,
    tube_world.cpp:270-329): tube positions in the robot frame plus the
    constant ``tube_var`` offset, gated by distance <= max_range."""
    T_wt = se2.from_pose(pose)
    rel = se2.apply(se2.inv(T_wt)[..., None, :], params.tube_locs)
    rel = rel + params.tube_var                          # (..., K, 2)
    delta = params.tube_locs - pose[..., None, 1:3]
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    return rel, dist <= params.max_range


def _lidar(config: WorldConfig, params: WorldParams, pose, scan_normals):
    """Simulated scan (ref simulate_lidar_scanner, tube_world.cpp:405-471)
    as one (rays x tubes) broadcast per world: with the robot at p1 and
    unit ray direction u in tube-centered coordinates, solve
    ``|p1 + t u| = tube_rad`` for the smallest positive t. Misses and
    backward hits return scan_max + 1 (the reference's out-of-range
    sentinel). ``scan_normals (..., n)`` are the standard draws that
    ``scan_noise`` scales."""
    th, x, y = pose[..., 0], pose[..., 1], pose[..., 2]
    n = config.num_rays
    bins = torch.arange(n, dtype=pose.dtype, device=pose.device)

    if config.reference_lidar_quirks:
        # integer world-frame ray angles offset by trunc(deg(th)) (:459-460)
        ray_deg = bins + torch.trunc(se2.rad2deg(th))[..., None]
        ang = se2.deg2rad(ray_deg)
    else:
        ang = th[..., None] + 2.0 * math.pi * bins / n

    ux, uy = torch.cos(ang), torch.sin(ang)             # (..., n)

    # robot position relative to each tube: (..., K, 2)
    p1 = pose[..., None, 1:3] - params.tube_locs
    # quadratic: t^2 + 2 t (p1.u) + |p1|^2 - r^2 = 0, broadcast (..., n, K)
    b = (p1[..., None, :, 0] * ux[..., :, None]
         + p1[..., None, :, 1] * uy[..., :, None])
    c = torch.sum(p1 * p1, dim=-1)[..., None, :] - params.tube_rad ** 2
    disc = b * b - c
    safe_sqrt = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = -b - safe_sqrt
    t2 = -b + safe_sqrt

    if config.reference_lidar_quirks:
        # The reference intersects the infinite LINE, not the forward ray
        # (:444-453): both intersection points' absolute distances compete.
        # Near-tangent band |disc| < eps takes the perpendicular-foot
        # distance |b| instead (:439-442).
        eps = 1e-5 / (params.scan_max * params.scan_max)
        tangent = torch.abs(disc) < eps
        t = torch.minimum(torch.abs(t1), torch.abs(t2))
        t = torch.where(tangent, torch.abs(b), t)
        miss = disc <= -eps
        # cone gate with the reference's center formula (:428):
        # tube_angle = round(deg(atan2(2*yt - yr, 2*xt - xr))), [-27, 26]
        t_ang = torch.atan2(2.0 * params.tube_locs[:, 1] - y[..., None],
                            2.0 * params.tube_locs[:, 0] - x[..., None])
        t_deg = se2.rad2deg(t_ang)                       # (..., K)
        # C round(): half away from zero
        t_deg = torch.sign(t_deg) * torch.floor(torch.abs(t_deg) + 0.5)
        ray_deg_grid = ray_deg[..., :, None]             # (..., n, 1)
        ddeg = torch.remainder(
            ray_deg_grid - t_deg[..., None, :] + 180.0, 360.0) - 180.0
        in_cone = (ddeg >= -27.0) & (ddeg <= 26.0)
        # dy == 0 NaN quirk (:444-449): rays at ray_deg = 0 mod 360 NaN out
        # in the two-point branch but still hit in the tangent branch
        nan_ray = torch.remainder(ray_deg_grid, 360.0) == 0.0
        miss = miss | ~in_cone | (nan_ray & ~tangent)
    else:
        t = torch.where(t1 > 0.0, t1, t2)               # nearest forward hit
        miss = (disc < 0.0) | (t <= 0.0)

    t = torch.where(miss, (params.scan_max + 1.0).expand(t.shape), t)
    ranges = torch.min(t, dim=-1).values                 # z-buffer over tubes

    noisy = ranges + params.scan_noise * scan_normals
    return torch.where(ranges > params.scan_max, ranges, noisy)


def step_dynamics(config: WorldConfig, params: WorldParams,
                  state: WorldState, cmd_twist, dt, noise: StepNoise
                  ) -> WorldState:
    """Advance the world one tick WITHOUT computing observations (the hot
    path when only the last substep's topics are consumed). ``cmd_twist``
    is ``(3,)`` or ``(..., 3)``."""
    dtype = state.cmd_wheels.dtype

    # 1. twist noise (twist_callback, :177-189): N(0, twist_noise) on dth, dx
    tn = params.twist_noise * noise.twist
    cmd = cmd_twist.to(dtype)
    tw = torch.stack([cmd[..., 0] + tn[..., 0], cmd[..., 1] + tn[..., 1],
                      cmd[..., 2] + torch.zeros_like(tn[..., 0])], dim=-1)

    # 2. collision resolve against the pre-update true pose (:513)
    drive = _resolve_collisions(config, params, state.drive)

    # 3. wheel velocities and commanded wheel angles (:516-525)
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)
    u = dd.twist_to_wheels(dparams, tw)
    cmd_wheels = state.cmd_wheels + u * dt

    # 4. true update from slip-perturbed wheel angles (:480-483, :528-529)
    slip_mean = (params.slip_min + params.slip_max) / 2.0
    slip_var = params.slip_max - slip_mean
    eta = slip_mean + slip_var * noise.slip
    if config.slip_mode == "multiplicative":
        # physical slip: this tick's true increment is scaled by eta
        drive = dd.step(dparams, drive, drive.wheels + u * dt * eta)
    else:
        drive = dd.step(dparams, drive, cmd_wheels + u * eta)

    return WorldState(drive=drive, cmd_wheels=cmd_wheels)


def observe(config: WorldConfig, params: WorldParams, state: WorldState,
            noise: ObsNoise) -> Observation:
    """Produce the tick's observations from the current true pose
    (set_rel_markers + simulate_lidar_scanner). Channels gated by
    ``config.compute_*`` return zeros when off."""
    dtype = state.cmd_wheels.dtype
    dev = state.cmd_wheels.device
    pose = state.drive.pose
    batch = pose.shape[:-1]
    K = params.tube_locs.shape[0]

    if config.compute_fake_sensor:
        rel, rel_valid = _fake_sensor(params, pose)
        # fault injection: random marker dropout
        rel_valid = rel_valid & (noise.marker_keep >= params.sensor_dropout)
    else:
        rel = torch.zeros((*batch, K, 2), dtype=dtype, device=dev)
        rel_valid = torch.zeros((*batch, K), dtype=torch.bool, device=dev)

    if config.compute_scan:
        scan = _lidar(config, params, pose, noise.scan)
        keep = noise.scan_keep >= params.scan_dropout
        scan = torch.where(keep, scan,
                           (params.scan_max + 1.0).expand(scan.shape))
    else:
        scan = torch.zeros((*batch, config.num_rays), dtype=dtype,
                           device=dev)

    return Observation(joint_states=state.cmd_wheels, fake_sensor=rel,
                       fake_sensor_valid=rel_valid, scan=scan,
                       true_pose=pose)


def step(config: WorldConfig, params: WorldParams, state: WorldState,
         cmd_twist, dt, step_noise: StepNoise, obs_noise: ObsNoise
         ) -> Tuple[WorldState, Observation]:
    """One simulator tick with observations. ``cmd_twist`` is
    ``[dth, dx, dy]`` (dy ignored by the diff drive), ``dt`` the tick
    period (1/50 s at the reference rate)."""
    new_state = step_dynamics(config, params, state, cmd_twist, dt,
                              step_noise)
    return new_state, observe(config, params, new_state, obs_noise)


def rollout(config: WorldConfig, params: WorldParams, state: WorldState,
            cmd_twists, dt, noise: TickNoise):
    """Run :func:`step` over a (T, 3) command sequence -> (final state,
    stacked Observations with a leading T). ``noise`` holds one
    single-substep :class:`TickNoise` per step: every field has a leading
    T, and S = 1."""
    obs = []
    for t in range(cmd_twists.shape[0]):
        tick = TickNoise(*(f[t] for f in noise))
        state, o = step(config, params, state, cmd_twists[t], dt,
                        tick.substep(0), tick.obs)
        obs.append(o)
    return state, Observation(*(torch.stack(f) for f in zip(*obs)))
