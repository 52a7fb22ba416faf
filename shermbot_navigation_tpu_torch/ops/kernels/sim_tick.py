"""The simulator's whole tick in one kernel (``csrc/sim_tick.cu``), with its
plain version.

:func:`step` takes B worlds' ``tube_world.WorldState`` and one tick's
draws (``tube_world.TickNoise``) and runs what the sim block of
``pipeline/driver.sense_tick`` runs: ``substeps`` calls of
``tube_world.step_dynamics``, then ``tube_world.observe`` and, given the
odometry's state, the odometry from the commanded joint states
(``diff_drive.wheels_to_twist`` and ``diff_drive.step``). On the card that
is one launch for all B worlds, where the eager chain launched ~560
kernels a tick and broadcast (B, n, K) ray-tube tensors. The plain
version, :func:`reference_tick`, is that chain; the kernel repeats its
operations one rounding at a time, in float32 and float64, with the branch
the ``WorldConfig`` asks for (slip mode, channels, lidar quirks) chosen by
a launch flag.

It replaces no TPU kernel (the JAX package leaves the sim to XLA). The
wrapper follows the package rule (``ops/kernels/__init__.py``): the
kernel for a state on the card, the plain version on the CPU; on a CUDA
operand the kernel does not take (another dtype, a shape the chain would
not broadcast to, more than :data:`MAX_TUBES` tubes) it raises, never
falls back. ``step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ...sim import tube_world as tw
from .. import diff_drive as dd
from . import require, wants_kernel
from ._build import check, library, stream_handle

NAME = "sim_tick"
MAX_TUBES = 64              # rows of the kernel's shared tube table

# launch flags (csrc/sim_tick.cu)
QUIRKS, MULTIPLICATIVE, SCAN, FAKE, ODOM = 1, 2, 4, 8, 16

# the kernel's operands, in the order of its In and Out enums
PARAMS = ("tube_locs", "tube_rad", "robot_rad", "max_range", "tube_var",
          "twist_noise", "slip_min", "slip_max", "scan_max", "scan_noise",
          "sensor_dropout", "scan_dropout", "wheel_base", "wheel_rad")
IN = ("pose", "wheels", "cmd_wheels", "odom_pose", "odom_wheels", "cmd",
      *PARAMS, "twist", "slip", "scan", "marker_keep", "scan_keep")
OUT = ("pose", "wheels", "cmd_wheels", "scan", "fake_sensor",
       "fake_sensor_valid", "odom_pose", "twist")


class SimTick(NamedTuple):
    """One tick's result: the new world, its observations, and (given the
    odometry's state) the new odometry and the odometry twist, else None."""

    world: tw.WorldState
    obs: tw.Observation
    odom: dd.DiffDriveState | None
    twist: torch.Tensor | None


def reference_tick(config: tw.WorldConfig, params: tw.WorldParams,
                   world: tw.WorldState, cmd, dt, noise: tw.TickNoise,
                   substeps: int, odom: dd.DiffDriveState | None = None
                   ) -> SimTick:
    """The plain version: ``substeps`` ``tube_world.step_dynamics`` calls
    holding ``cmd``, ``tube_world.observe``, and the odometry from the
    commanded joint states where ``odom`` is given."""
    for k in range(substeps):
        world = tw.step_dynamics(config, params, world, cmd, dt,
                                 noise.substep(k))
    obs = tw.observe(config, params, world, noise.obs)
    if odom is None:
        return SimTick(world, obs, None, None)
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)
    twist = dd.wheels_to_twist(dparams, obs.joint_states - odom.wheels)
    odom = dd.step(dparams, odom, obs.joint_states)
    return SimTick(world, obs, odom, twist)


def flags(config: tw.WorldConfig, odom: bool) -> int:
    return ((QUIRKS if config.reference_lidar_quirks else 0)
            | (MULTIPLICATIVE if config.slip_mode == "multiplicative" else 0)
            | (SCAN if config.compute_scan else 0)
            | (FAKE if config.compute_fake_sensor else 0)
            | (ODOM if odom else 0))


def operands(config: tw.WorldConfig, params: tw.WorldParams,
             world: tw.WorldState, cmd, dt, noise: tw.TickNoise,
             substeps: int, odom: dd.DiffDriveState | None = None) -> dict:
    """The kernel's operands by name, each checked (dtype, device, the
    shape the plain chain reads) and contiguous; raises on one the kernel
    does not take. Pure: no card, no build."""
    dtype, dev = world.cmd_wheels.dtype, world.cmd_wheels.device
    require(dtype in (torch.float32, torch.float64), NAME,
            f"the state must be torch.float32 or torch.float64, got {dtype}")
    require(isinstance(dt, (int, float)) and not isinstance(dt, bool), NAME,
            f"dt must be a number, got {type(dt).__name__}")
    require(isinstance(substeps, int) and substeps >= 0, NAME,
            f"substeps must be a whole number >= 0, got {substeps!r}")
    lead = tuple(world.cmd_wheels.shape[:-1])
    K, n = params.tube_locs.shape[0], config.num_rays
    require(params.tube_locs.dim() == 2 and 1 <= K <= MAX_TUBES, NAME,
            f"tube_locs must be (K, 2) with 1 <= K <= {MAX_TUBES}, got "
            f"{tuple(params.tube_locs.shape)}")
    require(n >= 1, NAME, f"num_rays must be >= 1, got {n}")
    S = noise.twist.shape[-2] if noise.twist.dim() >= 2 else -1
    require(S >= substeps, NAME,
            f"the draws hold {S} substeps, the tick runs {substeps}")
    spec = {"pose": (world.drive.pose, (*lead, 3)),
            "wheels": (world.drive.wheels, (*lead, 2)),
            "cmd_wheels": (world.cmd_wheels, (*lead, 2)),
            "cmd": (cmd, (3,) if getattr(cmd, "ndim", 0) == 1
                     else (*lead, 3)),
            "tube_locs": (params.tube_locs, (K, 2)),
            **{k: (getattr(params, k), ()) for k in PARAMS[1:]},
            "twist": (noise.twist, (*lead, S, 2)),
            "slip": (noise.slip, (*lead, S, 2))}
    if odom is not None:
        spec["odom_pose"] = (odom.pose, (*lead, 3))
        spec["odom_wheels"] = (odom.wheels, (*lead, 2))
    if config.compute_scan:
        spec["scan"] = (noise.scan, (*lead, n))
        spec["scan_keep"] = (noise.scan_keep, (*lead, n))
    if config.compute_fake_sensor:
        spec["marker_keep"] = (noise.marker_keep, (*lead, K))
    ops = {}
    for key, (t, shape) in spec.items():
        if not (isinstance(t, torch.Tensor) and t.shape == shape
                and t.dtype == dtype and t.device == dev):
            require(False, NAME,
                    f"{key} must be {dtype} {shape} on {dev}, got "
                    + (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                       if isinstance(t, torch.Tensor) else repr(t)))
        ops[key] = t.contiguous()
    require(math.prod(lead) >= 1, NAME, "needs at least one world")
    return ops


def _launch(config, params, world, cmd, dt, noise, substeps, odom):
    ops = operands(config, params, world, cmd, dt, noise, substeps, odom)
    lead = tuple(world.cmd_wheels.shape[:-1])
    dtype, dev = world.cmd_wheels.dtype, world.cmd_wheels.device
    B, K, n = math.prod(lead), params.tube_locs.shape[0], config.num_rays

    def new(*shape, of=dtype):
        return torch.empty((*lead, *shape), dtype=of, device=dev)

    outs = {"pose": new(3), "wheels": new(2), "cmd_wheels": new(2),
            "scan": new(n), "fake_sensor": new(K, 2),
            "fake_sensor_valid": new(K, of=torch.bool),
            "odom_pose": new(3) if odom is not None else None,
            "twist": new(3) if odom is not None else None}
    ptr = lambda t: None if t is None else t.data_ptr()
    ins = (ctypes.c_void_p * len(IN))(*(ptr(ops.get(k)) for k in IN))
    out = (ctypes.c_void_p * len(OUT))(*(ptr(outs[k]) for k in OUT))
    check(NAME, library().sim_tick(
        ins, out, B, K, n, ops["twist"].shape[-2], substeps,
        0 if ops["cmd"].dim() == 1 else 3, flags(config, odom is not None),
        int(dtype == torch.float64), float(dt),
        float(config.collision_nudge), stream_handle(dev)))
    step.launches += 1
    new_world = tw.WorldState(
        drive=dd.DiffDriveState(pose=outs["pose"], wheels=outs["wheels"]),
        cmd_wheels=outs["cmd_wheels"])
    obs = tw.Observation(joint_states=outs["cmd_wheels"],
                         fake_sensor=outs["fake_sensor"],
                         fake_sensor_valid=outs["fake_sensor_valid"],
                         scan=outs["scan"], true_pose=outs["pose"])
    if odom is None:
        return SimTick(new_world, obs, None, None)
    # the odometry's wheels are the joint states, as in diff_drive.step
    return SimTick(new_world, obs,
                   dd.DiffDriveState(pose=outs["odom_pose"],
                                     wheels=outs["cmd_wheels"]),
                   outs["twist"])


def step(config: tw.WorldConfig, params: tw.WorldParams,
         world: tw.WorldState, cmd, dt, noise: tw.TickNoise, substeps: int,
         odom: dd.DiffDriveState | None = None) -> SimTick:
    """One simulator tick of worlds of any leading batch shape: the world
    after ``substeps`` substeps holding ``cmd`` ((3,) or one a world),
    its observations, and, where ``odom`` is given, the odometry and its
    twist ``(..., 3)``. ``dt`` is the substep's period (a number);
    ``noise`` one tick's draws (twist and slip ``(..., S, 2)`` with S >=
    ``substeps``)."""
    if not wants_kernel(world.cmd_wheels):
        return reference_tick(config, params, world, cmd, dt, noise,
                              substeps, odom)
    launch = _launch
    if torch.compiler.is_compiling():
        # a caller under torch.compile (the compile entry, entry.py): the
        # ctypes launch is opaque to it and runs as it is, a graph break.
        # Decided here, not by a decorator, which would import
        # torch._dynamo (seconds) with this module.
        launch = torch.compiler.disable(_launch)
    return launch(config, params, world, cmd, dt, noise, substeps, odom)


step.launches = 0
