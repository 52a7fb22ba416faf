"""The reference's staged topic pipeline on one card (port of
``shermbot_navigation_tpu.pipeline.staged``).

The reference runs its pipeline as THREE OS processes wired by topics --
tube_world -> landmarks -> slam (``unknown_data_assoc.launch:4-21``,
``landmarks.cpp:60-118`` as the middle stage) -- so the simulation and
perception of tick t overlap the filter of tick t-1, at the cost of one
tick of topic latency. Two stages:

- stage 0, the producer: tube-world substeps + perception (the tube_world
  and landmarks nodes);
- stage 1, the consumer: odometry + the dense EKF (the slam node, which
  does its own odometry, ref slam.cpp:264-265), on the packet the
  producer emitted on the PREVIOUS tick: the reference's one-tick topic
  latency, reproduced rather than hidden.

The JAX package puts the stages on the two devices of a ``'pp'`` mesh
(``shard_map``, one ``lax.cond`` a stage, one ``ppermute`` of the packet
a tick). Here they are two CUDA streams of one card: the producer on
stream 0, the consumer on stream 1, the packet double-buffered between
them with CUDA events -- the consumer of tick t waits on the producer's
event of tick t-1, and the producer does not overwrite a buffer until the
consumer's event for it has fired. The host loop never waits for the
card. On the CPU (``device="cpu"``) the same loop runs the stages in
order.

Noise is an explicit input: ``produce`` takes one tick's draws (``S``
simulator substeps and the observation, a ``tube_world.TickNoise``); the
rollouts take a ``torch.Generator`` on the run's device or a precomputed
``TickNoise`` sequence with a leading T.

Whether staging beats the single-stream tick is measured
(``chip_smoke.py`` phase 21): one host thread launches both stages.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..device import resolve
from ..models import ekf_slam as ekf
from ..ops import diff_drive as dd
from ..ops.kernels import sim_tick
from ..ops.landmark_detection import detect_landmarks
from ..sim import tube_world as tw
from .config import ScenarioConfig
from .driver import (NoiseSource, TickOutput, alloc_outputs, command_twist,
                     init_pipeline)
from .metrics import nees as nees_fn


class Packet(NamedTuple):
    """The producer -> consumer handoff: the tensors in place of the
    reference's ``/joint_states`` + ``/real_sensor`` (or
    ``/fake_sensor``) topics."""

    joint_states: torch.Tensor   # (2,) wheel angles
    positions: torch.Tensor      # (C, 2) robot-frame landmark detections
    valid: torch.Tensor          # (C,) detection mask
    true_pose: torch.Tensor      # (3,) ground truth AT PRODUCTION TIME


def _empty_packet(scn: ScenarioConfig, dtype, device) -> Packet:
    C = scn.max_clusters if scn.use_lidar else len(scn.tubes)
    return Packet(joint_states=torch.zeros(2, dtype=dtype, device=device),
                  positions=torch.zeros((C, 2), dtype=dtype, device=device),
                  valid=torch.zeros(C, dtype=torch.bool, device=device),
                  true_pose=torch.zeros(3, dtype=dtype, device=device))


def _make_stages(scn: ScenarioConfig, params, Q, R):
    """The two stage bodies, shared by the staged rollout and its
    sequential oracle so that the tests compare the same arithmetic."""
    wcfg = scn.world_config()
    ecfg = scn.ekf_config()
    dparams = dd.DiffDriveParams(params.wheel_base, params.wheel_rad)

    def produce(world, noise: tw.TickNoise, cmd):
        """Sim substeps + perception -> (new world, packet)."""
        # the consumer does the odometry, one tick later
        world, obs, _, _ = sim_tick.step(wcfg, params, world, cmd, scn.dt,
                                         noise, scn.sim_substeps)
        if scn.use_lidar:
            det = detect_landmarks(
                obs.scan, params.scan_min, params.scan_max,
                max_clusters=scn.max_clusters,
                max_points=scn.max_cluster_points)
            positions, valid = det.positions, det.valid
        else:
            positions, valid = obs.fake_sensor, obs.fake_sensor_valid
        return world, Packet(joint_states=obs.joint_states,
                             positions=positions, valid=valid,
                             true_pose=obs.true_pose)

    def consume(odom, filt, pkt: Packet):
        """Odometry + EKF on a (one-tick-old) packet -> (odom, filt,
        out)."""
        # the packet is a buffer the producer fills again: the odometry
        # keeps a copy of the wheel angles, not the buffer
        wheels = pkt.joint_states.clone()
        twist = dd.wheels_to_twist(dparams, wheels - odom.wheels)
        odom = dd.step(dparams, odom, wheels)
        zs = ekf.cartesian2polar(pkt.positions[..., 0],
                                 pkt.positions[..., 1])
        if scn.known_association:
            ids = torch.arange(pkt.positions.shape[0], dtype=torch.int32,
                               device=zs.device)
            filt = ekf.known_association_step(
                ecfg, filt, twist, zs, pkt.valid, ids, Q, R)
        else:
            filt = ekf.step(ecfg, filt, twist, zs, pkt.valid, Q, R)
        slam_pose = filt.mean[:3]
        out = TickOutput(
            true_pose=pkt.true_pose,        # pose at packet production time
            odom_pose=odom.pose,
            slam_pose=slam_pose,
            n_seen=filt.n_seen,
            nees=nees_fn(slam_pose, pkt.true_pose, filt.cov[:3, :3]),
        )
        return odom, filt, out

    return produce, consume


class _Setup(NamedTuple):
    produce: object
    consume: object
    state: object
    cmds: torch.Tensor
    src: NoiseSource
    outs: TickOutput
    empty: Packet


def _setup(scn, noise, T, dtype, device) -> _Setup:
    params = scn.world_params(dtype, device)
    Q, R = scn.noise_matrices(dtype, device)
    produce, consume = _make_stages(scn, params, Q, R)
    return _Setup(produce, consume, init_pipeline(scn, dtype, device),
                  command_twist(scn, T, dtype, device),
                  NoiseSource(scn, noise, (), dtype, device),
                  alloc_outputs((), T, dtype, device),
                  _empty_packet(scn, dtype, device))


def make_staged_rollout(scn: ScenarioConfig, stages: int = 2,
                        dtype=torch.float32, device=None):
    """The two-stream staged rollout: ``run(noise, T) -> TickOutput (T,
    ...)``; ``stages`` must be 2 (the JAX ``pp`` axis). ``device=None`` is
    the card, where the producer and the consumer run on two CUDA streams
    (one launch of each kernel a stage, no host wait); on the CPU the
    stages run in order."""
    if stages != 2:
        raise ValueError("PP staging is a 2-stage split: need stages=2")
    device = resolve(device)
    on_card = device.type == "cuda"

    def run(noise, T: int) -> TickOutput:
        s = _setup(scn, noise, T, dtype, device)
        if on_card:
            cur = torch.cuda.current_stream(device)
            streams = [torch.cuda.Stream(device), torch.cuda.Stream(device)]
            for st in streams:
                st.wait_stream(cur)
            produced = [torch.cuda.Event(), torch.cuda.Event()]
            consumed = [torch.cuda.Event(), torch.cuda.Event()]
            on = [torch.cuda.stream(st) for st in streams]
        else:
            on = [contextlib.nullcontext(), contextlib.nullcontext()]
        bufs = [_empty_packet(scn, dtype, device) for _ in range(2)]
        world, odom, filt = s.state
        for t in range(T):
            slot = t % 2
            with on[0]:
                if on_card and t >= 2:     # the consumer of t-1 read it
                    streams[0].wait_event(consumed[slot])
                world, pkt = s.produce(world, s.src.tick(t), s.cmds[t])
                for dst, x in zip(bufs[slot], pkt):
                    dst.copy_(x)
                if on_card:
                    produced[slot].record(streams[0])
            with on[1]:
                pkt = s.empty if t == 0 else bufs[1 - slot]
                if on_card and t >= 1:
                    streams[1].wait_event(produced[1 - slot])
                odom, filt, out = s.consume(odom, filt, pkt)
                for dst, val in zip(s.outs, out):
                    dst[t] = val
                if on_card and t >= 1:
                    consumed[1 - slot].record(streams[1])
        if on_card:
            for st in streams:
                cur.wait_stream(st)
            # written or read on both streams: free only after both
            for x in (*bufs[0], *bufs[1], *s.outs):
                for st in streams:
                    x.record_stream(st)
        return s.outs

    return run


def make_staged_reference(scn: ScenarioConfig, dtype=torch.float32,
                          device=None):
    """The sequential oracle with the SAME one-tick-latency semantics (the
    same stage bodies, the same packet delay, one stream, no events):
    ``run(noise, T) -> TickOutput``. ``device=None`` is the card."""
    device = resolve(device)

    def run(noise, T: int) -> TickOutput:
        s = _setup(scn, noise, T, dtype, device)
        world, odom, filt = s.state
        pkt = s.empty
        for t in range(T):
            world, new_pkt = s.produce(world, s.src.tick(t), s.cmds[t])
            odom, filt, out = s.consume(odom, filt, pkt)
            for dst, val in zip(s.outs, out):
                dst[t] = val
            pkt = new_pkt
        return s.outs

    return run


def staged_reference(scn: ScenarioConfig, noise, T: int,
                     dtype=torch.float32, device=None) -> TickOutput:
    """One-shot wrapper over :func:`make_staged_reference`."""
    return make_staged_reference(scn, dtype, device)(noise, T)
