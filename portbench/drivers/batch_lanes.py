"""Batch evaluation: B worlds in lockstep through the port's lanes engine
(``pipeline.driver.run_scenario_batch_lanes``), episode after episode.

The traffic file gives the batch, the episode's ticks, the warm-up ticks
and how many worlds of each episode are checked. Each episode's standard
draws are made on the card from the seed (``traffic.episode_noise``) and
handed to the entry as a ``TickNoise`` sequence; the episode's outputs of
the checked worlds are kept. The window runs whole episodes until
``--seconds`` have passed, and the card is synchronized before the clock
stops.

The check (``reference/lidar20.judge``) follows the program stage by stage
on the checked worlds: the world and odometry from the same draws, the
scan at the program's own pose, the detections of the program's own scan,
the filter on the program's own detections. The entry's ``on_tick`` hook
hands over each tick's scan and detections; the harness copies the
checked worlds' rows (three copies a tick).
"""

from __future__ import annotations

import time

import torch

from .. import checks, quality, stats, traffic
from ..trace import no_span
from ..reference import lidar20


def scenario(cfg: dict):
    """The port's scenario, built from the configuration file's numbers."""
    from shermbot_navigation_tpu_torch.pipeline.config import ScenarioConfig
    s = dict(cfg["scenario"])
    s["tubes"] = tuple(tuple(t) for t in s["tubes"])
    s["command"] = tuple(s["command"])
    for k in ("q_diag", "r_diag"):
        s[k] = tuple(s[k])
    return ScenarioConfig(**s)


def reference_cfg(cfg: dict) -> dict:
    """The reference's view of the same numbers."""
    s, c = cfg["scenario"], cfg["constants"]
    world = dict(tubes=s["tubes"], twist_noise=s["twist_noise"],
                 slip_min=s["slip_min"], slip_max=s["slip_max"],
                 scan_noise=s["scan_noise"],
                 scan_dropout=s["scan_dropout"],
                 sim_substeps=s["sim_substeps"], dt=s["dt"],
                 command=s["command"][1:], **{
                     k: c[k] for k in ("tube_rad", "robot_rad", "wheel_base",
                                       "wheel_rad", "scan_min", "scan_max",
                                       "num_rays")})
    perception = dict(max_clusters=s["max_clusters"],
                      max_cluster_points=s["max_cluster_points"],
                      **{k: c[k] for k in ("split_threshold",
                                           "std_threshold_deg", "max_radius",
                                           "scan_min", "scan_max")})
    filt = dict(num_landmarks=s["num_landmarks"], q_diag=s["q_diag"],
                r_diag=s["r_diag"], match_gate=s["match_gate"],
                new_gate=s["new_gate"], init_cov=c["init_cov"])
    return {"world": world, "perception": perception, "filter": filt}


def _check_as_stated(scn, cfg, device):
    """The program runs the configuration as the file states it."""
    c = cfg["constants"]
    p = scn.world_params(torch.float64, "cpu")
    for k in ("tube_rad", "robot_rad", "wheel_base", "wheel_rad",
              "scan_min", "scan_max"):
        if abs(float(getattr(p, k)) - c[k]) > 1e-12:
            raise ValueError(f"the port's {k} {float(getattr(p, k))} is not "
                             f"the configuration's {c[k]}")
    e = scn.ekf_config()
    if (e.init_cov != c["init_cov"] or e.assoc_mode != "first_hit"
            or scn.world_config().num_rays != c["num_rays"]):
        raise ValueError("the port's filter or lidar is not the "
                         "configuration's")


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from shermbot_navigation_tpu_torch.pipeline import driver
        from shermbot_navigation_tpu_torch.sim import tube_world as tw
        self._run = driver.run_scenario_batch_lanes
        self._tick_noise = tw.TickNoise
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.scn = scenario(cfg)
        _check_as_stated(self.scn, cfg, device)
        self.B = mix["batch"]
        self.steps = mix["episode_ticks"]
        if self.steps > cfg["scenario"]["steps"]:
            raise ValueError("an episode longer than the configuration's")
        self.W = min(mix["checked_worlds"], self.B)
        self.rays = cfg["constants"]["num_rays"]
        # the warm-up: an episode of this cell's batch, its own draws, every
        # call of the window's episodes
        self._episode(-1, mix["warmup_ticks"])
        self.episodes = []
        self.failed = self.attempted = 0

    def _noise(self, episode: int, steps: int):
        s = self.scn
        return traffic.episode_noise(self.seed, episode, self.B, steps,
                                     s.sim_substeps, self.rays,
                                     len(s.tubes), self.device)

    def _episode(self, e: int, steps: int, span=no_span):
        with span("handoff"):
            noise = self._tick_noise(*self._noise(e, steps))
            idx = traffic.sample_worlds(self.seed, e, self.B, self.W).to(
                self.device)
        W, C = self.W, self.scn.max_clusters
        kw = dict(device=self.device)
        cap = {"scan": torch.empty((steps, W, self.rays), **kw),
               "zs": torch.empty((steps, W, C, 2), **kw),
               "valid": torch.empty((steps, W, C), dtype=torch.bool, **kw)}

        def hook(t, obs, zs, valid):
            torch.index_select(obs.scan, 0, idx, out=cap["scan"][t])
            torch.index_select(zs, 0, idx, out=cap["zs"][t])
            torch.index_select(valid, 0, idx, out=cap["valid"][t])

        with span("entry"):
            outs = self._run(self.scn, noise, self.B, steps=steps,
                             device=self.device, on_tick=hook)
        with span("readback"):
            bad = (~torch.isfinite(outs.slam_pose).all(-1).all(-1)).sum()
            kept = {k: getattr(outs, k).index_select(0, idx)
                    for k in ("true_pose", "odom_pose", "slam_pose",
                              "n_seen")}
            kept.update({k: v.transpose(0, 1) for k, v in cap.items()})
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return kept, bad

    def window(self, seconds: float, span):
        t0 = time.perf_counter()
        e = 0
        bads, ends = [], []
        while e == 0 or time.perf_counter() - t0 < seconds:
            kept, bad = self._episode(e, self.steps, span)
            ends.append(time.perf_counter() - t0)
            self.episodes.append(kept)
            bads.append(bad)
            e += 1
        self.window_s = time.perf_counter() - t0
        self.episode_s = [b - a for a, b in zip([0.0] + ends, ends)]
        self.failed = int(torch.stack(bads).sum())
        self.attempted = self.B * e
        self.ticks = self.steps * e

    def end_to_end(self) -> dict:
        return {"world_ticks_per_s": stats.rate(self.B * self.ticks,
                                                self.window_s)}

    def check(self, control_mm=None) -> list:
        """The checked worlds of every episode, judged in one batch by the
        float64 reference on the card. ``control_mm`` puts the reference
        in the program's place, computing with that matrix product in
        float32 (the control: ``reference.arith.tf32_matmul``)."""
        E = len(self.episodes)
        outs = {k: torch.cat([ep[k] for ep in self.episodes])
                for k in self.episodes[0]}
        noise = {k: [] for k in ("twist", "slip", "scan", "scan_keep")}
        for e in range(E):
            idx = traffic.sample_worlds(self.seed, e, self.B, self.W).to(
                self.device)
            tw_, sl, sc, _, sk = self._noise(e, self.steps)
            for k, v in zip(noise, (tw_, sl, sc, sk)):
                noise[k].append(v.index_select(1, idx).transpose(0, 1))
            del tw_, sl, sc, sk
        noise = {k: torch.cat(v) for k, v in noise.items()}
        self.episodes = None
        if control_mm is not None:
            outs = lidar20.control(reference_cfg(self.cfg), noise, self.steps,
                                   control_mm)
        t0 = time.perf_counter()
        self.readings = lidar20.judge(reference_cfg(self.cfg), noise, outs)
        self.compared = self.readings.pop("filter_compared_share")
        self.check_s = time.perf_counter() - t0
        self.live_share = self.readings.pop("live_cluster_share")
        ate = quality.world_ate(outs["slam_pose"], outs["true_pose"])
        self.median_ate = float(ate.median())
        return checks.held(self.readings, self.cfg["limits"])

    def notes(self) -> list:
        return [f"{self.attempted // self.B} episodes of {self.steps} ticks "
                f"x {self.B} worlds in {self.window_s:.3f} s; "
                f"{self.W} worlds an episode checked "
                f"in {self.check_s:.2f} s ({self.compared:.3f} of the "
                f"world-ticks before a gate tie); median-world ATE of the "
                f"checked {self.median_ate:.5f} m",
                "episode seconds " + " ".join(f"{x:.4f}"
                                              for x in self.episode_s)]

