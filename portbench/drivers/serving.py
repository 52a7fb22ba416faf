"""One robot served on a large map: ``pipeline.serving.ServingEngine.tick``
in a closed loop, each tick's pose read back to the host before the next
tick's measurements are handed over (a controller reads the pose every
tick).

The traffic file gives the map (a landmark grid), the robot's loop, the
measurements a tick (first sightings in the grid's sweep order and
re-sightings of recent landmarks, known ids) and the warm-up ticks; all
ticks' measurements are made in set-up (``traffic.serving_schedule``,
``traffic.measure``), with the noise the filter's R states where the
configuration asks for it. A session is the robot on a fresh map; the
mix's ``session_ticks`` is its length (the most the map's first sightings
allow, so one session a run). Each tick is timed on the host clock from the
hand-over until its pose is on the host.

The check replays every tick, warm-up included, through the float64
reference (``reference/serving.judge``) once the window has closed and the
program's map is freed: the pose of every tick, the final landmark means,
the robot block and strip, the own blocks, and whole covariance rows of
landmarks drawn from the seed.
"""

from __future__ import annotations

import math
import time

import torch

from .. import checks, stats, traffic
from ..trace import no_span
from ..reference import serving


class Cell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
        from shermbot_navigation_tpu_torch.pipeline.serving import \
            ServingEngine
        self._engine = ServingEngine
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        N, M = cfg["landmarks"], cfg["meas_per_tick"]
        if M != mix["first_sightings"] + mix["resightings"]:
            raise ValueError("the mix's measurements are not the "
                             "configuration's M")
        f = cfg["filter"]
        self.config = EKFConfig(num_landmarks=N, match_gate=f["match_gate"],
                                new_gate=f["new_gate"],
                                wrap_innovation=cfg["wrap_innovation"])
        if self.config.init_cov != f["init_cov"]:
            raise ValueError("the port's filter is not the configuration's")
        self.N, self.M = N, M
        self.S = mix["session_ticks"]
        self.w = 2.0 * math.pi / mix["loop_ticks"]
        self.v = mix["speed_mps"]
        self.sigma = [math.sqrt(r) if cfg["measurement_noise"] else 0.0
                      for r in f["r_diag"]]
        self.landmarks = traffic.landmark_grid(N, mix["spacing_m"],
                                               device=device)
        self.twist = torch.tensor([self.w, self.v, 0.0], device=device)
        self.Q = torch.diag(torch.tensor(f["q_diag"]))
        self.R = torch.diag(torch.tensor(f["r_diag"]))
        self.sessions, self.engine = [], None
        self.tick_s = []
        self.t = 0                    # ticks served, all sessions
        for _ in range(mix["warmup_ticks"]):
            self._tick(no_span)
        self.tick_s = []
        self.failed = self.attempted = 0

    def _session(self):
        """A new session: the robot starts again on a fresh map (every
        landmark at its prior), with its own measurements."""
        k = len(self.sessions)
        ids = traffic.serving_schedule(self.mix, self.seed, k, self.S,
                                       self.N)
        zs = traffic.measure(self.landmarks, self.w, self.v,
                             ids.to(self.device), self.sigma, self.seed, k)
        self.engine = None
        self.engine = self._engine(self.config, self.M, self.Q, self.R,
                                   known=True, device=self.device)
        self.sessions.append({"ids": ids, "zs": zs, "poses": [],
                              "ids_dev": ids.to(self.device, torch.int32)})

    def _tick(self, span):
        if self.t % self.S == 0:
            with span("session"):
                self._session()
        s = self.sessions[-1]
        t = len(s["poses"])
        a = time.perf_counter()
        with span("entry"):
            self.engine.tick(self.twist, s["zs"][t], ids=s["ids_dev"][t])
        with span("readback"):
            pose = self.engine.state.mean_r[0].tolist()
        self.tick_s.append(time.perf_counter() - a)
        s["poses"].append(pose)
        self.t += 1

    def window(self, seconds: float, span):
        t0 = time.perf_counter()
        first = self.t
        while self.t == first or time.perf_counter() - t0 < seconds:
            self._tick(span)
        self.window_s = time.perf_counter() - t0
        self.attempted = self.t - first
        poses = [p for s in self.sessions for p in s["poses"]][first:]
        self.failed = sum(not all(math.isfinite(x) for x in p)
                          for p in poses)

    def end_to_end(self) -> dict:
        return {"tick_ms": 1e3 / stats.rate(self.attempted, self.window_s),
                "tick_ms_p95": 1e3 * stats.percentile(self.tick_s, 95)}

    def check(self, control_mm=None) -> list:
        """Take what the reference compares off the program's map, free the
        map, and replay every session in float64 on the card: each tick's
        pose, and the last session's final state. ``control_mm`` puts the
        reference in the program's place, computing with that matrix
        product in float32 (the control)."""
        st = self.engine.state
        seen = st.seen[0].cpu()
        g = traffic.generator(self.seed, "rows")
        s_ids = seen.nonzero()[:, 0]
        u_ids = (~seen).nonzero()[:, 0]
        pick = lambda ids, k: ids[torch.randperm(ids.numel(), generator=g)
                                  [:k]]
        row_ids = torch.cat([pick(s_ids, self.mix["checked_rows_seen"]),
                             pick(u_ids, self.mix["checked_rows_unseen"])])
        sessions = [{"zs": s["zs"][:len(s["poses"])].cpu(),
                     "ids": s["ids"][:len(s["poses"])],
                     "poses": torch.tensor(s["poses"])}
                    for s in self.sessions]
        run = {"twist": self.twist.cpu(), "sessions": sessions,
               "mean_m": st.mean_m[0].cpu(), "seen": seen,
               "n_seen": int(st.n_seen[0]), "cov_rr": st.cov_rr[0].cpu(),
               "cov_rm": st.cov_rm[0].cpu(), "diag4": st.diag4[0].cpu(),
               "rows": st.cov_mm[0][:, :, row_ids.to(self.device)]
               .permute(2, 0, 1, 3).cpu(), "row_ids": row_ids}
        del st
        self.engine = self.sessions = None
        torch.cuda.empty_cache()
        a = time.perf_counter()
        if control_mm is not None:
            run = serving.control(self.cfg, run, control_mm, self.device)
        self.readings = serving.judge(self.cfg, run, torch.float64,
                                      self.device)
        self.check_s = time.perf_counter() - a
        self.replayed = sum(len(s["ids"]) for s in run["sessions"])
        return checks.held(self.readings, self.cfg["limits"])

    def notes(self) -> list:
        return [f"{self.attempted} ticks in {self.window_s:.3f} s after "
                f"{self.mix['warmup_ticks']} warm-up ticks, sessions of "
                f"{self.S} ticks; the reference replayed {self.replayed} "
                f"ticks in {self.check_s:.2f} s"]
