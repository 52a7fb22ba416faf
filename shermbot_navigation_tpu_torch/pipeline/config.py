"""Typed configuration system (port of
``shermbot_navigation_tpu.pipeline.config``; the package's own copy, since
the JAX module builds jnp arrays).

Validated dataclasses sharing one schema across sim / perception / filter,
YAML-loadable, plus the scenario registry of the BASELINE.json measurement
configs. Every registered scenario equals the JAX package's field by field
(pinned by the tests). As there: unknown keys raise, and Q/R are matrices
built from validated diagonals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..device import resolve
from ..models.ekf_slam import EKFConfig
from ..sim.tube_world import WorldConfig, WorldParams, default_params

# The reference's canonical constants.
WHEEL_BASE = 0.16          # diff_params.yaml:3
WHEEL_RADIUS = 0.033       # diff_params.yaml:2
TUBE_RADIUS = 0.0381       # tube_world_params.yaml:2
ROBOT_RADIUS = 0.08        # tube_world_params.yaml:3
SIM_HZ = 50                # tube_world.cpp:67
SLAM_HZ = 10               # slam.cpp:67, landmarks.cpp:40
ODOM_HZ = 100              # odometer.cpp:43
Q_DIAG = (0.1, 0.1, 0.1)   # slam_params.yaml:3
R_DIAG = (0.001, 0.001)    # slam_params.yaml:2
SCAN_MIN = 0.05            # scan_params.yaml:1
SCAN_MAX = 1.0             # scan_params.yaml:2
STOCK_TUBES = ((0.5, 0.5), (-0.5, -0.5), (1.0, 1.0),
               (-1.0, -1.0), (-0.75, 0.75), (0.75, -0.75))


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """One fully-specified experiment (the equivalent of a launch file +
    its yaml set). Static and hashable."""

    name: str
    tubes: Tuple[Tuple[float, float], ...] = STOCK_TUBES
    num_landmarks: int = 6              # EKF capacity (ref slam.cpp:71)
    use_lidar: bool = False             # True: scan->cluster->fit->EKF (config 3)
    lidar_quirks: bool = False          # reproduce the reference lidar bugs
    known_association: bool = False     # True: /fake_sensor marker ids (config 1)
    steps: int = 500                    # SLAM ticks to simulate
    sim_substeps: int = SIM_HZ // SLAM_HZ
    dt: float = 1.0 / SIM_HZ
    max_range: float = 1.0              # fake-sensor gate
    tube_var: float = 0.001
    twist_noise: float = 0.0
    slip_min: float = 0.9
    slip_max: float = 1.0
    scan_noise: float = 0.0
    sensor_dropout: float = 0.0      # fault injection
    scan_dropout: float = 0.0
    q_diag: Tuple[float, float, float] = Q_DIAG
    r_diag: Tuple[float, float] = R_DIAG
    max_clusters: int = 16
    max_cluster_points: int = 64
    seed: int = 0
    # command generator: ("circle", w, v)
    command: Tuple = ("circle", 0.5, 0.1)
    # EKF quality knobs (reference-faithful defaults; see EKFConfig)
    match_gate: float = 0.01
    new_gate: float = 60.0
    wrap_innovation: bool = False
    assoc_mode: str = "first_hit"
    slip_mode: str = "reference"

    def world_config(self) -> WorldConfig:
        # only produce the observation channels this scenario consumes
        return WorldConfig(compute_scan=self.use_lidar,
                           compute_fake_sensor=not self.use_lidar,
                           reference_lidar_quirks=self.lidar_quirks,
                           slip_mode=self.slip_mode)

    def ekf_config(self) -> EKFConfig:
        return EKFConfig(num_landmarks=self.num_landmarks,
                         match_gate=self.match_gate,
                         new_gate=self.new_gate,
                         wrap_innovation=self.wrap_innovation,
                         assoc_mode=self.assoc_mode)

    def world_params(self, dtype=torch.float32, device=None) -> WorldParams:
        """The scenario's world on ``device`` (``None`` is the card)."""
        return default_params(
            tube_locs=list(self.tubes), dtype=dtype, device=device,
            max_range=self.max_range, tube_var=self.tube_var,
            twist_noise=self.twist_noise,
            slip_min=self.slip_min, slip_max=self.slip_max,
            scan_noise=self.scan_noise,
            sensor_dropout=self.sensor_dropout,
            scan_dropout=self.scan_dropout,
            scan_min=SCAN_MIN, scan_max=SCAN_MAX,
            wheel_base=WHEEL_BASE, wheel_rad=WHEEL_RADIUS,
            tube_rad=TUBE_RADIUS, robot_rad=ROBOT_RADIUS,
        )

    def noise_matrices(self, dtype=torch.float32, device=None):
        """``(Q, R)`` on ``device`` (``None`` is the card)."""
        device = resolve(device)
        mk = lambda d: torch.diag(torch.tensor(d, dtype=torch.float64)).to(
            device=device, dtype=dtype)
        return mk(self.q_diag), mk(self.r_diag)


def _ring(n, radius):
    """n tubes evenly spaced on a circle."""
    return tuple(
        (radius * math.cos(2 * math.pi * k / n),
         radius * math.sin(2 * math.pi * k / n))
        for k in range(n)
    )


def _grid(n, spacing=0.9):
    """~n tubes on a square grid centered at the origin."""
    side = math.ceil(math.sqrt(n))
    out = []
    for i in range(side):
        for j in range(side):
            if len(out) >= n:
                break
            out.append(((i - (side - 1) / 2) * spacing,
                        (j - (side - 1) / 2) * spacing))
    return tuple(out)


# ---------------------------------------------------------------------------
# Scenario registry: the BASELINE.json measurement configs
# ---------------------------------------------------------------------------

SCENARIOS = {}


def register(s: ScenarioConfig) -> ScenarioConfig:
    SCENARIOS[s.name] = s
    return s


# config 1: 5-landmark loop, known association, noiseless odometry
register(ScenarioConfig(
    name="loop5_known",
    tubes=_ring(5, 0.8),
    num_landmarks=5,
    known_association=True,
    slip_min=1.0, slip_max=1.0, twist_noise=0.0, tube_var=0.0,
    max_range=2.0,
    steps=600,
    # drive radius v/w = 0.5 m: well clear of the 0.8 m tube ring
    command=("circle", 2 * 3.14159265 / 60.0, 0.052),
))

# config 2: 12-landmark course, sensor/wheel noise, unknown association
register(ScenarioConfig(
    name="course12_noisy",
    tubes=_ring(12, 0.9),
    num_landmarks=12,
    known_association=False,
    slip_min=0.9, slip_max=1.0, twist_noise=0.001, tube_var=0.001,
    max_range=1.0,
    steps=600,
    command=("circle", 2 * 3.14159265 / 60.0, 0.08),
))

# config 3: full lidar -> clustering -> circle fit -> EKF, 20 landmarks
register(ScenarioConfig(
    name="lidar20_full",
    tubes=_ring(10, 0.7) + _ring(10, 1.3),
    num_landmarks=20,
    use_lidar=True,
    known_association=False,
    slip_min=0.95, slip_max=1.0, twist_noise=0.0, tube_var=0.001,
    max_range=1.0,
    steps=600,
    command=("circle", 2 * 3.14159265 / 60.0, 0.08),
))

# quality mode: config 3 with statistically-sound association -- nearest
# neighbor, chi-square gates, wrapped innovations
register(ScenarioConfig(
    name="lidar20_tuned",
    tubes=_ring(10, 0.7) + _ring(10, 1.3),
    num_landmarks=24,
    use_lidar=True,
    known_association=False,
    slip_min=0.95, slip_max=1.0, twist_noise=0.0, tube_var=0.001,
    max_range=1.0,
    steps=600,
    command=("circle", 2 * 3.14159265 / 60.0, 0.08),
    match_gate=0.2, new_gate=60.0, wrap_innovation=True,
    assoc_mode="nearest",
    slip_mode="multiplicative",   # physical slip: odometry really drifts
))

# quality mode for config 2: the 12-landmark course under physical
# multiplicative slip with statistically-sound association
register(ScenarioConfig(
    name="course12_tuned",
    tubes=_ring(12, 0.9),
    num_landmarks=16,            # headroom for noise-spawned duplicates
    known_association=False,
    slip_min=0.9, slip_max=1.0, twist_noise=0.001, tube_var=0.001,
    max_range=1.0,
    steps=600,
    command=("circle", 2 * 3.14159265 / 60.0, 0.08),
    match_gate=0.2, new_gate=60.0, wrap_innovation=True,
    assoc_mode="nearest",
    slip_mode="multiplicative",
))

# the reference's stock 6-tube world (tube_world_params.yaml)
register(ScenarioConfig(
    name="stock6",
    tubes=STOCK_TUBES,
    num_landmarks=6,
    known_association=False,
    steps=500,
))

# config 4: 2,000-landmark synthetic map, blocked covariance
register(ScenarioConfig(
    name="bigmap2000",
    tubes=_grid(64, 0.9),      # sim world stays small; map capacity is big
    num_landmarks=2000,
    known_association=True,
    steps=100,
    max_range=2.0,
))

# config 5: 50,000-landmark map, Schur refinement + pose graph
register(ScenarioConfig(
    name="megamap50000",
    tubes=_grid(64, 0.9),
    num_landmarks=50000,
    known_association=True,
    steps=20,
    max_range=2.0,
))


def get_scenario(name: str) -> ScenarioConfig:
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name]


# ---------------------------------------------------------------------------
# YAML loading (strict)
# ---------------------------------------------------------------------------

def from_yaml(path: str) -> ScenarioConfig:
    """Load a ScenarioConfig from a YAML mapping. Unknown keys raise."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(ScenarioConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise ValueError(f"unknown config keys {sorted(unknown)} in {path}")
    if "tubes" in raw:
        raw["tubes"] = tuple(tuple(t) for t in raw["tubes"])
    if "command" in raw:
        raw["command"] = tuple(raw["command"])
    return ScenarioConfig(**raw)
