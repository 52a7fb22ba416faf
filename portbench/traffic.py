"""The benchmark's traffic generators: each reads a mix's data file
(``portbench/workloads/<traffic>.json``) and the run's ``--seed``, and
makes the inputs both the program and the reference are given.

``landmark_grid`` and ``arc_pose`` are frozen copies of
``shermbot_navigation_tpu_torch/parallel/bigmap.py`` (``make_workload``'s
grid and ``_true_pose``), ``measure`` of its ``measurements``; the
schedule of first sightings and re-sightings is the benchmark's own.
"""

from __future__ import annotations

import hashlib
import math

import torch


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose of one run: every stream of draws gets
    its own, so that none depends on how many draws another made."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *parts, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *parts))
    return g


# ---------------------------------------------------------------------------
# Batch evaluation: the standard draws of an episode of B worlds
# ---------------------------------------------------------------------------

def episode_noise(seed: int, episode: int, batch: int, steps: int,
                  substeps: int, rays: int, tubes: int, device):
    """Episode ``episode``'s standard draws for ``batch`` worlds and
    ``steps`` ticks, made on ``device`` in five calls: twist and slip
    normals ``(T, B, S, 2)``, scan normals ``(T, B, n)``, marker and scan
    keep uniforms ``(T, B, K)``, ``(T, B, n)``. The scenario scales them
    (a zero scale or a zero dropout rate makes a draw inert)."""
    g = generator(seed, "episode", episode, device=device)
    kw = dict(generator=g, device=device, dtype=torch.float32)
    T, B = steps, batch
    return (torch.randn((T, B, substeps, 2), **kw),
            torch.randn((T, B, substeps, 2), **kw),
            torch.randn((T, B, rays), **kw),
            torch.rand((T, B, tubes), **kw),
            torch.rand((T, B, rays), **kw))


def sample_worlds(seed: int, episode: int, batch: int, count: int):
    """The worlds of an episode whose answers are checked, drawn from the
    seed: ``count`` distinct indices, ascending."""
    g = generator(seed, "sample", episode)
    return torch.randperm(batch, generator=g)[:count].sort().values


# ---------------------------------------------------------------------------
# Serving: one robot on a landmark grid, closed loop
# ---------------------------------------------------------------------------

def landmark_grid(N: int, spacing: float, dtype=torch.float32, device="cpu"):
    """N landmarks on a square grid centred at the origin, row by row."""
    side = math.ceil(math.sqrt(N))
    ii = torch.arange(N, device=device, dtype=torch.float64)
    return torch.stack([(torch.remainder(ii, side) - side / 2) * spacing,
                        (torch.div(ii, side, rounding_mode="floor")
                         - side / 2) * spacing], dim=-1).to(dtype)


def arc_pose(w: float, v: float, t):
    """Closed-form pose ``[th, x, y]`` after ``t`` (a tensor) ticks of the
    constant twist ``(w, v)`` from the origin."""
    th = w * t
    r = v / w
    return torch.stack([th, r * torch.sin(th), r * (1.0 - torch.cos(th))],
                       dim=-1)


def serving_schedule(mix: dict, seed: int, session: int, ticks: int,
                     N: int) -> torch.Tensor:
    """The landmark ids of ``ticks`` ticks, ``(T, M)`` int64: tick t first
    sights ``first_sightings`` landmarks of the ``N`` in the grid's sweep
    order and re-sights ``resightings`` landmarks first sighted 1 to
    ``resight_lag_ticks`` ticks before (drawn from the seed; tick 0
    re-sights its own first sightings), the M ids in an order drawn from
    the seed; each session of the run its own draws."""
    new, back, lag = (mix["first_sightings"], mix["resightings"],
                      mix["resight_lag_ticks"])
    if ticks * new > N or back > new:
        raise ValueError(f"{ticks} ticks of {new} first sightings and "
                         f"{back} re-sightings do not fit {N} landmarks")
    g = generator(seed, "schedule", session)
    t = torch.arange(ticks)[:, None]
    first = t * new + torch.arange(new)[None]                    # (T, new)
    pick = torch.rand((ticks, lag * new), generator=g).argsort(-1)[:, :back]
    # candidate c is slot c % new of tick t - 1 - c // new; early ticks
    # fold the draw onto the ticks that exist
    pick = torch.remainder(pick, torch.clamp_min(t * new, 1))
    resight = (t - 1 - pick // new) * new + pick % new
    resight = torch.where(t == 0, first[:, :back], resight)
    ids = torch.cat([first, resight], -1)
    order = torch.rand(ids.shape, generator=g).argsort(-1)
    return ids.gather(-1, order)


def measure(landmarks, w: float, v: float, ids, sigma, seed: int,
            session: int):
    """The range-bearing measurements ``(T, M, 2)`` of landmarks ``ids (T,
    M)``, tick t's from the pose after t + 1 ticks (the filter predicts
    before it updates), with Gaussian noise of standard deviations ``sigma``
    (range, bearing) drawn from the seed."""
    tt = torch.arange(1, ids.shape[0] + 1, dtype=landmarks.dtype,
                      device=landmarks.device)
    pose = arc_pose(w, v, tt)[:, None, :]                        # (T, 1, 3)
    lm = landmarks[ids]                                          # (T, M, 2)
    dx = lm[..., 0] - pose[..., 1]
    dy = lm[..., 1] - pose[..., 2]
    g = generator(seed, "measurement noise", session)
    e = torch.randn((*ids.shape, 2), generator=g, dtype=torch.float64)
    e = (e * torch.tensor(sigma, dtype=torch.float64)).to(
        dtype=landmarks.dtype, device=landmarks.device)
    bearing = torch.atan2(dy, dx) - pose[..., 0] + e[..., 1]
    return torch.stack([torch.sqrt(dx * dx + dy * dy) + e[..., 0],
                        torch.atan2(torch.sin(bearing), torch.cos(bearing))],
                       dim=-1)
