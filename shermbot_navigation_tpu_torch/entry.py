"""Compile check of the port's flagship step (the counterpart of the
repository's ``__graft_entry__.entry``): one full SLAM tick -- 5 sim
substeps, the fake sensor, odometry, the EKF predict and its sequential
updates -- on the stock 6-tube world, f32, on one world of the dense
engine, with a fixed command and fixed noise.

    python -m shermbot_navigation_tpu_torch.entry [--device cpu]
        [--backend inductor]

compiles it with ``torch.compile``, runs it, checks it against the eager
tick and prints one line.
"""

from __future__ import annotations

import argparse
import sys

import torch


def entry(device=None):
    """``(fn, args)``: ``fn(state, cmd, noise) -> (state, TickOutput)``,
    one ``driver.slam_tick`` on ``stock6`` in f32, and its arguments (the
    initial state, the command ``[0.1, 0.05, 0]`` and one tick's draws
    from a generator seeded 0). ``device=None`` is the card."""
    from .device import resolve
    from .pipeline import driver
    from .pipeline.config import get_scenario

    device = resolve(device)
    scn = get_scenario("stock6")
    dtype = torch.float32
    params = scn.world_params(dtype, device)
    Q, R = scn.noise_matrices(dtype, device)
    state = driver.init_pipeline(scn, dtype, device)
    cmd = torch.tensor([0.1, 0.05, 0.0], dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    noise = driver.draw_noise(scn, gen, dtype=dtype)

    def fn(state, cmd, noise):
        return driver.slam_tick(scn, params, Q, R, state, cmd, noise)

    return fn, (state, cmd, noise)


def max_difference(a, b) -> float:
    """Largest |a - b| over the float leaves of two nests of NamedTuples,
    and inf where an integer or bool leaf differs."""
    if isinstance(a, tuple):
        return max(max_difference(x, y) for x, y in zip(a, b))
    if not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else float("inf")
    return float((a - b).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for a CPU run")
    ap.add_argument("--backend", default="inductor")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = torch.compile(fn, backend=args.backend)(*fargs)
    err = max_difference(out, fn(*fargs))
    print(f"entry() compiled ({args.backend}) and ran on "
          f"{out[1].slam_pose.device}: max |compiled - eager| = {err:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
