"""Rectangle-trajectory bang-bang controller as a pure state machine (port
of ``shermbot_navigation_tpu.sim.turtle_rect``).

The reference ``turtle_rect`` node (``trect/src/turtle_rect.cpp``): the
turtlesim FSM {Idle, bottomLine, rightLine, topLine, leftLine, Rotate}
with per-edge overshoot checks and rotate-until-aligned transitions (ref
:120-239), as a branchless ``controller_step(params, state, pose) ->
(state, cmd_twist)`` of ``where`` selects, so a closed-loop rollout never
reads the state back to the host and broadcasts over leading batch dims.

The ``start`` service choreography (teleport + draw, ref :259-340) maps
to :func:`start`: it resets the FSM and returns the rectangle's corner
waypoints (the drawing is the caller's concern).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import se2

# FSM states (ref turtle_rect.cpp:55)
IDLE = 0
BOTTOM = 1
RIGHT = 2
TOP = 3
LEFT = 4
ROTATE = 5


class RectParams(NamedTuple):
    """Rectangle + speed limits (ref params max_xdot/max_wdot,
    turtle_rect.cpp:92-95; rectangle from the start service request), as
    0-dim tensors on the run's device."""

    x: torch.Tensor        # lower-left corner
    y: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    max_xdot: torch.Tensor
    max_wdot: torch.Tensor


class RectState(NamedTuple):
    fsm: torch.Tensor       # () int32, one of the states above
    prev: torch.Tensor      # () int32, state to resume after Rotate


def start(params: RectParams) -> Tuple[RectState, torch.Tensor]:
    """Begin tracing the rectangle (ref start service,
    turtle_rect.cpp:259-340). Returns the initial FSM state and the (4, 2)
    corner waypoints (the reference draws these with the turtlesim pen)."""
    x0, y0 = params.x, params.y
    x1, y1 = params.x + params.width, params.y + params.height
    corners = torch.stack([torch.stack([x0, y0]), torch.stack([x1, y0]),
                           torch.stack([x1, y1]), torch.stack([x0, y1])])
    s = torch.full_like(params.x, BOTTOM, dtype=torch.int32)
    return RectState(fsm=s, prev=s.clone()), corners


def _edge_targets(params: RectParams):
    """Per-edge (goal value, goal axis, heading) tables, indexed by the
    state (1..4; row 0 unused)."""
    x0, y0 = params.x, params.y
    x1, y1 = params.x + params.width, params.y + params.height
    z = torch.zeros_like(x0)
    goal_val = torch.stack([z, x1, y1, x0, y0])
    goal_axis = torch.tensor([0, 0, 1, 0, 1], device=x0.device)
    heading = torch.stack([z, z, torch.full_like(x0, se2.PI / 2),
                           torch.full_like(x0, se2.PI),
                           torch.full_like(x0, -se2.PI / 2)])
    return goal_val, goal_axis, heading


def controller_step(params: RectParams, state: RectState, pose):
    """One control tick: pose ``[th, x, y]`` -> (new state, cmd
    ``[w, v, 0]``).

    Bang-bang logic identical to the reference: drive the current edge at
    ``max_xdot`` until the goal coordinate is overshot (ref e.g. :141),
    then Rotate at ``max_wdot`` until the heading error magnitude < 0.01
    (ref :210), then resume the next edge; after the left edge, Idle.
    """
    pose = torch.as_tensor(pose)
    th, x, y = pose[0], pose[1], pose[2]
    fsm = state.fsm

    goal_val, goal_axis, heading = _edge_targets(params)

    is_edge = (fsm >= BOTTOM) & (fsm <= LEFT)
    edge = fsm.clamp(BOTTOM, LEFT)
    coord = torch.where(goal_axis[edge] == 0, x, y)
    # direction of travel along the coordinate: +1 for bottom/right, -1 else
    sign = torch.where((edge == BOTTOM) | (edge == RIGHT), 1.0, -1.0).to(
        coord.dtype)
    reached = sign * (coord - goal_val[edge]) >= 0.0

    next_edge = torch.where(edge == LEFT, IDLE, edge + 1)

    # edge driving
    fsm_after_edge = torch.where(
        reached, torch.where(next_edge == IDLE, IDLE, ROTATE), edge)
    prev_after_edge = torch.where(reached, next_edge, state.prev)

    # rotating toward the heading of state.prev
    rot_target = heading[state.prev.clamp(BOTTOM, LEFT)]
    rot_err = se2.normalize_angle(rot_target - th)
    rot_done = rot_err.abs() < 0.01          # ref :210
    fsm_after_rot = torch.where(rot_done, state.prev, ROTATE)

    new_fsm = torch.where(fsm == ROTATE, fsm_after_rot,
                          torch.where(is_edge, fsm_after_edge, IDLE))
    new_prev = torch.where(fsm == ROTATE, state.prev,
                           torch.where(is_edge, prev_after_edge, state.prev))

    zero = torch.zeros_like(th)
    v = torch.where(is_edge & ~reached, params.max_xdot, zero)
    w = torch.where(fsm == ROTATE, torch.sign(rot_err) * params.max_wdot,
                    zero)
    cmd = torch.stack([w, v, zero])
    return RectState(fsm=new_fsm.to(torch.int32),
                     prev=new_prev.to(torch.int32)), cmd
