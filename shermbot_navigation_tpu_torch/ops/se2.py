"""SE(2) rigid-body transform algebra (port of
``shermbot_navigation_tpu.ops.se2``).

A transform is a trailing-dim-4 tensor ``[cos(th), sin(th), x, y]`` (the
reference's internal layout, ``rigid2d.hpp:168-175``), a twist a
trailing-dim-3 tensor ``[dth, dx, dy]``, a vector a trailing-dim-2
``[x, y]``; every op broadcasts over leading batch dimensions. The
reference's ``dth == 0`` branch of ``integrateTwist`` is the same
branchless sinc form as in the JAX package.
"""

from __future__ import annotations

import torch

from ..device import resolve

PI = 3.14159265358979323846

# Component index aliases for transforms [c, s, x, y].
_C, _S, _X, _Y = 0, 1, 2, 3


def deg2rad(deg):
    """Degrees to radians (ref ``rigid2d.hpp:40-44``)."""
    return (PI / 180.0) * deg


def rad2deg(rad):
    """Radians to degrees (ref ``rigid2d.hpp:49-53``)."""
    return (180.0 / PI) * rad


def normalize_angle(rad: torch.Tensor) -> torch.Tensor:
    """Wrap any angle into (-pi, pi] (ref ``rigid2d.cpp:9-13``): the same
    branchless, exactly periodic ``atan2(sin, cos)`` as the JAX package."""
    return torch.atan2(torch.sin(rad), torch.cos(rad))


def identity(dtype=torch.float32, device=None):
    """Identity transform (ref ``Transform2D::Transform2D()``);
    ``device=None`` is the card."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=resolve(device))


def from_translation(v):
    """Pure translation from vector(s) ``[..., 2]`` (ref rigid2d.cpp:170-176)."""
    one = torch.ones_like(v[..., 0])
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([one, zero, v[..., 0], v[..., 1]], dim=-1)


def from_rotation(radians):
    """Pure rotation (ref rigid2d.cpp:178-184)."""
    zero = torch.zeros_like(radians)
    return torch.stack([torch.cos(radians), torch.sin(radians), zero, zero],
                       dim=-1)


def from_parts(v, radians):
    """Transform from translation ``[..., 2]`` + rotation (ref
    rigid2d.cpp:186-192)."""
    return torch.stack([torch.cos(radians), torch.sin(radians), v[..., 0],
                        v[..., 1]], dim=-1)


def from_pose(pose):
    """Transform from pose tensor ``[..., 3]`` laid out ``[th, x, y]`` (the
    EKF robot-state layout, ref ``slam_library.cpp:39-63``)."""
    th = pose[..., 0]
    return torch.stack([torch.cos(th), torch.sin(th), pose[..., 1],
                        pose[..., 2]], dim=-1)


def to_pose(T):
    """Inverse of :func:`from_pose`: ``[th, x, y]`` with th from atan2."""
    th = torch.atan2(T[..., _S], T[..., _C])
    return torch.stack([th, T[..., _X], T[..., _Y]], dim=-1)


def angle(T):
    """Rotation angle of transform(s), via atan2."""
    return torch.atan2(T[..., _S], T[..., _C])


def apply(T, v):
    """Apply transform(s) to vector(s): ``R v + t`` (ref rigid2d.cpp:194-200)."""
    c, s = T[..., _C], T[..., _S]
    x = v[..., 0] * c - v[..., 1] * s + T[..., _X]
    y = v[..., 0] * s + v[..., 1] * c + T[..., _Y]
    return torch.stack([x, y], dim=-1)


def inv(T):
    """Inverse transform (ref ``Transform2D::inv``, rigid2d.cpp:202-211)."""
    c, s, x, y = T[..., _C], T[..., _S], T[..., _X], T[..., _Y]
    return torch.stack([c, -s, -x * c - y * s, x * s - y * c], dim=-1)


def compose(Ta, Tb):
    """Composition ``Ta @ Tb`` (ref ``operator*=``, rigid2d.cpp:213-229)."""
    ca, sa, xa, ya = Ta[..., _C], Ta[..., _S], Ta[..., _X], Ta[..., _Y]
    cb, sb, xb, yb = Tb[..., _C], Tb[..., _S], Tb[..., _X], Tb[..., _Y]
    return torch.stack([ca * cb - sa * sb,
                        sa * cb + ca * sb,
                        ca * xb - sa * yb + xa,
                        sa * xb + ca * yb + ya], dim=-1)


def adjoint_twist(T, tw):
    """Change the frame of a twist ``[..., 3] = [dth, dx, dy]`` with the
    adjoint of ``T`` (ref rigid2d.cpp:276-283)."""
    c, s, x, y = T[..., _C], T[..., _S], T[..., _X], T[..., _Y]
    dth, dx, dy = tw[..., 0], tw[..., 1], tw[..., 2]
    return torch.stack([dth,
                        y * dth + c * dx - s * dy,
                        -x * dth + s * dx + c * dy], dim=-1)


def _sinc_pair(dth, eps=1e-7):
    """Branchless ``(sin(dth)/dth, (1-cos(dth))/dth)`` exact at 0: near 0
    the series ``1 - x^2/6`` and ``x/2`` (the reference's ``dth == 0``
    branch, rigid2d.cpp:299-304, in the limit)."""
    small = torch.abs(dth) < eps
    safe = torch.where(small, torch.ones_like(dth), dth)
    s1 = torch.where(small, 1.0 - dth * dth / 6.0, torch.sin(safe) / safe)
    s2 = torch.where(small, dth / 2.0, (1.0 - torch.cos(safe)) / safe)
    return s1, s2


def integrate_twist(tw):
    """Exponential map: displacement after following a constant twist for
    unit time (ref ``integrateTwist``, rigid2d.cpp:294-328)::

        T = [cos dth, sin dth, dx*s1 - dy*s2, dx*s2 + dy*s1]
        s1 = sin(dth)/dth,  s2 = (1 - cos(dth))/dth
    """
    dth, dx, dy = tw[..., 0], tw[..., 1], tw[..., 2]
    s1, s2 = _sinc_pair(dth)
    return torch.stack([torch.cos(dth), torch.sin(dth),
                        dx * s1 - dy * s2, dx * s2 + dy * s1], dim=-1)
