"""Debug-mode NaN/inf tripwires (port of
``shermbot_navigation_tpu.utils.guards``).

A NaN propagates silently through every later tick (f32 conditioning
cliffs at 50k-landmark scale NaN'd production stage-2 runs, BENCH_NOTES
pathologies 6-7). These helpers name the first non-finite field of a run
and fail loudly, while the production path (un-wrapped) pays nothing.

The JAX package threads ``checkify`` user checks through its jitted
programs; here the check is a record on the device: :func:`check_finite`
folds ``isfinite(leaf).all()`` of each floating leaf into an integer
scalar holding the index of the first failing label (-1: none), with no
host sync, so a guarded tick still never waits for the card. The one host
read is :meth:`FiniteError.throw`.

Usage::

    err, out = checked(my_tick)(state, ...)
    err.throw()                       # raises naming the field

or, for the pipeline driver, :func:`run_scenario_checked` mirrors
``pipeline.driver.run_scenario`` with per-tick mean/cov checks.
"""

from __future__ import annotations

import contextvars
import functools

import torch


class NonFiniteError(RuntimeError):
    """A checked run met a non-finite value; the message names the field
    (``non-finite values in ekf.cov``)."""


class FiniteError:
    """The device-side record of a checked call: ``code`` an integer
    scalar tensor (-1, or the index into ``labels`` of the first failing
    check; one label a leaf a check)."""

    def __init__(self):
        self.labels: list[str] = []
        self.code: torch.Tensor | None = None

    def _fold(self, labels: list[str], ok: torch.Tensor) -> None:
        """Fold one call's per-leaf flags ``ok`` (bool, one per label)
        into ``code``, keeping the first failure. Device ops only: the
        labels' base index travels as a kernel scalar, no copy."""
        base = len(self.labels)
        self.labels.extend(labels)
        first = torch.where(ok.all(), -1, base + (~ok).int().argmax())
        self.code = first if self.code is None else torch.where(
            self.code >= 0, self.code, first)

    def get(self) -> str | None:
        """The message of the first failure, or None (a host read)."""
        if self.code is None or int(self.code) < 0:
            return None
        return f"non-finite values in {self.labels[int(self.code)]}"

    def throw(self) -> None:
        """Raise :class:`NonFiniteError` naming the first failing field, if
        any (the one host read of a checked run)."""
        msg = self.get()
        if msg is not None:
            raise NonFiniteError(msg)


_CURRENT: contextvars.ContextVar[FiniteError | None] = \
    contextvars.ContextVar("finite_error", default=None)


def _leaves(tree, path=""):
    """(label suffix, tensor) of every tensor of a NamedTuple nest, the
    suffix as JAX's ``keystr`` writes it (``.mean_r``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for k, v in zip(tree._fields, tree)
                for leaf in _leaves(v, f"{path}.{k}")]
    return [(path, tree)] if isinstance(tree, torch.Tensor) else []


def check_finite(tree, name: str = "state") -> None:
    """Record that every floating leaf of ``tree`` is finite. Must be
    called inside a function wrapped by :func:`checked`; a plain call
    outside raises."""
    err = _CURRENT.get()
    if err is None:
        raise RuntimeError("check_finite must run inside a checked() call")
    leaves = [(name + p, x) for p, x in _leaves(tree)
              if x.is_floating_point()]
    if leaves:
        err._fold([lab for lab, _ in leaves],
                  torch.stack([torch.isfinite(x).all() for _, x in leaves]))


def checked(fn):
    """Wrap ``fn`` (which may call :func:`check_finite`) into the form
    ``(err, out) = wrapped(*args)``; the caller decides when to
    ``err.throw()``. A failure of ``fn`` itself (a kernel's included)
    propagates as it is."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        err = FiniteError()
        token = _CURRENT.set(err)
        try:
            out = fn(*args, **kwargs)
        finally:
            _CURRENT.reset(token)
        return err, out

    return wrapped


def run_scenario_checked(scn, noise, dtype=torch.float32, device=None,
                         steps=None):
    """``pipeline.driver.run_scenario`` with a per-tick NaN/inf tripwire
    on the EKF mean and covariance and the odometry pose. Returns the
    stacked TickOutputs; raises :class:`NonFiniteError` naming the bad
    field if any tick goes non-finite. ``device=None`` is the card."""
    from ..pipeline import driver

    def check(st, out):
        check_finite(st.filt.mean, "ekf.mean")
        check_finite(st.filt.cov, "ekf.cov")
        check_finite(out.odom_pose, "odom.pose")

    err, outs = checked(driver.run_scenario)(scn, noise, dtype, device,
                                             steps, on_tick=check)
    err.throw()
    return outs


def checked_blocked_tick(step):
    """Wrap a blocked-EKF tick (``step(state, tw, zs, valid, [ids,] Q, R)
    -> state``, with or without ``mesh=``) with a post-step finiteness
    tripwire over the whole BlockedState. Returns ``wrapped(*args) ->
    (err, state)``."""

    @functools.wraps(step)
    def tick(*args):
        st = step(*args)
        check_finite(st, "blocked")
        return st

    return checked(tick)
