"""Hand-written Hopper kernels and their plain PyTorch versions.

Routing rule shared by every wrapper here: a tensor on the card runs the
CUDA kernel, a tensor on the CPU runs the plain version. On a CUDA tensor a
wrapper launches its kernel or raises -- it never falls back to the plain
version on its own. No function above this package chooses between the two.

The one exception is :func:`plain_versions`, a switch for tests and checks
that hold a kernel to its plain version on the card: inside it every
wrapper runs its plain version on whatever device its tensors are on. No
program entry (the CLI, ``bench.py``, ``bench_megamap.py``, the benchmark
cells) reaches it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_PLAIN = contextvars.ContextVar("plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain version, on any device, inside the block;
    the previous state comes back on exit, also after an exception."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def wants_kernel(x: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for operand ``x``: ``x`` is on
    the card and :func:`plain_versions` is not active."""
    return x.is_cuda and not _PLAIN.get()


def require(cond: bool, name: str, what: str) -> None:
    """Raise on an operand the kernel does not take."""
    if not cond:
        raise ValueError(f"{name} kernel: {what}")


def checked_operands(name: str, device, spec: dict) -> dict:
    """``spec`` maps an operand's name to ``(tensor, shape, dtype)``: raise
    unless each has that shape and dtype on ``device``; return them
    contiguous. The message is built only on failure (formatting it for
    every operand of every call would cost more host time than a kernel
    takes)."""
    ops = {}
    for key, (t, shape, dtype) in spec.items():
        if not (t.shape == shape and t.dtype == dtype and t.device == device):
            require(False, name,
                    f"{key} must be {dtype} {shape} on {device}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
        ops[key] = t.contiguous()
    return ops
