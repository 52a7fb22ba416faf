"""Hand-written Hopper kernels and their plain PyTorch versions.

Routing rule shared by every wrapper here: ``use_kernel=None`` (auto) runs
the CUDA kernel for a tensor on the card and the plain version for a tensor
on the CPU; ``False`` runs the plain version anywhere; ``True`` demands the
kernel. On a CUDA tensor a wrapper launches its kernel or raises -- it never
falls back to the plain version on its own.
"""

from __future__ import annotations

import torch


def wants_kernel(x: torch.Tensor, use_kernel: bool | None, name: str) -> bool:
    """Resolve a wrapper's ``use_kernel`` argument for operand ``x``."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError(f"{name}: use_kernel=True needs CUDA tensors, got "
                         f"a tensor on {x.device}")
    return bool(use_kernel)


def require(cond: bool, name: str, what: str) -> None:
    """Raise on an operand the kernel does not take."""
    if not cond:
        raise ValueError(f"{name} kernel: {what}")
