"""The precisions the references compute in: float64 (the reference), and
TF32 (the control; the precision below the float32 the configurations
state), emulated exactly so that it holds on any device and for any shape."""

from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 explicit mantissa bits, round to
    nearest, ties to even, as the tensor cores convert their inputs."""
    i = x.contiguous().view(torch.int32)
    low = i & 0x1FFF
    keep = i & ~0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((i & 0x2000) != 0))
    r = keep + torch.where(up, 0x2000, 0).to(torch.int32)
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 matrix product in TF32: each input rounded to TF32, the
    products summed in float32 (TF32 off for the float32 sum itself)."""
    return torch.matmul(tf32(a.float()), tf32(b.float()))
