"""Where the package's entry points run.

Every entry point takes ``device=None``, and ``None`` means the CUDA card:
the port is written for the card, and a run that silently carried on on the
CPU would report CPU numbers under a device's name. The CPU is available,
but only when the caller asks for it with ``device="cpu"`` (as the tests
do).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``, or raise when there is no card;
    anything else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the card by default; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda")
