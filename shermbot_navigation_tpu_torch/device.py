"""Where the package's entry points run.

Every entry point takes ``device=None``, and ``None`` means the CUDA card:
the port is written for the card, and a run that silently carried on on the
CPU would report CPU numbers under a device's name. The CPU is available,
but only when the caller asks for it with ``device="cpu"`` (as the tests
do).

Devices are compared after :func:`resolve`: a tensor on the card reports
``cuda:<index>`` and one on the CPU reports ``cpu``, so a bare ``"cuda"``
or a ``"cpu:0"`` would otherwise differ from the device its own tensors
name.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The normalized device: ``None`` or a bare ``"cuda"`` ->
    ``cuda:<current index>`` (raise when there is no card); any CPU
    spelling -> ``cpu``; anything else -> ``torch.device(device)``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the card by default; "
                'pass device="cpu" to run on the CPU')
        return torch.device("cuda", torch.cuda.current_device())
    return dev
