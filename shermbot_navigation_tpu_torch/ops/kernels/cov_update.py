"""The dense engine's fused Kalman update (port of
``shermbot_navigation_tpu.ops.pallas.cov_update``)::

    K     = SHt @ psi_inv            (D, 2)
    mean' = mean + K @ dz            (D,)
    cov'  = cov - K @ SHt^T          (D, D)

On the card it is ``csrc/cov_update.cu``, which replaces the TPU kernel
``fused_kalman_update`` (``ops/pallas/cov_update.py``). It is bound by
device-memory bandwidth: Sigma is read once and written once (2 x 4 D^2
bytes, 143 MB at D=4224), K is formed per row on the fly and never stored.
The kernel writes a new covariance (out of place) and takes the tick's
update flag ``apply`` as a device scalar: with ``apply`` false it copies
``cov`` and ``mean`` unchanged, so the tick's ``where(do_update, upd,
pre)`` costs no extra pass. :func:`reference_kalman_update` is the plain
version.
"""

from __future__ import annotations

import torch

from . import require, wants_kernel
from ._build import check, library, stream_handle


def reference_kalman_update(cov, sht, psi_inv, dz, mean, apply=None):
    """Plain PyTorch twin of the JAX ``reference_kalman_update``; with
    ``apply`` (bool tensor) the result is ``where(apply, new, old)``.
    Returns ``(cov', mean')`` as new tensors."""
    K = sht @ psi_inv
    cov_u = cov - K @ sht.T
    mean_u = mean + K @ dz
    if apply is not None:
        cov_u = torch.where(apply, cov_u, cov)
        mean_u = torch.where(apply, mean_u, mean)
    return cov_u, mean_u


def fused_kalman_update(cov, sht, psi_inv, dz, mean, apply=None,
                        use_kernel: bool | None = None):
    """Apply the fused update; returns ``(cov', mean')`` as new tensors.

    ``cov`` (D, D) f32 with D % 128 == 0, ``sht`` (D, 2), ``psi_inv``
    (2, 2), ``dz`` (2,), ``mean`` (D,), ``apply`` a () bool tensor or
    ``None`` (always). ``use_kernel`` follows the package rule
    (``ops/kernels/__init__.py``): auto launches the CUDA kernel for a CUDA
    ``cov`` and runs the plain version on the CPU.
    ``fused_kalman_update.launches`` counts kernel launches.
    """
    name = "cov_update"
    if not wants_kernel(cov, use_kernel, name):
        return reference_kalman_update(cov, sht, psi_inv, dz, mean, apply)
    D = cov.shape[0]
    dev = cov.device
    f32 = torch.float32
    require(D % 128 == 0, name, f"D % 128 == 0 (pad the state), got D={D}")
    spec = {"cov": (cov, (D, D), f32), "sht": (sht, (D, 2), f32),
            "psi_inv": (psi_inv, (2, 2), f32), "dz": (dz, (2,), f32),
            "mean": (mean, (D,), f32)}
    if apply is not None:
        spec["apply"] = (apply, (), torch.bool)
    ops = {}
    for key, (t, shape, dtype) in spec.items():
        require(tuple(t.shape) == shape and t.dtype == dtype
                and t.device == dev, name,
                f"{key} must be {dtype} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        ops[key] = t.contiguous()
    # float4 loads of cov and sht rows
    require(ops["cov"].data_ptr() % 16 == 0 and ops["sht"].data_ptr() % 16
            == 0, name, "cov and sht must be 16-byte aligned")
    cov_o = torch.empty_like(ops["cov"])
    mean_o = torch.empty_like(ops["mean"])
    code = library().cov_update(
        ops["cov"].data_ptr(), ops["sht"].data_ptr(),
        ops["psi_inv"].data_ptr(), ops["dz"].data_ptr(),
        ops["mean"].data_ptr(),
        ops["apply"].data_ptr() if apply is not None else None,
        cov_o.data_ptr(), mean_o.data_ptr(), D, stream_handle(dev))
    check(name, code)
    fused_kalman_update.launches += 1
    return cov_o, mean_o


fused_kalman_update.launches = 0
