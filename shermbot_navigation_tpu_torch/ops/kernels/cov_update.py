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

The wrapper is a ``torch.library`` custom op with a vmap rule, so the
dense engine under ``torch.func.vmap`` (``driver.run_scenario_batch``)
reaches one launch for its B worlds, ``(B, D, D)`` covariances, as the
JAX package's ``vmap`` batches its ``pallas_call``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import require, wants_kernel
from ._build import check, library, stream_handle


def reference_kalman_update(cov, sht, psi_inv, dz, mean, apply=None):
    """Plain PyTorch twin of the JAX ``reference_kalman_update``, for one
    world or a leading batch on every operand; with ``apply`` (bool
    tensor, one a world) the result is ``where(apply, new, old)``.
    The two-term sums are written out, in the kernel's order, so that a
    world's result does not depend on the batch it is in. Returns
    ``(cov', mean')`` as new tensors."""
    K = sht @ psi_inv
    k0, k1 = K[..., 0], K[..., 1]
    cov_u = cov - (k0[..., :, None] * sht[..., None, :, 0]
                   + k1[..., :, None] * sht[..., None, :, 1])
    mean_u = mean + (k0 * dz[..., :1] + k1 * dz[..., 1:])
    if apply is not None:
        cov_u = torch.where(apply[..., None, None], cov_u, cov)
        mean_u = torch.where(apply[..., None], mean_u, mean)
    return cov_u, mean_u


def _launch(cov, sht, psi_inv, dz, mean, apply):
    """One launch for the worlds of a ``(B, D, D)`` ``cov`` (or one
    ``(D, D)``), every operand with the same leading shape."""
    name = "cov_update"
    lead = tuple(cov.shape[:-2])
    D = cov.shape[-1]
    dev = cov.device
    f32 = torch.float32
    require(len(lead) <= 1 and D % 128 == 0, name,
            f"cov must be (D, D) or (B, D, D) with D % 128 == 0 (pad the "
            f"state), got {tuple(cov.shape)}")
    spec = {"cov": (cov, (*lead, D, D), f32), "sht": (sht, (*lead, D, 2), f32),
            "psi_inv": (psi_inv, (*lead, 2, 2), f32),
            "dz": (dz, (*lead, 2), f32), "mean": (mean, (*lead, D), f32)}
    if apply is not None:
        spec["apply"] = (apply, lead, torch.bool)
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
        cov_o.data_ptr(), mean_o.data_ptr(), D, lead[0] if lead else 1,
        stream_handle(dev))
    check(name, code)
    fused_kalman_update.launches += 1
    return cov_o, mean_o


@torch.library.custom_op("shermbot_navigation_tpu_torch::cov_update",
                         mutates_args=())
def _cov_update(cov: torch.Tensor, sht: torch.Tensor, psi_inv: torch.Tensor,
                dz: torch.Tensor, mean: torch.Tensor,
                apply: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if not wants_kernel(cov):
        return reference_kalman_update(cov, sht, psi_inv, dz, mean, apply)
    return _launch(cov, sht, psi_inv, dz, mean, apply)


@_cov_update.register_fake
def _(cov, sht, psi_inv, dz, mean, apply):
    return torch.empty_like(cov), torch.empty_like(mean)


@_cov_update.register_vmap
def _(info, in_dims, cov, sht, psi_inv, dz, mean, apply):
    """B worlds: the batch axis first on every operand (an unbatched one
    broadcast), then one call of the op -- one launch on the card."""
    def lead(x, dim):
        if x is None:
            return None
        return x.expand(info.batch_size, *x.shape) if dim is None \
            else x.movedim(dim, 0)
    args = [lead(x, d) for x, d in
            zip((cov, sht, psi_inv, dz, mean, apply), in_dims)]
    return _cov_update(*args), (0, 0)


def fused_kalman_update(cov, sht, psi_inv, dz, mean, apply=None):
    """Apply the fused update; returns ``(cov', mean')`` as new tensors.

    ``cov`` (D, D) f32 with D % 128 == 0, ``sht`` (D, 2), ``psi_inv``
    (2, 2), ``dz`` (2,), ``mean`` (D,), ``apply`` a () bool tensor or
    ``None`` (always); or each with a leading B (B worlds, one launch),
    which ``torch.func.vmap`` of a one-world call gives. Routed by the
    package rule (``ops/kernels/__init__.py``): the CUDA kernel for a CUDA
    ``cov``, the plain version on the CPU. ``fused_kalman_update.launches``
    counts kernel launches.
    """
    return _cov_update(cov, sht, psi_inv, dz, mean, apply)


fused_kalman_update.launches = 0
