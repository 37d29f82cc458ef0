"""PyTorch/CUDA port of trajopt_tpu: trust-region SQP trajectory optimization
with swept-volume collision constraints, written for one NVIDIA H100.

The module layout mirrors ``trajopt_tpu/`` so each counterpart is easy to
find; the code is PyTorch idiom (plain functions on batched tensors, batch on
the leading axis, per-lane active masks where the JAX package vmapped a
``lax.while_loop``).  Nothing here imports ``jax`` or ``trajopt_tpu``.

Device and precision policy:

* Entry points (``TrajOptProblem.make_solve``, ``pr2ish_table_problem``,
  ``pr2ish_table_batch``) run on ``cuda`` unless the caller passes
  ``device="cpu"``; without a CUDA device they raise instead of falling back.
* The device dtype is float32 with TF32 off: the ADMM and Cholesky
  tolerances (1e-4-level constraint decisions) do not survive short-mantissa
  matrix products.  The CPU tests run float64.
"""

from __future__ import annotations

import torch

DEVICE_DTYPE = torch.float32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The port's default device: the first CUDA device.  Raises when no
    CUDA device is present (pass ``device="cpu"`` explicitly instead)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "trajopt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> torch.device."""
    return default_device() if device is None else torch.device(device)


def resolve_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """Explicit dtype wins; otherwise float32 on the card, float64 on CPU."""
    if dtype is not None:
        return dtype
    return DEVICE_DTYPE if device.type == "cuda" else torch.float64
