"""Products with their operands rounded: exact float64 or emulated TF32."""

from __future__ import annotations

import numpy as np


def exact(a):
    return a


def tf32(a):
    """``a`` rounded to TF32 (float32 with 10 explicit mantissa bits,
    round to nearest even), returned as float64."""
    bits = np.asarray(a, np.float64).astype(np.float32).view(np.uint32)
    lsb = (bits >> np.uint32(13)) & np.uint32(1)
    bits = (bits + np.uint32(0x0FFF) + lsb) & np.uint32(0xFFFFE000)
    return bits.view(np.float32).astype(np.float64)


def mul(rnd, a, b):
    return rnd(a) * rnd(b)


def dot(rnd, a, b):
    """Sum over the last axis of a * b."""
    return (rnd(a) * rnd(b)).sum(-1)


def matvec(rnd, R, v):
    """R [..., 3, 3] @ v [..., 3]."""
    return (rnd(R) * rnd(v)[..., None, :]).sum(-1)


def rmatvec(rnd, R, v):
    """R.T @ v."""
    return (rnd(R) * rnd(v)[..., :, None]).sum(-2)


def matmul(rnd, A, B):
    """A [..., 3, 3] @ B [..., 3, 3]."""
    return (rnd(A)[..., :, :, None] * rnd(B)[..., None, :, :]).sum(-2)


def norm(rnd, v):
    return np.sqrt(dot(rnd, v, v))
