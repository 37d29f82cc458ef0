"""Banded (windowed) constraint matrices for the gather-banded QP path, on
batches.

Counterpart of ``trajopt_tpu/qp/banded.py``.  Row r of a [m, n] matrix is
dense inside its window of static width w, columns ``idx[r] = starts[r] +
arange(w)`` clamped to n - 1 (a row that overhangs the last column repeats
it, with zero weights there).  Only the window weights ``W [B, m, w]`` are
per lane; the column indices are shared by the batch.  Matvecs are a
gather and a rowwise dot, the transpose a scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BandedMatrix(NamedTuple):
    """``[B, m, n]`` matrices with per-row windows of width w.

    W:   [B, m, w] window weights.
    idx: [m, w] column index of each weight (int64, on W's device; a
         clamped column may repeat, its weights are 0).
    n:   number of columns.
    """

    W: torch.Tensor
    idx: torch.Tensor
    n: int

    @property
    def m(self) -> int:
        return self.W.shape[1]

    @property
    def w(self) -> int:
        return self.W.shape[2]


def make_banded(W: torch.Tensor, starts: np.ndarray, n: int) -> BandedMatrix:
    """Rows with windows [starts[r], starts[r] + w), clamped to n."""
    w = W.shape[-1]
    idx = np.minimum(np.asarray(starts)[:, None] + np.arange(w)[None, :],
                     n - 1)
    return BandedMatrix(W=W, idx=torch.as_tensor(idx, device=W.device), n=n)


def _flat(Bm: BandedMatrix) -> torch.Tensor:
    return Bm.idx.reshape(-1)


def matvec(Bm: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """A @ x [B, m]: gather the windows, rowwise dot."""
    return (Bm.W * x[:, Bm.idx]).sum(-1)


def rmatvec(Bm: BandedMatrix, y: torch.Tensor) -> torch.Tensor:
    """A' @ y [B, n]: scatter-add of the weighted rows."""
    B = Bm.W.shape[0]
    return Bm.W.new_zeros(B, Bm.n).index_add(
        1, _flat(Bm), (Bm.W * y[..., None]).reshape(B, -1))


def to_dense(Bm: BandedMatrix) -> torch.Tensor:
    """[B, m, n] dense materialization (tests, small problems)."""
    B, m, w = Bm.W.shape
    rows = torch.arange(m, device=Bm.W.device)[:, None] * Bm.n
    out = Bm.W.new_zeros(B, m * Bm.n)
    return out.index_add(1, (rows + Bm.idx).reshape(-1),
                         Bm.W.reshape(B, -1)).reshape(B, m, Bm.n)


def at_r_a(Bm: BandedMatrix, rho: torch.Tensor) -> torch.Tensor:
    """A' diag(rho) A as a dense [B, n, n]: each row's [w, w] outer
    product scattered at its window (rho [B, m])."""
    B, n = Bm.W.shape[0], Bm.n
    WR = Bm.W * rho[..., None]
    contrib = WR[:, :, :, None] * Bm.W[:, :, None, :]        # [B, m, w, w]
    flat = (Bm.idx[:, :, None] * n + Bm.idx[:, None, :]).reshape(-1)
    out = Bm.W.new_zeros(B, n * n)
    return out.index_add(1, flat, contrib.reshape(B, -1)).reshape(B, n, n)


def row_inf_norms(Bm: BandedMatrix) -> torch.Tensor:
    return torch.amax(torch.abs(Bm.W), -1)


def col_inf_norms(Bm: BandedMatrix) -> torch.Tensor:
    """Per-column max |A_ij| [B, n] by scatter-max (columns no row touches
    give 0)."""
    B = Bm.W.shape[0]
    return Bm.W.new_zeros(B, Bm.n).scatter_reduce(
        1, _flat(Bm).expand(B, -1), torch.abs(Bm.W).reshape(B, -1),
        reduce="amax")


def scale_rows(Bm: BandedMatrix, e: torch.Tensor) -> BandedMatrix:
    return Bm._replace(W=Bm.W * e[..., None])


def scale_cols(Bm: BandedMatrix, d: torch.Tensor) -> BandedMatrix:
    return Bm._replace(W=Bm.W * d[:, Bm.idx])
