"""Per-step block-banded constraint matrices on batched tensors.

Counterpart of ``trajopt_tpu/qp/block_banded.py``.  Rows are grouped by
their window's step: ``Wb [B, T, R, K*D]`` where R is the (padded) max rows
per step and the window of step t covers columns ``[t*D, (t+K)*D)``.  Row
bookkeeping (which original row lands in which (step, slot)) is static
numpy computed once per problem structure in :func:`make_plan`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from trajopt_tpu_torch.utils import on_device


class BlockPlan(NamedTuple):
    """Static layout: original banded rows -> (step, slot) positions.

    blk_index: [m] flat block-row index (step * R + slot) of each row.
    scatter_idx: [m * w] flat index into (T*R*K*D,) of each row weight.
    """

    T: int
    D: int
    K: int
    R: int
    m: int
    w: int
    blk_index: np.ndarray
    scatter_idx: np.ndarray

    @property
    def n(self) -> int:
        return self.T * self.D

    @property
    def m_blk(self) -> int:
        return self.T * self.R


class BlockBanded(NamedTuple):
    """Runtime block-banded matrix: window weights [B, T, R, K*D]."""

    Wb: torch.Tensor
    plan: BlockPlan


def make_plan(starts: np.ndarray, w: int, T: int, D: int) -> BlockPlan:
    """Layout rows with windows [starts[r], starts[r] + w) into step blocks
    (requires step-aligned windows; rows overhanging the trajectory end go
    to the last feasible step with an in-window offset)."""
    starts = np.asarray(starts, np.int64)
    n = T * D
    if starts.size and (np.any(starts % D != 0) or np.any(starts < 0)
                        or np.any(starts >= n)):
        raise ValueError("block-banded layout requires step-aligned row "
                         "windows (starts % n_dof_total == 0)")
    K = max(1, -(-w // D))
    if K > T:
        raise ValueError(f"window spans {K} steps > T={T}")
    m = int(starts.shape[0])
    step = np.minimum(starts // D, T - K)
    offset = starts - step * D
    slot = np.zeros(m, np.int64)
    counts = np.zeros(T, np.int64)
    for r in range(m):
        slot[r] = counts[step[r]]
        counts[step[r]] += 1
    R = max(int(counts.max()) if m else 1, 1)
    KD = K * D
    blk_index = step * R + slot
    col = np.minimum(offset[:, None] + np.arange(w)[None, :], KD - 1)
    scatter_idx = (blk_index[:, None] * KD + col).reshape(-1)
    return BlockPlan(T=T, D=D, K=K, R=R, m=m, w=w,
                     blk_index=blk_index.astype(np.int64),
                     scatter_idx=scatter_idx.astype(np.int64))


def _idx(plan: BlockPlan, name: str, device) -> torch.Tensor:
    """The plan's index array ``name`` on ``device``, kept on the plan's
    ``blk_index`` (a plan is a tuple, which takes no weak reference)."""
    return on_device(plan.blk_index, name, lambda: getattr(plan, name),
                     device)


def from_rows(W: torch.Tensor, plan: BlockPlan) -> BlockBanded:
    """Pack [B, m, w] row weights into the [B, T, R, K*D] block layout."""
    B = W.shape[0]
    flat = W.new_zeros(B, plan.m_blk * plan.K * plan.D)
    flat = flat.index_add(1, _idx(plan, "scatter_idx", W.device),
                          W.reshape(B, -1))
    return BlockBanded(Wb=flat.reshape(B, plan.T, plan.R, plan.K * plan.D),
                       plan=plan)


def to_block(v: torch.Tensor, plan: BlockPlan, fill: float = 0.0):
    """Permute [B, m] row vectors into padded block order [B, T*R]."""
    out = v.new_full((v.shape[0], plan.m_blk), fill)
    out[:, _idx(plan, "blk_index", v.device)] = v
    return out


def from_block(vb: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """Recover [B, m] original-order row vectors from block order."""
    return vb[:, _idx(plan, "blk_index", vb.device)]


def window(x: torch.Tensor, T: int, D: int, K: int) -> torch.Tensor:
    """[B, n] -> [B, T, K*D] sliding step windows (zero past the end)."""
    xs = x.reshape(x.shape[0], T, D)
    if K == 1:
        return xs
    xp = torch.cat([xs, xs.new_zeros(x.shape[0], K - 1, D)], 1)
    return torch.cat([xp[:, k:k + T] for k in range(K)], -1)


def unwindow_add(g: torch.Tensor, T: int, D: int, K: int) -> torch.Tensor:
    """[B, T, K*D] windowed contributions -> [B, n] via shifted adds."""
    B = g.shape[0]
    if K == 1:
        return g.reshape(B, T * D)
    parts = g.reshape(B, T, K, D)
    out = g.new_zeros(B, T + K - 1, D)
    for k in range(K):
        out[:, k:k + T] += parts[:, :, k]
    return out[:, :T].reshape(B, T * D)


def matvec_wb(Wb: torch.Tensor, x: torch.Tensor, D: int) -> torch.Tensor:
    """C @ x in block row order [B, T*R] for C given as Wb [B, T, R, K*D]."""
    B, T, R, KD = Wb.shape
    xw = window(x, T, D, KD // D)
    return (Wb * xw[:, :, None, :]).sum(-1).reshape(B, T * R)


def rmatvec_wb(Wb: torch.Tensor, y: torch.Tensor, D: int) -> torch.Tensor:
    """C' @ y for y in block row order [B, T*R]."""
    B, T, R, KD = Wb.shape
    g = (Wb * y.reshape(B, T, R)[..., None]).sum(-2)
    return unwindow_add(g, T, D, KD // D)


def matvec(C: BlockBanded, x: torch.Tensor) -> torch.Tensor:
    return matvec_wb(C.Wb, x, C.plan.D)


def rmatvec(C: BlockBanded, y: torch.Tensor) -> torch.Tensor:
    return rmatvec_wb(C.Wb, y, C.plan.D)


def row_inf_norms(C: BlockBanded) -> torch.Tensor:
    return torch.amax(torch.abs(C.Wb), -1).reshape(C.Wb.shape[0],
                                                   C.plan.m_blk)


def col_inf_norms(C: BlockBanded) -> torch.Tensor:
    """Per-column max |A_ij| via windowed max + shifted combine."""
    T, D, K = C.plan.T, C.plan.D, C.plan.K
    B = C.Wb.shape[0]
    cw = torch.amax(torch.abs(C.Wb), 2)                     # [B, T, K*D]
    if K == 1:
        return cw.reshape(B, T * D)
    parts = cw.reshape(B, T, K, D)
    out = cw.new_zeros(B, T + K - 1, D)
    for k in range(K):
        out[:, k:k + T] = torch.maximum(out[:, k:k + T], parts[:, :, k])
    return out[:, :T].reshape(B, T * D)


def scale_rows(C: BlockBanded, e: torch.Tensor) -> BlockBanded:
    """Scale rows by e [B, T*R] (block order)."""
    B = C.Wb.shape[0]
    return C._replace(Wb=C.Wb * e.reshape(B, C.plan.T, C.plan.R)[..., None])


def scale_cols(C: BlockBanded, d: torch.Tensor) -> BlockBanded:
    dw = window(d, C.plan.T, C.plan.D, C.plan.K)             # [B, T, K*D]
    return C._replace(Wb=C.Wb * dw[:, :, None, :])


def at_r_a(C: BlockBanded, rho: torch.Tensor) -> torch.Tensor:
    """A' diag(rho) A as dense [B, n, n] (rho [B, T*R] in block order):
    per-step [K*D, K*D] outer blocks scattered at static offsets."""
    plan = C.plan
    T, D, K, R = plan.T, plan.D, plan.K, plan.R
    KD, n, B = K * D, plan.n, C.Wb.shape[0]
    Wr = C.Wb * rho.reshape(B, T, R)[..., None]
    blocks = Wr.transpose(-1, -2) @ C.Wb                     # [B, T, KD, KD]

    def flat():
        tt = np.arange(T)[:, None, None]
        # steps > T-K hold no rows (their blocks are zero); clamp their
        # indices.
        ii = np.minimum(tt * D + np.arange(KD)[None, :, None], n - 1)
        jj = np.minimum(tt * D + np.arange(KD)[None, None, :], n - 1)
        return np.broadcast_to(ii * n + jj, (T, KD, KD)).reshape(-1)

    out = C.Wb.new_zeros(B, n * n)
    idx = on_device(plan.blk_index, "at_r_a", flat, C.Wb.device)
    out = out.index_add(1, idx, blocks.reshape(B, -1))
    return out.reshape(B, n, n)


def to_dense(C: BlockBanded) -> torch.Tensor:
    """[B, m_blk, n] dense materialization in block row order (tests)."""
    plan = C.plan
    T, D, K, R, n = plan.T, plan.D, plan.K, plan.R, plan.n
    B = C.Wb.shape[0]
    rows = np.arange(T)[:, None, None] * R + np.arange(R)[None, :, None]
    cols = np.minimum(np.arange(T)[:, None, None] * D
                      + np.arange(K * D)[None, None, :], n - 1)
    flat = np.broadcast_to(rows * n + cols, (T, R, K * D)).reshape(-1)
    out = C.Wb.new_zeros(B, plan.m_blk * n)
    out = out.index_add(1, torch.tensor(flat, device=C.Wb.device),
                        C.Wb.reshape(B, -1))
    return out.reshape(B, plan.m_blk, n)
