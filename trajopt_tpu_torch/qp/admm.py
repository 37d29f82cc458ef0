"""Prox-ADMM QP configuration, result container and the dual-magnitude
cost rescale shared by the QP paths.

Counterpart of ``trajopt_tpu/qp/admm.py`` (the OSQP-style splitting
``xt = M^-1 (sigma x - q + A'(R z - y))``, relaxed by ``alpha``, with the
soft-clamp prox of ``c * dist(z, [l, u])``).  Ported: ``ADMMConfig``,
``ADMMResult``, ``apply_dual_cost_scale`` and its helpers; the dense
``solve_qp`` (adaptive rho, Anderson) waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Solver configuration (OSQP-like defaults).

    ``use_pallas`` and ``pallas_sub_batch`` are accepted so a JAX
    ``ADMMConfig`` converts field for field, and are ignored: on a CUDA
    tensor the block path always runs the hand-written chunk kernel
    (qp/fused_block.py), and the sub-batch is a TPU VMEM knob.
    ``adaptive_rho`` and ``anderson`` belong to the dense path, which is not
    ported yet; the block path uses fixed rho, as the JAX block path does.
    ``ns_coarse`` runs its coarse Newton-Schulz phase at full precision
    (the port keeps TF32 off everywhere).
    """

    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    max_iter: int = 500
    check_every: int = 25
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    adaptive_rho: bool = True
    adaptive_rho_threshold: float = 5.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # Global rho boost from the largest finite scaled penalty weight (the
    # fix for dual starvation of escalated-penalty QPs), folded into the
    # cost normalization by apply_dual_cost_scale.
    rho_dual_scale: float = 0.0
    rho_dual_thresh: float = 100.0
    ruiz_iters: int = 10
    use_pallas: bool = False
    pallas_sub_batch: int = 32
    ns_refresh: bool = False
    ns_tol: float = 1e-5
    ns_max_iter: int = 25
    ns_power_iters: int = 8
    ns_coarse: bool = False
    anderson: int = 0


class ADMMResult(NamedTuple):
    x: torch.Tensor          # [B, n]
    z: torch.Tensor          # [B, m]
    y: torch.Tensor          # [B, m]
    iters: torch.Tensor      # [B] int
    pri_res: torch.Tensor    # [B]
    dua_res: torch.Tensor    # [B]
    converged: torch.Tensor  # [B] bool


def _prox_dist(v, l, u, c_over_rho):
    """Prox of c * dist(., [l, u]) with step 1/rho, elementwise; for
    c = +inf it is clip(v, l, u)."""
    return torch.where(v > u, torch.maximum(u, v - c_over_rho),
                       torch.where(v < l, torch.minimum(l, v + c_over_rho),
                                   v))


def _dual_rho_scale(c: torch.Tensor, cfg: ADMMConfig) -> torch.Tensor:
    """Per-lane factor gamma >= 1 from the largest finite (scaled) penalty
    weight of c [B, m] — see ADMMConfig.rho_dual_scale."""
    one = c.new_ones(c.shape[0])
    if cfg.rho_dual_scale <= 0.0:
        return one
    max_c = torch.amax(torch.where(torch.isinf(c), torch.zeros_like(c), c), -1)
    gs = torch.maximum(one, cfg.rho_dual_scale * max_c)
    return torch.where(max_c >= cfg.rho_dual_thresh, gs, one)


def apply_dual_cost_scale(P, q, c, c_obj, cfg: ADMMConfig):
    """Scale the objective (P, q, penalty weights c) down by gamma, which is
    exactly equivalent to boosting every rho by gamma.  Shapes: P [B,n,n],
    q [B,n], c [B,m], c_obj [B].  Returns (P, q, c, c_obj) scaled."""
    gamma = _dual_rho_scale(c, cfg)
    c = torch.where(torch.isinf(c), c, c / gamma[:, None])
    return (P / gamma[:, None, None], q / gamma[:, None], c, c_obj / gamma)
