"""Forward-difference derivatives (num_diff.hpp/cpp analog).

Counterpart of ``trajopt_tpu/utils/finite_diff.py``.  The reference
differentiates everything by forward differences with eps=1e-5
(``calcForwardNumGrad/Jac/Hessian``, ``trajopt_sco/src/num_diff.cpp``;
DEFAULT_EPSILON at modeling_utils.cpp:13).  The port's terms use exact
autodiff, but FD remains part of the toolkit: validating user-supplied
analytic Jacobians and differentiating black boxes.

``f`` takes one point ``x [n]``; the perturbed evaluations run as one
``torch.func.vmap`` over the unit directions, so ``f`` must be a torch
function that vmap can batch.
"""

from __future__ import annotations

from typing import Callable

import torch

from trajopt_tpu_torch.sqp.nlp import one_lane

DEFAULT_EPSILON = 1e-5  # modeling_utils.cpp:13


def num_grad(f: Callable, x: torch.Tensor, eps: float = DEFAULT_EPSILON):
    """Forward-difference gradient [n] of a scalar function."""
    f0 = f(x)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    return torch.func.vmap(lambda d: (f(x + eps * d) - f0) / eps)(eye)


def num_jac(f: Callable, x: torch.Tensor, eps: float = DEFAULT_EPSILON):
    """Forward-difference Jacobian [m, n] (calcForwardNumJac)."""
    f0 = torch.atleast_1d(f(x))
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    cols = torch.func.vmap(
        lambda d: (torch.atleast_1d(f(x + eps * d)) - f0) / eps)(eye)
    return cols.T


def num_hessian_diag(f: Callable, x: torch.Tensor,
                     eps: float = DEFAULT_EPSILON):
    """Central second differences for the Hessian diagonal
    (calcGradAndDiagHess)."""
    f0 = f(x)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)

    def second(d):
        return (f(x + eps * d) - 2.0 * f0 + f(x - eps * d)) / (eps * eps)

    return torch.func.vmap(second)(eye)


def num_hessian(f: Callable, x: torch.Tensor, eps: float = 1e-4):
    """Full FD Hessian [n, n] via gradient differencing (calcGradHess)."""
    g0 = num_grad(f, x, eps)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    H = torch.func.vmap(lambda d: (num_grad(f, x + eps * d, eps) - g0)
                        / eps)(eye)
    return 0.5 * (H + H.T)


def fd_jac_fn(term_fn: Callable, eps: float = DEFAULT_EPSILON):
    """Wrap a batched term residual ``term_fn(x [B, n], params)`` into a
    TermSet ``jac_fn``: the forward-difference Jacobian [B, rows, n] of
    each lane (the numerical-constraint validation variants of the ifopt
    stack)."""

    def lane_jac(x, params):
        return num_jac(lambda v: term_fn(v[None], one_lane(params))[0], x,
                       eps)

    def jac(x, params):
        return torch.func.vmap(lane_jac)(x, params)

    return jac
