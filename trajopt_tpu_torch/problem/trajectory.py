"""Trajectory problem container: decision matrix, bounds, init trajectories.

Counterpart of ``trajopt_tpu/problem/trajectory.py`` (the reference's
``TrajOptProb`` + ``ConstructProblem``): the decision variable is a flat
view of an ``[n_steps, n_dof (+1 time column)]`` matrix per lane; joint
limits give variable bounds; fixed timesteps/dofs pin entries by collapsing
their bounds to the initial value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from trajopt_tpu_torch import resolve_device, resolve_dtype
from trajopt_tpu_torch.sqp.nlp import Nlp, TermSet
from trajopt_tpu_torch.sqp.params import SQPParams
from trajopt_tpu_torch.sqp.solver import SQPResult, make_solver


@dataclasses.dataclass
class TrajOptProblem:
    """Mutable builder; ``build()`` freezes it into an Nlp.  ``device`` is
    where ``make_solve`` runs when the caller names none (None: CUDA)."""

    n_steps: int
    n_dof: int
    joint_lower: np.ndarray | Sequence[float]
    joint_upper: np.ndarray | Sequence[float]
    use_time: bool = False
    dt_lower: float = 1e-3
    dt_upper: float = 100.0
    fixed_steps: Sequence[int] = ()
    fixed_dofs: Sequence[int] = ()
    term_sets: list[TermSet] = dataclasses.field(default_factory=list)
    device: Any = None

    @property
    def n_dof_total(self) -> int:
        return self.n_dof + (1 if self.use_time else 0)

    @property
    def n(self) -> int:
        return self.n_steps * self.n_dof_total

    def add_term(self, term: TermSet) -> "TrajOptProblem":
        self.term_sets.append(term)
        return self

    def build(self) -> Nlp:
        self._validate_terms()
        return Nlp(n=self.n, term_sets=tuple(self.term_sets),
                   block=(self.n_steps, self.n_dof_total))

    def _validate_terms(self) -> None:
        """Catch shape mistakes at construction: each term runs on one
        shape-only (meta) lane and must produce its declared row count."""
        x0 = torch.zeros(1, self.n, dtype=torch.float64, device="meta")
        for t in self.term_sets:
            try:
                out = t.fn(x0, {})
            except KeyError:
                continue  # params-dependent term; can't probe without params
            except Exception as e:
                raise ValueError(
                    f"term {t.name!r} failed to evaluate on a "
                    f"[{self.n_steps} x {self.n_dof_total}] trajectory "
                    f"(was it built with n_dof_total={self.n_dof_total}?)"
                ) from e
            if out[0].numel() != t.n_rows:
                raise ValueError(f"term {t.name!r} declares {t.n_rows} rows "
                                 f"but produces {out[0].numel()}")

    def bounds(self, init_traj: torch.Tensor):
        """Variable bounds (lb, ub) [B, n] for flat trajectories
        ``init_traj [B, n]``: joint limits intersected with fixed pins."""
        B = init_traj.shape[0]
        kw = dict(dtype=init_traj.dtype, device=init_traj.device)
        lo = torch.as_tensor(np.asarray(self.joint_lower, float), **kw)
        hi = torch.as_tensor(np.asarray(self.joint_upper, float), **kw)
        lb = lo.expand(B, self.n_steps, self.n_dof).clone()
        ub = hi.expand(B, self.n_steps, self.n_dof).clone()
        if self.use_time:
            col = (B, self.n_steps, 1)
            lb = torch.cat([lb, torch.full(col, self.dt_lower, **kw)], -1)
            ub = torch.cat([ub, torch.full(col, self.dt_upper, **kw)], -1)
        x0 = init_traj.reshape(B, self.n_steps, self.n_dof_total)
        for t in self.fixed_steps:
            lb[:, t, :self.n_dof] = x0[:, t, :self.n_dof]
            ub[:, t, :self.n_dof] = x0[:, t, :self.n_dof]
        for j in self.fixed_dofs:
            lb[:, :, j] = x0[:, :, j]
            ub[:, :, j] = x0[:, :, j]
        return lb.reshape(B, -1), ub.reshape(B, -1)

    def make_solve(self, sqp: SQPParams = SQPParams(), callback=None,
                   structured: bool = False, device=None):
        """Returns ``solve(init_traj, params) -> SQPResult`` over a batch:
        ``init_traj [B, n_steps, n_dof_total]`` (or ``[B, n]``), ``params``
        a dict of per-lane arrays or tuples of them, such as an ``(R, p)``
        pose target (``"restart_inits"`` among them: a multi-start family,
        see ``make_solver``).  Runs on ``device``, else
        the problem's device, else CUDA (raising when there is none);
        float32 on the card, float64 on the CPU.  ``structured=True`` solves
        the QPs on the block-banded path (needs banded Jacobians on every
        constraint and penalty set), the default on the dense path;
        ``callback`` is the solver's per-iteration callback
        (``callbacks.py``)."""
        nlp = self.build()
        solver = make_solver(nlp, sqp=sqp, callback=callback,
                             structured=structured)
        dev = resolve_device(device if device is not None else self.device)
        dtype = resolve_dtype(dev)

        def solve(init_traj, params=None) -> SQPResult:
            x0 = torch.as_tensor(init_traj, dtype=dtype, device=dev)
            x0 = x0.reshape(x0.shape[0], -1)
            p = {k: tuple(torch.as_tensor(e, dtype=dtype, device=dev)
                          for e in v) if isinstance(v, tuple)
                 else torch.as_tensor(v, dtype=dtype, device=dev)
                 for k, v in (params or {}).items()}
            lb, ub = self.bounds(x0)
            return solver(x0, lb, ub, p)

        return solve


def _append_dt(traj, dt: float | None):
    if dt is None:
        return traj
    return torch.cat([traj, torch.full_like(traj[..., :1], 1.0 / dt)], -1)


def stationary_init(current, n_steps: int, dt: float | None = None):
    """InitInfo::STATIONARY: the current state ``[..., n_dof]`` repeated
    over ``[..., n_steps, n_dof]`` (plus the 1/dt column when ``dt`` is
    given)."""
    current = torch.as_tensor(current)
    traj = current[..., None, :].expand(*current.shape[:-1], n_steps,
                                        current.shape[-1])
    return _append_dt(traj.clone(), dt)


def interpolated_init(start, end, n_steps: int, dt: float | None = None):
    """InitInfo::JOINT_INTERPOLATED: linspace start -> end.  ``start`` and
    ``end`` are ``[..., n_dof]`` tensors; returns ``[..., n_steps, n_dof]``
    (plus the 1/dt column when ``dt`` is given)."""
    w = torch.linspace(0.0, 1.0, n_steps, dtype=start.dtype,
                       device=start.device)[:, None]
    traj = start[..., None, :] * (1.0 - w) + end[..., None, :] * w
    return _append_dt(traj, dt)


def given_init(traj, dt: float | None = None):
    """InitInfo::GIVEN_TRAJ: the caller's ``[..., n_steps, n_dof]``
    trajectory as it is (plus the 1/dt column when ``dt`` is given)."""
    return _append_dt(torch.as_tensor(traj), dt)
