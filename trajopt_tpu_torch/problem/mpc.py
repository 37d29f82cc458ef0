"""Receding-horizon (MPC) re-solve on top of the batched solver.

Counterpart of ``trajopt_tpu/problem/mpc.py`` (the reference's online
re-planning with GIVEN_TRAJ warm starts): ``step`` advances every lane's
horizon by one step (the executed step drops off, the last state
repeats), keeps the new start state pinned, and re-solves warm-started.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trajopt_tpu_torch.problem.trajectory import (TrajOptProblem,
                                                  interpolated_init)
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import SQPResult


class MpcState(NamedTuple):
    traj: torch.Tensor   # [B, n_steps, n_dof_total] current plans
    last: SQPResult | None


def make_mpc_step(prob: TrajOptProblem, sqp: SQPParams = SQPParams(),
                  structured: bool = False,
                  reinit_goal_key: str | None = None, device=None):
    """Returns ``step(traj [B, n_steps, n_dof_total], params) ->
    (new_traj [B, n_steps, n_dof_total], SQPResult)`` on ``device`` (None:
    the problem's device).  fixed_steps should include 0 so the new start
    state is pinned; ``structured`` solves on the block-banded QP path.

    ``reinit_goal_key`` (e.g. ``"goal"``): lanes whose solve did not
    converge hand the next cycle a fresh straight line from their pinned
    start state to ``params[key]`` instead of their diverged iterate (the
    GIVEN_TRAJ re-seed); without it a diverged plan poisons every later
    warm start."""
    solve = prob.make_solve(sqp, structured=structured, device=device)
    n_steps = prob.n_steps

    def step(traj, params):
        traj = torch.as_tensor(traj)
        traj = traj.reshape(traj.shape[0], n_steps, -1)
        shifted = torch.cat([traj[:, 1:], traj[:, -1:]], 1)
        res = solve(shifted, params)
        new_traj = res.x.reshape(traj.shape[0], n_steps, -1)
        if reinit_goal_key is not None:
            shifted = shifted.to(new_traj)
            goal = torch.as_tensor(params[reinit_goal_key]).to(new_traj)
            fresh = interpolated_init(shifted[:, 0, :goal.shape[-1]], goal,
                                      n_steps)
            if fresh.shape[-1] < new_traj.shape[-1]:   # use_time dt column
                fresh = torch.cat([fresh, shifted[..., fresh.shape[-1]:]],
                                  -1)
            ok = (res.status == SQPStatus.CONVERGED)[:, None, None]
            new_traj = torch.where(ok, new_traj, fresh)
        return new_traj, res

    return step
