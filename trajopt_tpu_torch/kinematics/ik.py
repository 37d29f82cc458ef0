"""Damped-least-squares inverse kinematics on batched configurations.

Counterpart of ``trajopt_tpu/kinematics/ik.py`` (the role of the external
IK solvers tesseract gives the reference's InverseKinematicsConstraint).
"""

from __future__ import annotations

import torch

from trajopt_tpu_torch.kinematics.chain import KinematicTree
from trajopt_tpu_torch.kinematics.transforms import transform_error


def solve_ik(tree: KinematicTree, link: str, R_target, p_target, q_seed, *,
             damping: float = 1e-2, iters: int = 50, pos_only: bool = False):
    """Iterative DLS IK from ``q_seed [..., n_dof]``: a fixed number of
    steps ``dq = -(J'J + damping I)^-1 J'e``, clamped to the joint limits
    after each.  Returns (q [..., n_dof], |e| [...])."""
    q = torch.as_tensor(q_seed).clone()
    kw = dict(dtype=q.dtype, device=q.device)
    link_id = tree.link_id(link)
    R_t = torch.as_tensor(R_target, **kw)
    p_t = torch.as_tensor(p_target, **kw)
    lower = torch.as_tensor(tree.lower, **kw)
    upper = torch.as_tensor(tree.upper, **kw)
    eye = damping * torch.eye(tree.n_dof, **kw)

    def err(qq):
        R, p = tree.fk(qq)
        e = transform_error(R_t, p_t, R[..., link_id, :, :],
                            p[..., link_id, :])
        return e[..., :3] if pos_only else e

    jac = torch.func.vmap(torch.func.jacfwd(err))
    shape = q.shape
    for _ in range(iters):
        e = err(q)
        J = jac(q.reshape(-1, shape[-1])).reshape(*shape[:-1], -1, shape[-1])
        Jt = J.transpose(-1, -2)
        L = torch.linalg.cholesky(Jt @ J + eye)
        dq = torch.cholesky_solve(-(Jt @ e[..., None]), L)[..., 0]
        q = torch.minimum(torch.maximum(q + dq, lower), upper)
    return q, torch.linalg.vector_norm(err(q), dim=-1)
