"""Independent trajectory collision checker for verification.

Counterpart of ``trajopt_tpu/collision/check.py`` (the role of
``checkTrajectory`` in the reference's end-to-end tests): after
optimizing, check the result with a dense interpolated sweep that does not
depend on the evaluator used during the optimization.  The JAX function
checks one trajectory, one state at a time on the host; here every state
of every lane goes through one ``distances`` call.
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.collision.world import CollisionScene


def check_trajectory(scene: CollisionScene, traj, margin: float = 0.0,
                     substeps: int = 20, params=None):
    """(ok, min_distance): ``ok`` iff every state interpolated at
    ``substeps`` fractions ``i / substeps`` of each gap, plus the last
    state, keeps every pair distance above ``margin``.  ``traj`` is one
    trajectory ``[n_steps, n_dof]`` (returns a bool and a float) or a batch
    ``[B, n_steps, n_dof]`` (returns bool and distance tensors [B]).
    ``params`` supplies the centers of ``center_param`` world geometry
    (``[3]``, or ``[B, 3]`` per lane of a batch)."""
    traj = torch.as_tensor(traj)
    single = traj.dim() == 2
    if single:
        traj = traj[None]
    fr = torch.as_tensor(np.linspace(0.0, 1.0, substeps, endpoint=False),
                         dtype=traj.dtype, device=traj.device)
    a, b = traj[:, :-1], traj[:, 1:]
    qs = a[:, :, None, :] + fr[:, None] * (b - a)[:, :, None, :]
    qs = torch.cat([qs.reshape(traj.shape[0], -1, traj.shape[-1]),
                    traj[:, -1:]], 1)
    with torch.no_grad():
        d = scene.distances(scene.tree.fk(qs), params)
    dmin = torch.amin(d.reshape(d.shape[0], -1), -1)
    if single:
        return bool(dmin[0] > margin), float(dmin[0])
    return dmin > margin, dmin
