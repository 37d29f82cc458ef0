"""Postmortem dump of failed solves -- the /tmp/fail.lp analog.

Counterpart of ``trajopt_tpu/utils/debug.py``.  The reference writes the
convex model of a failed QP to /tmp/fail.lp for offline inspection
(optimizers.cpp:821).  Here the dump runs after a batched solve: given the
returned SQPResult, each failed lane is re-convexified at its final iterate
and the full QP data (P, q, A, l, u, c rows + iterate + statuses) is
written as an .npz that any QP solver can replay, under the JAX package's
keys.
"""

from __future__ import annotations

import numpy as np
import torch

from trajopt_tpu_torch.sqp import nlp as nlp_mod
from trajopt_tpu_torch.sqp.params import SQPStatus
from trajopt_tpu_torch.utils import to_numpy



def dump_failed_qps(nlp, result, params, path: str,
                    statuses=(SQPStatus.FAILED,)) -> int:
    """Write one npz with the convexified QP at every failed lane.

    ``result`` is an SQPResult (batched, or one lane without the lane
    axis); ``params`` the matching params dict.  Returns the number of
    lanes dumped (0 writes nothing).  Usage::

        res = solve(inits, {"goal": goals})
        n_bad = dump_failed_qps(prob.build(), res, {"goal": goals},
                                "trajopt_fail.npz")

    Per-lane slicing rule (the JAX package's, after ``jax.vmap``'s default
    in_axes=0): a params leaf whose leading dimension equals the lane count
    is indexed per lane; any other leaf is passed whole.  A lane-invariant
    leaf whose first dimension happens to equal the batch size is
    mis-sliced -- pre-slice such params and pass one lane's result instead.
    The lane is convexified on the result's device and dtype.
    """
    status = np.atleast_1d(to_numpy(result.status))
    x_all = torch.as_tensor(result.x)
    x_all = x_all.reshape(-1, x_all.shape[-1])
    bad = np.isin(status, np.asarray([int(s) for s in statuses]))
    idx = np.nonzero(bad)[0]
    if idx.size == 0:
        return 0

    def lane(a, i):
        if np.ndim(a) >= 1 and np.shape(a)[0] == status.size:
            a = a[i]
        a = torch.as_tensor(a, device=x_all.device)
        return a.to(x_all.dtype) if a.is_floating_point() else a

    def lane_params(i):
        p = {k: tuple(lane(e, i) for e in v) if isinstance(v, tuple)
             else lane(v, i) for k, v in (params or {}).items()}
        return nlp_mod.one_lane(p)

    merit = np.atleast_2d(to_numpy(result.merit_coeffs))
    blobs = {}
    for i in idx:
        p_i = lane_params(int(i))
        x_i = x_all[i][None]
        jac_cache = nlp_mod.linear_jacobians(nlp, x_i, p_i)
        m = nlp_mod.convexify(nlp, x_i, p_i, jac_cache)
        for field in ("P", "q", "c0", "A_cost", "b_cost", "w_cost",
                      "A_cnt", "b_cnt", "l_cnt", "u_cnt"):
            blobs[f"lane{i}_{field}"] = to_numpy(getattr(m, field)[0])
        blobs[f"lane{i}_x"] = to_numpy(x_all[i])
        blobs[f"lane{i}_status"] = status[i]
        blobs[f"lane{i}_merit_coeffs"] = merit[i]
    blobs["failed_lanes"] = idx
    np.savez_compressed(path, **blobs)
    return int(idx.size)
