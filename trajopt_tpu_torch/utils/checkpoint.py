"""Checkpoint / resume for solver results and warm starts.

Counterpart of ``trajopt_tpu/utils/checkpoint.py``, with the same npz
keys (``result__<field>``, ``extra__<key>``, ``trajs``, ``param__<key>``),
so a file written by either package loads in the other.  The reference has
no checkpointing; its closest analogs are GIVEN_TRAJ warm starts and QP
warm starts, so a checkpoint is npz serialization plus a GIVEN_TRAJ
restart: batched MPC runs resume mid-stream.  Loaded arrays come back as
CPU tensors.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trajopt_tpu_torch.sqp.solver import SQPResult
from trajopt_tpu_torch.utils import to_numpy



def save_result(path: str, result: SQPResult, extra: dict | None = None):
    data = {f"result__{k}": to_numpy(v) for k, v in result._asdict().items()}
    for k, v in (extra or {}).items():
        data[f"extra__{k}"] = to_numpy(v)
    np.savez_compressed(path, **data)


def load_result(path: str) -> tuple[SQPResult, dict]:
    z = np.load(path)
    fields = {k.split("__", 1)[1]: torch.as_tensor(z[k]) for k in z.files
              if k.startswith("result__")}
    extra = {k.split("__", 1)[1]: torch.as_tensor(z[k]) for k in z.files
             if k.startswith("extra__")}
    return SQPResult(**{f: fields[f] for f in SQPResult._fields}), extra


def save_trajectories(path: str, trajs, params: Any = None):
    data = {"trajs": to_numpy(trajs)}
    if params is not None:
        for k, v in params.items():
            data[f"param__{k}"] = to_numpy(v)
    np.savez_compressed(path, **data)


def load_trajectories(path: str):
    z = np.load(path)
    params = {k.split("__", 1)[1]: torch.as_tensor(z[k]) for k in z.files
              if k.startswith("param__")}
    return torch.as_tensor(z["trajs"]), params
