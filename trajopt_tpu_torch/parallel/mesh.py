"""Multi-device scaling: split batched solves over the visible devices.

Counterpart of ``trajopt_tpu/parallel/mesh.py``.  The reference's
parallelism is OpenMP term-parallelism inside one solve
(``optimizers.cpp:261-339``); here, as in the JAX package, it is data
parallelism over independent problems: the batch is cut into contiguous
chunks, one per device, each chunk is solved on its device (one host
thread each when there are several), and the results are gathered onto
the first device.  The
solves exchange nothing, so the split result equals the unsplit one lane
for lane.  Torch has no ``Mesh``: :func:`data_parallel_mesh` keeps the
name so that a reader finds the counterpart, and returns a device list.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Any

import torch

from trajopt_tpu_torch import default_device
from trajopt_tpu_torch.problem.trajectory import TrajOptProblem
from trajopt_tpu_torch.sqp.params import SQPParams, SQPStatus
from trajopt_tpu_torch.sqp.solver import SQPResult
from trajopt_tpu_torch.utils import to_numpy


def data_parallel_mesh(devices=None) -> list[torch.device]:
    """The devices a batch is split over: ``devices`` as torch devices, by
    default every visible CUDA device (raising when there is none)."""
    if devices is None:
        default_device()
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _lanes(tree, sl: slice, dev):
    if isinstance(tree, tuple):
        return tuple(_lanes(t, sl, dev) for t in tree)
    if isinstance(tree, dict):
        return {k: _lanes(v, sl, dev) for k, v in tree.items()}
    return torch.as_tensor(tree)[sl].to(dev)


def make_sharded_batch_solver(prob: TrajOptProblem, devices=None,
                              sqp: SQPParams = SQPParams(),
                              structured: bool = True):
    """Returns ``solve(inits [B, T, D], params) -> SQPResult`` whose lanes
    are split into ``len(devices)`` contiguous chunks, each solved on its
    device, gathered onto the first device.  ``params`` holds per-lane
    entries with a leading ``B`` axis; B must divide by the device count.
    """
    devices = data_parallel_mesh(devices)
    solves = [prob.make_solve(sqp, structured=structured, device=d)
              for d in devices]

    def sharded_solve(inits, params: Any = None) -> SQPResult:
        B, k = int(inits.shape[0]), len(devices)
        if B % k:
            raise ValueError(f"batch {B} does not divide over {k} devices")
        c = B // k

        def run(i):
            sl, dev = slice(i * c, (i + 1) * c), devices[i]
            # the kernels launch on the current device's stream
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                return solves[i](_lanes(inits, sl, dev),
                                 _lanes(params or {}, sl, dev))

        if k == 1:
            parts = [run(0)]
        else:
            with concurrent.futures.ThreadPoolExecutor(k) as pool:
                parts = list(pool.map(run, range(k)))
        return SQPResult(*(torch.cat([f.to(devices[0]) for f in fields])
                           for fields in zip(*parts)))

    return sharded_solve



def summarize(result) -> dict:
    """Host-side metrics: converged fraction, iteration stats (the
    per-problem analog of OptResults counters, optimizers.hpp:40-59)."""
    status = to_numpy(result.status)
    return {
        "n": int(status.size),
        "converged": int((status == SQPStatus.CONVERGED).sum()),
        "converged_frac": float((status == SQPStatus.CONVERGED).mean()),
        "mean_iter": float(to_numpy(result.n_iter).mean()),
        "mean_qp_solves": float(to_numpy(result.n_qp_solves).mean()),
        "max_cnt_viol": float(to_numpy(result.cnt_viols).max(initial=0.0)),
    }
