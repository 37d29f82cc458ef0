"""Observability: per-iteration callbacks, merit tables, CSV iteration logs.

Counterpart of ``trajopt_tpu/callbacks.py`` (the reference's
``callCallbacks()`` per SQP iteration, ``SQPCallback::execute`` and its
``STOPPED_BY_CALLBACK`` abort, the results merit table and the
``WriteCallback`` CSV logs).

The solver calls its ``callback`` at the top of each SQP pass with the live
lanes' ``(total_iter [L], x [L, n], cost_vals, cnt_viols, merit_coeffs,
box_size [L])``, live lanes in lane order; a callback returns None or a
per-lane stop mask [L].  :func:`make_iteration_callback` and
:func:`make_stopping_callback` turn a host function of one
:class:`IterationSnapshot` into such a callback: they call it once per live
lane, in lane order, with that lane's numpy snapshot (what the JAX
callback sees for that lane).  Each copies the live lanes to the host, so
a solve with one of them syncs once more per pass; a solve without a
callback does not.

The plotters (``JointStatePlotter``, ``CollisionPlotter``,
``CartesianErrorPlotter``, ``ClearPlotter``; the reference's trajopt_sqp
callback plotters) are host functions of one snapshot like the others;
they import matplotlib (optional, Agg backend) only when they draw.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Callable, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class IterationSnapshot:
    """What a host callback sees each SQP iteration, for one lane."""

    iteration: int
    x: np.ndarray
    cost_vals: np.ndarray
    cnt_viols: np.ndarray
    merit_coeffs: np.ndarray
    box_size: float


def _snapshots(iteration, x, cost_vals, cnt_viols, merit_coeffs, box_size):
    """One snapshot per lane of the batched arguments, in lane order."""
    host = [t.detach().cpu().numpy() for t in
            (iteration, x, cost_vals, cnt_viols, merit_coeffs, box_size)]
    for it, xi, cv, vi, mc, bs in zip(*host):
        yield IterationSnapshot(iteration=int(it), x=xi, cost_vals=cv,
                                cnt_viols=vi, merit_coeffs=mc,
                                box_size=float(bs))


def make_iteration_callback(host_fn: Callable[[IterationSnapshot], None]):
    """A solver callback that calls ``host_fn`` once per live lane (lane
    order) and never stops the solve."""

    def cb(iteration, x, cost_vals, cnt_viols, merit_coeffs, box_size):
        for snap in _snapshots(iteration, x, cost_vals, cnt_viols,
                               merit_coeffs, box_size):
            host_fn(snap)

    return cb


def make_stopping_callback(host_fn: Callable[[IterationSnapshot], bool]):
    """Like :func:`make_iteration_callback`, but the host function's return
    value steers its lane: anything falsy stops that lane with
    ``SQPStatus.STOPPED_BY_CALLBACK`` (SQPCallback::execute semantics; the
    JAX version allows it on a single solve only, here every lane has its
    own answer)."""

    def cb(iteration, x, cost_vals, cnt_viols, merit_coeffs, box_size):
        stop = [not bool(host_fn(snap)) for snap in _snapshots(
            iteration, x, cost_vals, cnt_viols, merit_coeffs, box_size)]
        return torch.as_tensor(stop, dtype=torch.bool, device=x.device)

    return cb


class WaitForInput:
    """Block on stdin each iteration (callbacks/wait_for_input.h); entering
    ``q`` aborts the solve when wrapped in make_stopping_callback."""

    def __init__(self, prompt: str = "Hit enter to continue (q to abort)"):
        self.prompt = prompt

    def __call__(self, snap: IterationSnapshot) -> bool:
        return input(f"[iter {snap.iteration}] {self.prompt}: ").strip() != "q"


def _pyplot():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


class JointStatePlotter:
    """Per-iteration joint-trajectory plot (joint_state_plotter.h): keeps
    the iterate history and, with a ``prefix``, writes
    ``<prefix><iteration>.png``."""

    def __init__(self, n_steps: int, n_dof: int, prefix: str | None = None):
        self.n_steps, self.n_dof = n_steps, n_dof
        self.prefix = prefix
        self.history: list[np.ndarray] = []

    def clear(self) -> None:
        self.history.clear()

    def __call__(self, snap: IterationSnapshot) -> bool:
        traj = snap.x.reshape(self.n_steps, -1)[:, :self.n_dof]
        self.history.append(traj)
        if self.prefix is not None:
            plt = _pyplot()
            fig, ax = plt.subplots()
            for j in range(self.n_dof):
                ax.plot(traj[:, j], label=f"j{j}")
            ax.set_xlabel("timestep")
            ax.set_ylabel("joint value")
            ax.legend(fontsize=6)
            fig.savefig(f"{self.prefix}{snap.iteration:03d}.png", dpi=60)
            plt.close(fig)
        return True


class CollisionPlotter:
    """Per-iteration clearance plot (collision_plotter.h): the minimum
    signed distance per timestep from the scene's narrowphase (in float64
    on the CPU, from the snapshot's numpy iterate)."""

    def __init__(self, scene, n_steps: int, n_dof: int,
                 prefix: str | None = None):
        self.scene, self.n_steps, self.n_dof = scene, n_steps, n_dof
        self.prefix = prefix
        self.history: list[np.ndarray] = []

    def clear(self) -> None:
        self.history.clear()

    def __call__(self, snap: IterationSnapshot) -> bool:
        traj = torch.as_tensor(snap.x.reshape(self.n_steps, -1)[:, :self.n_dof],
                               dtype=torch.float64)
        with torch.no_grad():
            d = self.scene.distances(self.scene.tree.fk(traj)).numpy()
        min_d = d.min(axis=1)
        self.history.append(min_d)
        if self.prefix is not None:
            plt = _pyplot()
            fig, ax = plt.subplots()
            ax.plot(min_d)
            ax.axhline(0.0, color="r", ls="--")
            ax.set_xlabel("timestep")
            ax.set_ylabel("min signed distance")
            fig.savefig(f"{self.prefix}{snap.iteration:03d}.png", dpi=60)
            plt.close(fig)
        return True


class CartesianErrorPlotter:
    """Per-iteration Cartesian error-norm trace
    (cartesian_error_plotter.h); ``err_fn(x) -> error vector``."""

    def __init__(self, err_fn: Callable[[np.ndarray], np.ndarray],
                 path: str | None = None):
        self.err_fn = err_fn
        self.path = path
        self.history: list[float] = []

    def clear(self) -> None:
        self.history.clear()

    def __call__(self, snap: IterationSnapshot) -> bool:
        self.history.append(float(np.linalg.norm(
            np.asarray(self.err_fn(snap.x)))))
        if self.path is not None:
            plt = _pyplot()
            fig, ax = plt.subplots()
            ax.semilogy(self.history)
            ax.set_xlabel("SQP iteration")
            ax.set_ylabel("|cartesian error|")
            fig.savefig(self.path, dpi=60)
            plt.close(fig)
        return True


class ClearPlotter:
    """Clears another plotter's accumulated state each iteration
    (clear_plotter.h)."""

    def __init__(self, plotter):
        self.plotter = plotter

    def __call__(self, snap: IterationSnapshot) -> bool:
        self.plotter.clear()
        return True


def chain(*host_fns):
    """Compose host callbacks; the solve continues only if all agree (the
    reference iterates its callback list and ANDs the results)."""

    def run(snap: IterationSnapshot) -> bool:
        ok = True
        for f in host_fns:
            r = f(snap)
            ok = ok and (r is not False)
        return ok

    return run


def format_merit_table(cost_names: Sequence[str], cost_vals,
                       cnt_names: Sequence[str], cnt_viols,
                       merit_coeffs) -> str:
    """Render the per-iteration cost/constraint merit table
    (BasicTrustRegionSQPResults::print, optimizers.cpp:428-531)."""
    cost_vals = np.atleast_1d(np.asarray(cost_vals))
    cnt_viols = np.atleast_1d(np.asarray(cnt_viols))
    merit_coeffs = np.atleast_1d(np.asarray(merit_coeffs))
    buf = io.StringIO()
    buf.write(f"{'':>28} | {'value':>12}\n")
    buf.write("-" * 44 + "\n")
    for n, v in zip(cost_names, cost_vals):
        buf.write(f"{n[:28]:>28} | {v:12.5g}\n")
    for n, v, m in zip(cnt_names, cnt_viols, merit_coeffs):
        buf.write(f"{(n + ' (viol)')[:28]:>28} | {v:12.5g}  x{m:g}\n")
    total = float(cost_vals.sum() + (merit_coeffs * cnt_viols).sum())
    buf.write("-" * 44 + "\n")
    buf.write(f"{'merit':>28} | {total:12.5g}\n")
    return buf.getvalue()


class CsvLogger:
    """Accumulates per-iteration snapshots and writes CSV files analogous
    to trajopt_solver.log / trajopt_vars.log."""

    def __init__(self):
        self.rows: list[IterationSnapshot] = []

    def __call__(self, snap: IterationSnapshot) -> None:
        self.rows.append(snap)

    def write_solver_log(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("iteration,total_cost,max_viol,box_size\n")
            for s in self.rows:
                max_viol = float(s.cnt_viols.max()) if s.cnt_viols.size else 0.0
                f.write(f"{s.iteration},{s.cost_vals.sum()},"
                        f"{max_viol},{s.box_size}\n")

    def write_vars_log(self, path: str) -> None:
        with open(path, "w") as f:
            for s in self.rows:
                vals = ",".join(str(v) for v in s.x.reshape(-1))
                f.write(f"{s.iteration},{vals}\n")
