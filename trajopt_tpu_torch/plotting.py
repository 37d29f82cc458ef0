"""Plots of a solve: the convergence dashboard and the joint curves.

Counterpart of ``trajopt_tpu/plotting.py`` (the role of the reference's
``PlotCallback`` and its ``plot_optimization.py`` / ``traj_compare.py``
scripts), drawn with matplotlib's Agg backend.  matplotlib is optional and
imported inside each function; no solver module imports this one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from trajopt_tpu_torch.callbacks import CsvLogger


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_iterations(logger: CsvLogger, path: str, n_steps: int, n_dof: int):
    """Write a convergence dashboard PNG: per-iteration total cost, max
    constraint violation, trust box size, and the trajectory's evolution
    (joint 0 against joint 1) over the logged iterations."""
    plt = _pyplot()
    rows = logger.rows
    if not rows:
        raise ValueError("no iterations logged")
    iters = [s.iteration for s in rows]
    costs = [float(s.cost_vals.sum()) for s in rows]
    viols = [float(s.cnt_viols.max()) if s.cnt_viols.size else 0.0
             for s in rows]
    boxes = [s.box_size for s in rows]

    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    axes[0, 0].plot(iters, costs, marker="o")
    axes[0, 0].set_title("total cost")
    axes[0, 1].semilogy(iters, np.maximum(viols, 1e-12), marker="o")
    axes[0, 1].set_title("max constraint violation")
    axes[1, 0].semilogy(iters, boxes, marker="o")
    axes[1, 0].set_title("trust box size")
    traj_ax = axes[1, 1]
    for k, s in enumerate(rows):
        traj = s.x.reshape(n_steps, -1)[:, :n_dof]
        alpha = min(1.0, 0.2 + 0.8 * (k + 1) / len(rows))
        traj_ax.plot(traj[:, 0], traj[:, 1] if n_dof > 1 else traj[:, 0],
                     alpha=alpha, color="C0")
    traj_ax.set_title("trajectory evolution (dof0 vs dof1)")
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def plot_trajectory_joints(traj, path: str,
                           joint_names: Sequence[str] | None = None):
    """Joint-position curves over time of one trajectory ``[n_steps,
    n_dof]`` (numpy or a tensor)."""
    plt = _pyplot()
    traj = np.asarray(traj.detach().cpu() if hasattr(traj, "detach")
                      else traj)
    fig, ax = plt.subplots(figsize=(8, 5))
    for j in range(traj.shape[1]):
        name = joint_names[j] if joint_names else f"j{j}"
        ax.plot(traj[:, j], label=name)
    ax.set_xlabel("timestep")
    ax.set_ylabel("joint position")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
