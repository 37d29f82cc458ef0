"""Utilities: configuration, cache, checkpoints, failed-QP dumps, finite
differences, joint subsets, logging and profiling."""

import numpy as np
import torch


def to_numpy(v) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)
