"""The 90th percentile of the window's batch wall times (hand-over of the
goals to the synchronised swept check), in ms."""

import numpy as np


def read(run):
    if not run.walls:
        return None
    return float(np.percentile(run.walls, 90)) * 1e3
