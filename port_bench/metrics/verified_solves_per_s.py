"""Lanes converged and passed by the port's swept check, summed over the
window's batches, per second of the window."""


def read(run):
    if not run.window_s:
        return None
    return sum(run.verified) / run.window_s
