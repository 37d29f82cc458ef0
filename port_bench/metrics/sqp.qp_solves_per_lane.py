"""QP solves per lane over the window."""


def read(run):
    if not run.lanes:
        return None
    return sum(run.qp_sum) / sum(run.lanes)
