"""The most QP solves any lane of a batch made (the host loop passes the
batch runs), averaged over the window's batches."""


def read(run):
    if not run.qp_max:
        return None
    return sum(run.qp_max) / len(run.qp_max)
