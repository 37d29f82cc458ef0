"""Set-up seconds: process start (imports, CUDA init, kernel builds in a
fresh checkout, problem build) through the warm-up batches."""


def read(run):
    return run.setup_s
