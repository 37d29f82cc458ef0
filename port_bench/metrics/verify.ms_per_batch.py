"""Host ms a batch of the port's swept check, from its call to its
synchronised verdict count."""


def read(run):
    if not run.verify_s:
        return None
    return 1e3 * sum(run.verify_s) / len(run.verify_s)
