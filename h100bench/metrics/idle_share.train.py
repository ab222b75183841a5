"""Share of the traced training window in which no device operation ran:
1 − the union of the kernel and memcpy intervals over the window."""


def read(run):
    if run.kind != "train" or not run.events:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)
