"""Device ms a training step in NCCL kernels on rank 0 (``groups.py``'s
nccl group): the gradient all-reduce, the loss totals' all-gathers, the
averaged loss scalars and the collective stop's flag, whether or not other
kernels run beside them."""

from h100bench.groups import group_of


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    spent = sum(t1 - t0 for name, t0, t1 in run.events if group_of(name) == "nccl")
    return 1e3 * spent / run.steps if spent > 0.0 else None
