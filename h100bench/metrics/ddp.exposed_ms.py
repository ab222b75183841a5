"""Device ms a training step on rank 0 in which an NCCL kernel runs and no
other kernel or copy does: the collectives' time that no compute hides,
the union of every operation's intervals less the union of the others'."""

from h100bench.groups import busy_seconds, group_of


def read(run):
    if run.kind != "train" or not run.steps:
        return None
    if not any(group_of(name) == "nccl" for name, _, _ in run.events):
        return None
    t0, t1 = min(e[1] for e in run.events), max(e[2] for e in run.events)
    others = [e for e in run.events if group_of(e[0]) != "nccl"]
    exposed = busy_seconds(run.events, t0, t1) - busy_seconds(others, t0, t1)
    return 1e3 * exposed / run.steps
