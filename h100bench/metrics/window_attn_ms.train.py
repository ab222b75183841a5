"""Device ms a training step in the windowed attention's kernels
(``window_attn_*``: forward, backward and dBias's sum)."""


def read(run):
    if run.kind != "train" or not run.steps or not run.events:
        return None
    spent = sum(t1 - t0 for name, t0, t1 in run.events if "window_attn_" in name)
    return 1e3 * spent / run.steps if spent > 0.0 else None
