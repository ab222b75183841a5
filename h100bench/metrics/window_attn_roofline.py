"""The windowed attention's share of its roofline: the least time of the
window's attention work (``work.py``'s ``window_attn_min_s``: each
forward's and backward's FLOPs over the peak or bytes over HBM's
bandwidth, whichever is longer, from the architecture's ``train_ops`` and
``forward_ops``) over the device time of every ``window_attn_*`` launch."""


def read(run):
    if run.kind != "train" or not run.events:
        return None
    need = run.work.get("window_attn_min_s", 0.0)
    spent = sum(t1 - t0 for name, t0, t1 in run.events if "window_attn_" in name)
    if need <= 0.0 or spent <= 0.0:
        return None
    return 100.0 * need / spent
