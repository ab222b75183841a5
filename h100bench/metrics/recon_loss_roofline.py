"""The loss kernels' share of their roofline: for each K1, K2 and K3 launch
in the window, the bytes it has to move at the step's shape
(``work.recon_loss_bytes``) over HBM's bandwidth, summed, over the device
time of every loss-kernel launch (kernels, totals stages, finalises)."""

from h100bench.groups import LOSS_KERNEL_RE, LOSS_PART
from h100bench.work import PEAK_BYTES_S, recon_loss_bytes


def read(run):
    if run.kind != "train":
        return None
    loss = [e for e in run.events if LOSS_KERNEL_RE.search(e[0])]
    spent = sum(t1 - t0 for _, t0, t1 in loss)
    if spent <= 0.0:
        return None
    per = recon_loss_bytes(*run.loss_shape)
    need = sum(per[k] for name, _, _ in loss for k, rx in LOSS_PART if rx.search(name))
    return 100.0 * need / PEAK_BYTES_S / spent
