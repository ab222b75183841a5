"""Share of the training window's wall spent outside ``Trainer.train_epoch``
(epoch ends: the pool's ``end_epoch``, ``compute_score``, and the stop's
snapshot), on the host clock around the harness's wrapper."""


def read(run):
    if run.kind != "train":
        return None
    return 100.0 * (run.window_s - run.train_epoch_s) / run.window_s
