"""Small sizes of each cell for runs on the CPU: the same code paths at a
size a test can hold (F=8, one residual block, 64x128 clips, batch 4, a
2-stage discriminator of 8 filters), in fp32 so that the program and the
reference agree to rounding."""

from __future__ import annotations

import types


def flags(gan: bool) -> list:
    out = ["--batch-size", "4", "--hr-height", "64", "--hr-width", "128", "--upscale", "4",
           "--num-features", "8", "--num-residuals", "1", "--validate-every", "0"]
    if gan:
        out += ["--gan", "--num-generators", "3", "--d-stages", "2", "--d-features", "8"]
    return out


def overrides(cell: str) -> dict:
    gan = "pool" in cell
    model = {"num_features": 8, "num_residuals": 1, "compute_dtype": "float32"}
    if "serve" in cell:
        # deeper than the training cells' small model: the fp8 control's gap
        # grows with depth, as it does at the published 16 blocks
        model = {**model, "num_features": 16, "num_residuals": 4}
        fl = flags(False)
        fl[fl.index("--num-features") + 1], fl[fl.index("--num-residuals") + 1] = "16", "4"
        return {"config": {"train_flags": fl, "model": model,
                           "data": {"hr_size": [64, 128], "batch_size": 4}},
                "traffic": {"lr_sizes": [[16, 32, 50], [24, 40, 30], [32, 64, 20]], "cycle": 10,
                            "images_per_size": 2, "sample_from": 12, "sample_extra": 4}}
    cfg = {"train_flags": flags(gan), "model": model,
           "data": {"hr_size": [64, 128], "batch_size": 4}}
    if gan:
        cfg["discriminator"] = {"num_filters": 8, "num_stages": 2, "compute_dtype": "float32"}
    if "ddp" in cell:
        # over 4 ranks: 16 rows a rank after the split, 4 steps an epoch; the
        # window opens before the warm epoch's batch 2, as the cell's mid-epoch
        return {"config": cfg, "traffic": {"train_images": 96, "val_images": 16,
                                           "window_opens_at_batch": 2}}
    return {"config": cfg, "traffic": {"train_images": 40, "val_images": 12}}


def args(cell: str, seed: int = 7, seconds: float = 1.0, trace: int = 0):
    return types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
