"""Training artifacts: comparison grids and the PSNR/SSIM rating curve, the
port's own copy of ``srgan_tpu/utils/plotting.py``.

Parity with the reference's visual validation (``validate``,
``src/train.py:233-260``: per-sample [upscaled-LR | SR | HR] rows composed
into a padded grid PNG) and its matplotlib rating curve with PSNR scaled by
1/30 to share the SSIM axis (``src/train.py:118,127-137``). The arrays are
numpy (NHWC); PIL and matplotlib are imported only where a file is drawn.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from srgan_tpu_torch.utils.image_io import array_to_image


def comparison_grid(
    lr_up: np.ndarray, sr: np.ndarray, hr: np.ndarray, padding: int = 5
) -> np.ndarray:
    """NHWC batches → one HWC grid: each row is [LR↑ | SR | HR]
    (``make_grid(nrow=1, padding=5)``, ``src/train.py:255``)."""
    lr_up, sr, hr = (np.clip(np.asarray(a), 0, 1) for a in (lr_up, sr, hr))
    rows = [np.concatenate([lr_up[i], sr[i], hr[i]], axis=1) for i in range(len(sr))]
    h, w, c = rows[0].shape
    p = padding
    grid = np.zeros(((h + p) * len(rows) + p, w + 2 * p, c), np.float32)
    for i, row in enumerate(rows):
        grid[p + i * (h + p) : p + i * (h + p) + h, p : p + w] = row
    return grid


def save_comparison(
    lr_up, sr, hr, results_dir: str, prefix: str, epoch: int, rank: int = 0
) -> str:
    """Save the comparison grid with the reference's file naming
    (``results/{desc}_epoch_{E}_{rank}_comparison.png``,
    ``src/train.py:256``)."""
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(
        results_dir, f"{prefix}_epoch_{epoch + 1}_{rank}_comparison.png"
    )
    array_to_image(comparison_grid(lr_up, sr, hr)).save(path)
    return path


def save_rating_curve(
    epochs: Sequence[int],
    psnrs: Sequence[float],
    ssims: Sequence[float],
    results_dir: str,
    prefix: str,
    rank: int = 0,
) -> str:
    """PSNR/30 + SSIM vs epoch (``src/train.py:127-137``, including the /30
    axis-sharing quirk and the file naming)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    os.makedirs(results_dir, exist_ok=True)
    plt.figure(figsize=(10, 6))
    plt.plot(epochs, [p / 30.0 for p in psnrs], marker="o", linestyle="-",
             color="b", label="PNSR/30")
    plt.plot(epochs, ssims, marker="o", linestyle="--", color="r", label="SSIM")
    plt.title("Rating Curve")
    plt.xlabel("Epoch")
    plt.ylabel("Rating Value")
    plt.legend()
    plt.grid(True)
    path = os.path.join(results_dir, f"{prefix}training_loss_curve_{rank}.png")
    plt.savefig(path)
    plt.close()
    return path
