"""Training artifacts: comparison grids and the PSNR/SSIM rating curve, the
port's own copy of ``srgan_tpu/utils/plotting.py``.

Parity with the reference's visual validation (``validate``,
``src/train.py:233-260``: per-sample [upscaled-LR | SR | HR] rows composed
into a padded grid PNG) and its rating curve with PSNR scaled by 1/30 to
share the SSIM axis (``src/train.py:118,127-137``). The arrays are numpy
(NHWC). Both files are drawn with PIL, imported only where a file is
drawn: the JAX package draws the curve with matplotlib, which the port does
not need.
"""

from __future__ import annotations

import math
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
    axis-sharing quirk and the file naming), as the JAX package's
    matplotlib figure draws it: 1000x600 px, PSNR/30 solid blue and SSIM
    dashed red, each point marked, a grid, the title, the axis labels and
    the legend. Non-finite values are left out of the curve."""
    from PIL import Image, ImageDraw

    os.makedirs(results_dir, exist_ok=True)
    series = (
        ("PNSR/30", [p / 30.0 for p in psnrs], (0, 0, 255), False),
        ("SSIM", list(ssims), (255, 0, 0), True),
    )
    img = Image.new("RGB", CURVE_SIZE, "white")
    draw = ImageDraw.Draw(img)
    left, top, right, bottom = 80, 50, CURVE_SIZE[0] - 30, CURVE_SIZE[1] - 60
    xs = [float(e) for e in epochs]
    ys = [v for _, vals, _, _ in series for v in vals if math.isfinite(v)]
    x_lo, x_hi = _span(xs)
    y_lo, y_hi = _span(ys)

    def to_px(x, y):
        return (left + (x - x_lo) / (x_hi - x_lo) * (right - left),
                bottom - (y - y_lo) / (y_hi - y_lo) * (bottom - top))

    grey, black = (176, 176, 176), (0, 0, 0)
    for t in range(6):  # grid lines and tick labels
        gx = left + t * (right - left) / 5
        gy = bottom - t * (bottom - top) / 5
        draw.line([(gx, top), (gx, bottom)], fill=grey)
        draw.line([(left, gy), (right, gy)], fill=grey)
        draw.text((gx - 12, bottom + 6), f"{x_lo + t * (x_hi - x_lo) / 5:.3g}",
                  fill=black)
        draw.text((left - 48, gy - 6), f"{y_lo + t * (y_hi - y_lo) / 5:.3g}",
                  fill=black)
    draw.rectangle([left, top, right, bottom], outline=black)
    draw.text(((left + right) / 2 - 36, 18), "Rating Curve", fill=black)
    draw.text(((left + right) / 2 - 16, bottom + 30), "Epoch", fill=black)
    draw.text((8, top - 30), "Rating Value", fill=black)

    for k, (label, vals, color, dashed) in enumerate(series):
        pts = [to_px(x, y) for x, y in zip(xs, vals) if math.isfinite(y)]
        for a, b in zip(pts, pts[1:]):
            _line(draw, a, b, color, dashed)
        for x, y in pts:
            draw.ellipse([x - 4, y - 4, x + 4, y + 4], fill=color)
        ly = top + 14 + 20 * k  # the legend, top right
        _line(draw, (right - 130, ly), (right - 95, ly), color, dashed)
        draw.ellipse([right - 116, ly - 4, right - 108, ly + 4], fill=color)
        draw.text((right - 85, ly - 6), label, fill=black)

    path = os.path.join(results_dir, f"{prefix}training_loss_curve_{rank}.png")
    img.save(path)
    return path


CURVE_SIZE = (1000, 600)  # matplotlib's figsize=(10, 6) at its 100 dpi


def _span(vals):
    """(low, high) of the finite values with a 5 % margin; a unit span
    around a single value, (0, 1) for none."""
    vals = [v for v in vals if math.isfinite(v)]
    if not vals:
        return 0.0, 1.0
    lo, hi = min(vals), max(vals)
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    return lo - pad, hi + pad


def _line(draw, a, b, color, dashed: bool) -> None:
    """A 2 px line from a to b, in 8 px dashes with 5 px gaps if dashed."""
    if not dashed:
        draw.line([a, b], fill=color, width=2)
        return
    length = math.hypot(b[0] - a[0], b[1] - a[1])
    s = 0.0
    while s < length:
        e = min(length, s + 8.0)
        draw.line([(a[0] + (b[0] - a[0]) * s / length, a[1] + (b[1] - a[1]) * s / length),
                   (a[0] + (b[0] - a[0]) * e / length, a[1] + (b[1] - a[1]) * e / length)],
                  fill=color, width=2)
        s += 13.0
