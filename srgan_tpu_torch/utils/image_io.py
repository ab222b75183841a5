"""Host-side image IO helpers (PIL ↔ numpy arrays), the port's own copy of
``srgan_tpu/utils/image_io.py``. PIL is imported only where an image is
made or decoded, so the module imports where PIL is missing."""

from __future__ import annotations

import numpy as np


def array_to_image(arr):
    """HWC float array in [0, 1] → PIL image (clamped).

    The working replacement for the reference's ``tensor_to_image``
    (``src/utils.py:94-99``) — that helper de-normalizes with ``*0.5+0.5``
    although the training range is [0, 1] (SURVEY.md appendix); this uses
    the pipeline's actual [0, 1] range.
    """
    from PIL import Image

    arr = np.asarray(arr)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, 0.0, 1.0)
    return Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))


def load_image(path: str) -> np.ndarray:
    """Decode an image to HWC float32 in [0, 1] — the working version of the
    reference's stub ``load_image`` (``src/utils.py:169-170``)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def save_image(arr, path: str) -> None:
    array_to_image(arr).save(path)
