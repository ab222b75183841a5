"""Host-side image datasets: folder scan, decode, corrupt-file skipping —
the counterpart of ``srgan_tpu/data/dataset.py``.

The host decodes and resizes each image to the canonical HR clip size with
PIL's bicubic filter, as uint8, or with the native C++ codec
(``srgan_tpu_torch.native``, PIL-parity resampling, GIL-free) where its
library builds; the LR degradation runs batched on the device
(``ops.resize``). PIL is imported only when an image is decoded, so the
module imports where PIL is missing. A dataset is anything with
``hr_size``, ``__len__`` and ``load_u8(idx)`` (HWC uint8, or None for a
corrupt file): ``ImageFolderDataset`` reads a folder, ``ArrayDataset``
serves clips already in memory. ``PairedImageDataset`` pairs two folders
(LR and HR) for evaluation.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

IMAGE_EXTENSIONS = ("jpg", "jpeg", "png", "JPG")  # ``src/utils.py:27``


def list_image_files(folder: str) -> List[str]:
    return sorted(
        f for f in os.listdir(folder) if f.endswith(IMAGE_EXTENSIONS)
    )


def load_image_rgb(path: str) -> Optional[np.ndarray]:
    """Decode an image to HWC uint8 RGB; None on corrupt/unreadable files."""
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    except (UnidentifiedImageError, OSError):
        return None


def native_available() -> bool:
    """Whether the native codec's library is built (building it once a
    process where it is missing)."""
    from srgan_tpu_torch import native

    return native.available()


def load_hr_clip_u8(path: str, hr_size: Tuple[int, int]) -> Optional[np.ndarray]:
    """Decode + PIL bicubic resize to (height, width), HWC uint8 (reference
    ``normalize_img_size``, ``src/transformers.py:79-82``); None on
    corrupt/unreadable files. Through the native codec where it is built,
    else PIL."""
    if native_available():
        from srgan_tpu_torch import native

        return native.load_image_u8(path, hr_size[0], hr_size[1])
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(path) as img:
            img = img.convert("RGB")
            h, w = hr_size
            img = img.resize((w, h), Image.BICUBIC)
            return np.asarray(img, dtype=np.uint8)
    except (UnidentifiedImageError, OSError):
        return None


class ImageFolderDataset:
    """Single-folder dataset of canonical HR clips."""

    def __init__(self, folder_path: str, hr_size: Tuple[int, int] = (512, 1024)):
        self.folder_path = folder_path
        self.hr_size = tuple(hr_size)
        self.image_files = list_image_files(folder_path)

    def __len__(self) -> int:
        return len(self.image_files)

    def path(self, idx: int) -> str:
        return os.path.join(self.folder_path, self.image_files[idx])

    def load_u8(self, idx: int) -> Optional[np.ndarray]:
        return load_hr_clip_u8(self.path(idx), self.hr_size)

    def __getitem__(self, idx: int) -> Optional[np.ndarray]:
        """HWC float32 in [0, 1] (the uint8 clip / 255), or None."""
        img = self.load_u8(idx)
        return None if img is None else img.astype(np.float32) / 255.0


class ArrayDataset:
    """Clips already decoded: a (N, H, W, 3) uint8 array."""

    def __init__(self, clips_u8: np.ndarray):
        if clips_u8.dtype != np.uint8 or clips_u8.ndim != 4:
            raise ValueError("expected a (N, H, W, C) uint8 array")
        self.clips = clips_u8
        self.hr_size = tuple(clips_u8.shape[1:3])

    def __len__(self) -> int:
        return len(self.clips)

    def load_u8(self, idx: int) -> np.ndarray:
        return self.clips[idx]


class PairedImageDataset:
    """Two parallel folders of already-paired LR/HR images for evaluation
    (reference ``ImageDataset``, ``src/utils.py:50-90``): equal counts
    asserted; a pair with a corrupt file is None."""

    def __init__(self, folder_path: str, path1: str, path2: str):
        self.dir1 = os.path.join(folder_path, path1)
        self.dir2 = os.path.join(folder_path, path2)
        self.files1 = list_image_files(self.dir1)
        self.files2 = list_image_files(self.dir2)
        assert len(self.files1) == len(self.files2), (
            "the sizes have to be the same!!!"  # ``src/utils.py:66``
        )

    def __len__(self) -> int:
        return len(self.files1)

    def __getitem__(self, idx: int):
        """(img1, img2) as HWC float32 in [0, 1], or None if either image
        is corrupt."""
        a = load_image_rgb(os.path.join(self.dir1, self.files1[idx]))
        b = load_image_rgb(os.path.join(self.dir2, self.files2[idx]))
        if a is None or b is None:
            return None
        return a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0


def split_indices(
    n: int, split_ratio: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded random split of ``range(n)`` (the reference's unseeded 70/30
    ``random_split``, ``src/train.py:82-87``, made reproducible)."""
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(split_ratio * n)
    return perm[:cut], perm[cut:]
