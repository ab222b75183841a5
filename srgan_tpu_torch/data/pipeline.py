"""Batched host→device input pipeline, the counterpart of
``srgan_tpu/data/pipeline.py`` for one process:

  - PIL decode + bicubic resize to canonical HR clips as uint8 on a thread
    pool (``HostBatcher``);
  - per-epoch reshuffled sampling with the same numpy RNG as the JAX
    package, so the index order is identical (``EpochSampler``);
  - a device-resident dataset cache (``DataConfig.device_cache``): decode
    once, keep the uint8 dataset on the card, and gather every batch there
    — no image bytes cross the host link per step;
  - a streaming path that copies each uint8 batch from pinned memory with
    ``prefetch_depth`` batches in flight;
  - the /255 conversion and LR degradation on the device (``ops.resize``),
    with randomness from a ``torch.Generator`` the caller passes.

Batches have a static shape (drop-remainder). The constructor takes a
folder or a ready dataset object (``data.dataset``).
"""

from __future__ import annotations

import collections
import concurrent.futures as futures
import sys
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from srgan_tpu_torch.config import DataConfig
from srgan_tpu_torch.data.dataset import ImageFolderDataset, split_indices
from srgan_tpu_torch.ops.resize import gather_prepare_batch, prepare_batch
from srgan_tpu_torch.utils.platform import resolve_device


class EpochSampler:
    """Per-epoch reshuffled index sampler (``DistributedSampler(shuffle=
    True)`` + ``set_epoch`` on one process): every epoch draws a
    permutation seeded by (seed, epoch), the JAX package's numpy RNG."""

    def __init__(self, indices: Sequence[int], *, seed: int = 0):
        self.indices = np.asarray(indices)
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        perm = np.random.default_rng((self.seed, epoch)).permutation(
            len(self.indices)
        )
        return self.indices[perm]


class HostBatcher:
    """Decode + batch assembly of HR clips (NHWC uint8 numpy) on a pool of
    ``num_workers`` threads."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pool = futures.ThreadPoolExecutor(max_workers=max(1, num_workers))

    def decode_many(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """Decode any number of images → (uint8 array, ok mask)."""
        h, w = self.dataset.hr_size
        out = np.zeros((len(indices), h, w, 3), np.uint8)
        ok = np.zeros(len(indices), bool)

        def work(k):
            img = self.dataset.load_u8(int(indices[k]))
            if img is not None:
                out[k] = img
                ok[k] = True

        list(self.pool.map(work, range(len(indices))))
        return out, ok

    def batches(self, indices: np.ndarray) -> Iterator[np.ndarray]:
        n_full = len(indices) // self.batch_size
        last_good = None
        for b in range(n_full):
            chunk = indices[b * self.batch_size : (b + 1) * self.batch_size]
            batch, ok = self.decode_many(chunk)
            if not ok.any():
                # keep the batch count: repeat the previous good batch
                print(
                    f"warning: batch {b}: all {len(chunk)} files failed to "
                    "decode; repeating previous batch",
                    file=sys.stderr,
                )
                yield (last_good if last_good is not None
                       else np.zeros_like(batch))
                continue
            if not ok.all():
                # corrupt-file skip with static shapes: refill bad slots
                good = np.flatnonzero(ok)
                for bad in np.flatnonzero(~ok):
                    batch[bad] = batch[good[bad % len(good)]]
            last_good = batch
            yield batch

    def close(self):
        self.pool.shutdown(wait=False)


def _device_prefetch(
    iterator: Iterator[np.ndarray], depth: int, device: torch.device
) -> Iterator[torch.Tensor]:
    """Keep ``depth`` batches in flight to the device."""
    queue: collections.deque = collections.deque()
    for batch in iterator:
        t = torch.from_numpy(batch)
        if device.type == "cuda":
            t = t.pin_memory()
        queue.append(t.to(device, non_blocking=True))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class DeviceCacheBudget:
    """Shared device-memory accounting for ``device_cache="auto"``
    pipelines: the train pipeline reserves first, the validation pipeline
    caches only with what is left."""

    def __init__(self, total_bytes: int):
        self.remaining = int(total_bytes)

    def try_reserve(self, nbytes: int) -> bool:
        if nbytes <= self.remaining:
            self.remaining -= nbytes
            return True
        return False


class TrainPipeline:
    """End-to-end training input pipeline: yields (hr, lr) device batches,
    NHWC float32."""

    def __init__(
        self,
        cfg: DataConfig,
        data,
        *,
        use_split: bool = True,
        seed: int = 0,
        device=None,
        cache_budget: "DeviceCacheBudget | None" = None,
        augment: "bool | None" = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        # validation pipelines pass augment=False: scoring sees the images
        self.augment = cfg.augment_flips if augment is None else augment
        self.dataset = (
            ImageFolderDataset(data, cfg.hr_size) if isinstance(data, str)
            else data
        )
        if tuple(self.dataset.hr_size) != tuple(cfg.hr_size):
            raise ValueError(
                f"dataset clips are {self.dataset.hr_size}, the config asks "
                f"for {cfg.hr_size}"
            )
        if use_split and cfg.split_ratio < 1.0:
            train_idx, _ = split_indices(
                len(self.dataset), cfg.split_ratio, cfg.split_seed
            )
        else:
            train_idx = np.arange(len(self.dataset))
        self.sampler = EpochSampler(train_idx, seed=seed)
        self.batcher = HostBatcher(self.dataset, cfg.batch_size, cfg.num_workers)
        self.cache_budget = cache_budget
        self._cache_decision = None   # memoized _cache_wanted (one reserve)
        self._device_dataset = None   # uint8 (rows, H, W, 3) on the device
        self._row_of = None           # dataset index -> cache row (-1 corrupt)

    def _prep_kwargs(self) -> dict:
        c = self.cfg
        return dict(
            factor=c.upscale_factor, noise_std_max=c.noise_std_max,
            salt_prob=c.salt_prob, pepper_prob=c.pepper_prob,
            spot_size=c.sp_spot_size, augment_flips=self.augment,
        )

    def steps_per_epoch(self) -> int:
        return len(self.sampler.indices) // self.cfg.batch_size

    def _cache_wanted(self) -> bool:
        # decided once: with a shared budget the decision reserves bytes
        if self._cache_decision is None:
            self._cache_decision = self._decide_cache()
        return self._cache_decision

    def _decide_cache(self) -> bool:
        if self.cfg.device_cache == "off":
            return False
        if self.cfg.device_cache == "on":
            return True
        h, w = self.cfg.hr_size
        nbytes = len(self.sampler.indices) * h * w * 3
        if self.cache_budget is not None:
            return self.cache_budget.try_reserve(nbytes)
        return nbytes <= self.cfg.device_cache_budget_bytes

    def _ensure_device_cache(self) -> torch.Tensor:
        if self._device_dataset is not None:
            return self._device_dataset
        cache_idx = np.asarray(self.sampler.indices)
        batch, ok = self.batcher.decode_many(cache_idx)
        rows = batch if ok.all() else batch[ok]
        self._row_of = np.full(len(self.dataset), -1, np.int64)
        self._row_of[cache_idx[ok]] = np.arange(len(rows))
        self._device_dataset = torch.from_numpy(rows).to(self.device)
        return self._device_dataset

    def epoch(
        self, epoch: int, generator: torch.Generator
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        if self._cache_wanted():
            yield from self._epoch_cached(epoch, generator)
        else:
            yield from self._epoch_streaming(epoch, generator)

    def _epoch_cached(self, epoch, generator):
        dataset = self._ensure_device_cache()
        rows = self._row_of[self.sampler.epoch_indices(epoch)]
        bad = rows < 0
        if bad.any():
            good = rows[~bad]
            if len(good):
                # corrupt-file skip without changing the batch count
                rows = rows.copy()
                rows[bad] = good[np.arange(int(bad.sum())) % len(good)]
            else:
                rows = good  # every sampled file corrupt: nothing to run
        b = self.cfg.batch_size
        n = len(rows) // b
        # one upload of the epoch's gather indices; per-step slices are views
        rows_dev = torch.as_tensor(rows[: n * b], device=self.device)
        for step in range(n):
            idx = rows_dev[step * b : (step + 1) * b]
            yield gather_prepare_batch(
                dataset, idx, generator, **self._prep_kwargs()
            )

    def _epoch_streaming(self, epoch, generator):
        indices = self.sampler.epoch_indices(epoch)
        hr_stream = _device_prefetch(
            self.batcher.batches(indices), self.cfg.prefetch_depth, self.device
        )
        for hr_u8 in hr_stream:
            yield prepare_batch(hr_u8, generator, **self._prep_kwargs())

    def close(self):
        self.batcher.close()
