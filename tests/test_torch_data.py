"""The port's batch prep, metrics and data pipeline against the JAX
package. Random draws (noise, noise std, flip masks) are made with numpy
and handed to both; tolerance 1e-5 (fp32 rounding of the resize matrices'
contraction order). Sampler order and splits must be identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.data import dataset as jds
from srgan_tpu.data.pipeline import EpochSampler as JEpochSampler
from srgan_tpu.ops import metrics as jm
from srgan_tpu.ops import resize as jr
from srgan_tpu_torch.config import DataConfig
from srgan_tpu_torch.data import dataset as tds
from srgan_tpu_torch.data.pipeline import (
    DeviceCacheBudget,
    EpochSampler,
    TrainPipeline,
)
from srgan_tpu_torch.ops import metrics as tm
from srgan_tpu_torch.ops import resize as tr

torch.set_num_threads(1)


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


class TestResize:
    @pytest.mark.parametrize(
        "src,dst",
        [((32, 64), (8, 16)), ((32, 64), (16, 32)), ((30, 45), (7, 11)),
         ((12, 10), (24, 20)), ((16, 16), (16, 8))],
    )
    def test_bilinear_matches_jax(self, rng, src, dst):
        x = rng.random((2, *src, 3)).astype(np.float32)
        want = np.asarray(jr.resize_bilinear(jnp.asarray(x), dst))
        got = tr.resize_bilinear(torch.from_numpy(x), dst).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_hwc_input(self, rng):
        x = rng.random((32, 48, 3)).astype(np.float32)
        want = np.asarray(jr.resize_bilinear(jnp.asarray(x), (8, 12)))
        got = tr.resize_bilinear(torch.from_numpy(x), (8, 12)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("factor", [2, 4])
    def test_degrade_with_injected_noise(self, rng, factor):
        hr = rng.random((3, 32, 64, 3)).astype(np.float32)
        lr_shape = (3, 32 // factor, 64 // factor, 3)
        noise = rng.standard_normal(lr_shape).astype(np.float32)
        std = (0.03 * rng.random((3, 1, 1, 1))).astype(np.float32)
        want = (
            np.asarray(jr.resize_bilinear(jnp.asarray(hr), lr_shape[1:3]))
            + noise * std
        )
        got = tr.degrade_batch_from(
            torch.from_numpy(hr), torch.from_numpy(noise), torch.from_numpy(std),
            factor,
        ).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_prepare_batch_noise_free_matches_jax(self, rng):
        """noise_std_max=0 draws nothing that matters: the whole JAX
        prepare_batch (its /255 and resize) is the reference."""
        import jax

        hr_u8 = _u8(rng, (2, 32, 64, 3))
        hr_j, lr_j = jr.prepare_batch(
            jnp.asarray(hr_u8), jax.random.key(0), factor=4, noise_std_max=0.0
        )
        g = torch.Generator().manual_seed(0)
        hr_t, lr_t = tr.prepare_batch(
            torch.from_numpy(hr_u8), g, factor=4, noise_std_max=0.0
        )
        np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
        np.testing.assert_allclose(lr_t.numpy(), np.asarray(lr_j), atol=1e-5)

    def test_flips_with_injected_masks(self, rng):
        hr_u8 = _u8(rng, (4, 8, 12, 3))
        fh = np.array([True, False, True, False])
        fv = np.array([True, True, False, False])
        x = jnp.asarray(hr_u8)
        x = jnp.where(fh[:, None, None, None], x[:, :, ::-1, :], x)
        want = jnp.where(fv[:, None, None, None], x[:, ::-1, :, :], x)
        got = tr.apply_flips(
            torch.from_numpy(hr_u8), torch.from_numpy(fh), torch.from_numpy(fv)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_random_draws_are_seeded_and_in_range(self, rng):
        hr = torch.from_numpy(rng.random((8, 16, 16, 3)).astype(np.float32))
        a = tr.degrade_batch(hr, torch.Generator().manual_seed(5), noise_std_max=0.03)
        b = tr.degrade_batch(hr, torch.Generator().manual_seed(5), noise_std_max=0.03)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        clean = tr.resize_bilinear(hr, (4, 4))
        assert float((a - clean).abs().max()) < 0.03 * 6
        flipped = tr.random_flips(hr, torch.Generator().manual_seed(1))
        for i in range(8):
            variants = [hr[i], hr[i].flip(1), hr[i].flip(0), hr[i].flip(0).flip(1)]
            assert any(torch.equal(flipped[i], v) for v in variants)

    def test_gather_prepare(self, rng):
        data = torch.from_numpy(_u8(rng, (5, 16, 16, 3)))
        idx = torch.tensor([3, 0])
        g = torch.Generator().manual_seed(0)
        hr, lr = tr.gather_prepare_batch(data, idx, g, factor=2, noise_std_max=0.0)
        torch.testing.assert_close(hr, data[[3, 0]].float() / 255.0)
        assert lr.shape == (2, 8, 8, 3)

    def test_salt_pepper_names_roadmap(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tr.degrade_batch(torch.zeros(1, 8, 8, 3), torch.Generator(), salt_prob=0.1)


class TestMetrics:
    def test_psnr_ssim_match_jax(self, rng):
        a = rng.random((3, 20, 24, 3)).astype(np.float32)
        b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
        p_j, s_j = jm.batched_psnr_ssim(jnp.asarray(a), jnp.asarray(b))
        p_t, s_t = tm.batched_psnr_ssim(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-5)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)

    def test_single_image_functions(self, rng):
        a = rng.random((20, 24, 3)).astype(np.float32)
        b = rng.random((20, 24, 3)).astype(np.float32)
        assert float(tm.psnr(torch.from_numpy(a), torch.from_numpy(b))) == (
            pytest.approx(float(jm.psnr(jnp.asarray(a), jnp.asarray(b))), rel=1e-5)
        )
        assert float(tm.ssim(torch.from_numpy(a), torch.from_numpy(b))) == (
            pytest.approx(float(jm.ssim(jnp.asarray(a), jnp.asarray(b))), abs=1e-5)
        )


class TestSampling:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_epoch_sampler_order_exact(self, seed):
        idx = np.arange(3, 40, 2)
        a = JEpochSampler(idx, seed=seed)
        b = EpochSampler(idx, seed=seed)
        for epoch in range(3):
            np.testing.assert_array_equal(b.epoch_indices(epoch), a.epoch_indices(epoch))

    def test_split_indices_exact(self):
        for got, want in zip(tds.split_indices(23, 0.7, 4), jds.split_indices(23, 0.7, 4)):
            np.testing.assert_array_equal(got, want)

    def test_cache_budget(self):
        budget = DeviceCacheBudget(100)
        assert budget.try_reserve(60)
        assert not budget.try_reserve(60)
        assert budget.try_reserve(40)


def _png_folder(folder, n, size, rng):
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        Image.fromarray(_u8(rng, (*size, 3))).save(
            os.path.join(folder, f"img_{i:03d}.png")
        )


class TestDatasetAndPipeline:
    def test_decode_matches_jax_pil_path(self, tmp_path, rng):
        _png_folder(str(tmp_path), 2, (30, 40), rng)
        paths = sorted(os.listdir(tmp_path))
        assert tds.list_image_files(str(tmp_path)) == jds.list_image_files(str(tmp_path))
        for p in paths:
            full = str(tmp_path / p)
            want = jds.load_hr_clip_u8(full, (24, 32), use_native=False)
            np.testing.assert_array_equal(tds.load_hr_clip_u8(full, (24, 32)), want)
        ds = tds.ImageFolderDataset(str(tmp_path), (24, 32))
        assert ds[0].dtype == np.float32 and ds[0].shape == (24, 32, 3)

    def test_corrupt_file_is_none(self, tmp_path, rng):
        _png_folder(str(tmp_path), 1, (8, 8), rng)
        (tmp_path / "bad.png").write_bytes(b"not an image")
        ds = tds.ImageFolderDataset(str(tmp_path), (8, 8))
        assert sum(ds.load_u8(i) is None for i in range(len(ds))) == 1

    @pytest.mark.parametrize("cache", ["on", "off"])
    def test_pipeline_batches_follow_the_sampler(self, rng, cache):
        clips = _u8(rng, (7, 16, 32, 3))
        cfg = DataConfig(hr_size=(16, 32), upscale_factor=2, batch_size=3,
                         noise_std_max=0.0, device_cache=cache, num_workers=2)
        pipe = TrainPipeline(cfg, tds.ArrayDataset(clips), use_split=False,
                             seed=3, device="cpu")
        try:
            order = pipe.sampler.epoch_indices(1)
            batches = list(pipe.epoch(1, torch.Generator().manual_seed(0)))
        finally:
            pipe.close()
        assert len(batches) == pipe.steps_per_epoch() == 2
        for k, (hr, lr) in enumerate(batches):
            want = clips[order[3 * k : 3 * k + 3]].astype(np.float32) / 255.0
            np.testing.assert_allclose(hr.numpy(), want, rtol=0, atol=1e-7)
            assert lr.shape == (3, 8, 16, 3)

    @pytest.mark.parametrize("cache", ["on", "off"])
    def test_corrupt_clip_keeps_the_batch_count(self, rng, cache):
        class OneBad(tds.ArrayDataset):
            def load_u8(self, idx):
                return None if idx == 2 else super().load_u8(idx)

        clips = _u8(rng, (6, 8, 8, 3))
        cfg = DataConfig(hr_size=(8, 8), upscale_factor=2, batch_size=3,
                         noise_std_max=0.0, device_cache=cache, num_workers=1)
        pipe = TrainPipeline(cfg, OneBad(clips), use_split=False, device="cpu")
        try:
            batches = [hr for hr, _ in pipe.epoch(0, torch.Generator())]
        finally:
            pipe.close()
        assert len(batches) == 2
        served = torch.cat(batches).mul(255).round().to(torch.uint8).numpy()
        good = {clips[i].tobytes() for i in range(6) if i != 2}
        assert all(img.tobytes() in good for img in served)

    def test_pipeline_rejects_wrong_clip_size(self, rng):
        cfg = DataConfig(hr_size=(16, 32))
        with pytest.raises(ValueError, match="clips"):
            TrainPipeline(cfg, tds.ArrayDataset(_u8(rng, (2, 8, 8, 3))), device="cpu")
