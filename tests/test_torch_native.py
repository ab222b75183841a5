"""The port's copy of the native C++ codec (``srgan_tpu_torch/native``)
against PIL and against the JAX package's build of the same source
(``srgan_tpu/native``): the cases of ``tests/test_native.py`` (PIL parity,
JPEG, palette PNG, corrupt and truncated files, batches, the threaded
encoder), then the pipeline and ``upscale_directory`` on the native path.
Decode parity is exact against PIL where it downsizes and within 1/255 on
< 1 % of pixels where it upsizes (PIL's own rounding, as in JAX's tests);
everything against the JAX package's build is exact. Skipped where the
library cannot be built (no g++, libjpeg or libpng)."""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu import native as jnative
from srgan_tpu_torch import native


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.available():
        pytest.skip(f"the native codec cannot be built here: {native.build_error()}")
    if not jnative.available():
        pytest.skip("the JAX package's native codec cannot be built here")


def _png(folder, arr, name="t.png"):
    p = str(folder / name)
    Image.fromarray(arr).save(p)
    return p


class TestBuild:
    def test_builds_into_the_build_dir(self):
        path = native.library_path()
        assert path.parent == native.BUILD_DIR and path.parent.name == "_build"
        assert path.exists() and native.encoder_available()
        assert native.SOURCE.parent != path.parent  # not beside the source

    def test_failed_build_reports_its_first_error(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(native, "LIBS", ("-lno_such_library_here",))
        monkeypatch.setattr(native._Build, "error", None)
        assert not native.build()
        assert "no_such_library_here" in native.build_error()


class TestDecode:
    def test_pil_parity_downscale_exact(self, tmp_path, rng):
        src = rng.integers(0, 255, (40, 56, 3)).astype(np.uint8)
        p = _png(tmp_path, src)
        pil = np.asarray(Image.fromarray(src).resize((32, 24), Image.BICUBIC),
                         np.float32) / 255.0
        got = native.load_image(p, 24, 32)
        np.testing.assert_array_equal(got, pil)
        np.testing.assert_array_equal(got, jnative.load_image(p, 24, 32))

    def test_pil_parity_upscale_tolerance(self, tmp_path, rng):
        src = rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)
        p = _png(tmp_path, src)
        pil = np.asarray(Image.fromarray(src).resize((64, 48), Image.BICUBIC),
                         np.float32) / 255.0
        got = native.load_image(p, 48, 64)
        d = np.abs(got - pil)
        assert d.max() <= 1.01 / 255.0 and (d > 0).mean() < 0.01
        np.testing.assert_array_equal(got, jnative.load_image(p, 48, 64))

    def test_same_size_u8_is_the_decoded_image(self, tmp_path, rng):
        """The serving path decodes at the header's size: the identity."""
        src = rng.integers(0, 256, (20, 28, 3)).astype(np.uint8)
        p = _png(tmp_path, src)
        np.testing.assert_array_equal(native.load_image_u8(p, 20, 28), src)

    def test_jpeg(self, tmp_path, rng):
        src = rng.integers(0, 255, (30, 30, 3)).astype(np.uint8)
        p = str(tmp_path / "t.jpg")
        Image.fromarray(src).save(p, quality=95)
        out = native.load_image(p, 16, 16)
        assert out is not None and out.shape == (16, 16, 3)
        assert 0.0 <= out.min() and out.max() <= 1.0
        np.testing.assert_array_equal(out, jnative.load_image(p, 16, 16))

    def test_palette_png_with_transparency(self, tmp_path, rng):
        arr = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
        p = str(tmp_path / "pal.png")
        Image.fromarray(arr).convert("P", palette=Image.ADAPTIVE).save(p, transparency=0)
        out = native.load_image_u8(p, 32, 32)
        np.testing.assert_array_equal(out, np.asarray(Image.open(p).convert("RGB")))

    def test_corrupt_returns_none(self, tmp_path):
        p = str(tmp_path / "bad.png")
        with open(p, "wb") as f:
            f.write(b"not an image at all")
        assert native.load_image(p, 8, 8) is None
        assert native.load_image_u8(str(tmp_path / "missing.png"), 8, 8) is None

    def test_truncated_files_skipped_not_crashed(self, tmp_path, rng):
        src = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
        k = 0
        for fmt, name in (("PNG", "t.png"), ("JPEG", "t.jpg")):
            buf = io.BytesIO()
            Image.fromarray(src).save(buf, format=fmt)
            blob = buf.getvalue()
            for frac in (0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
                p = str(tmp_path / f"cut{k}_{name}")
                with open(p, "wb") as f:
                    f.write(blob[: max(16, int(len(blob) * frac))])
                k += 1
                out = native.load_image(p, 16, 16)
                if out is not None:  # a tolerated tail truncation
                    assert out.shape == (16, 16, 3) and np.isfinite(out).all()
                    assert 0.0 <= out.min() and out.max() <= 1.0

    def test_batch(self, tmp_path, rng):
        paths = [_png(tmp_path, rng.integers(0, 255, (20 + i, 20, 3)).astype(np.uint8),
                      f"b{i}.png") for i in range(4)]
        bad = str(tmp_path / "bad.png")
        open(bad, "wb").write(b"junk")
        paths.append(bad)
        batch, ok = native.load_batch(paths, 16, 16, num_threads=2)
        assert batch.shape == (5, 16, 16, 3) and ok.tolist() == [True] * 4 + [False]
        u8, ok8 = native.load_batch_u8(paths, 16, 16, num_threads=3)
        want, want_ok = jnative.load_batch_u8(paths, 16, 16, num_threads=1)
        assert ok8.tolist() == want_ok.tolist()
        np.testing.assert_array_equal(u8[ok8], want[want_ok])
        np.testing.assert_array_equal(u8[ok8].astype(np.float32) / 255.0, batch[ok])


class TestEncode:
    def test_png_matches_pil_and_the_jax_build(self, tmp_path, rng):
        """A float image encodes to the pixels of ``array_to_image`` (clip,
        x255 + 0.5, floor), and the file is byte for byte the JAX package's
        build's."""
        from srgan_tpu_torch.utils.image_io import array_to_image

        img = (rng.random((24, 32, 3)).astype(np.float32) - 0.1) * 1.3
        ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
        assert native.save_image(ours, img) and jnative.save_image(theirs, img)
        got = np.asarray(Image.open(ours).convert("RGB"))
        np.testing.assert_array_equal(got, np.asarray(array_to_image(img)))
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read()

    def test_jpeg_roundtrip_close(self, tmp_path):
        y, x = np.mgrid[0:24, 0:32].astype(np.float32)
        img = np.stack([y / 24, x / 32, (y + x) / 56], axis=-1)
        p = str(tmp_path / "out.jpg")
        assert native.save_image(p, img)
        got = np.asarray(Image.open(p).convert("RGB")).astype(np.float32)
        assert np.abs(got / 255.0 - np.clip(img, 0, 1)).mean() < 0.05

    def test_batch_threaded_u8(self, tmp_path, rng):
        imgs = rng.integers(0, 256, (7, 16, 16, 3)).astype(np.uint8)
        paths = [str(tmp_path / f"b{i}.png") for i in range(7)]
        assert native.save_batch_u8(paths, imgs, num_threads=3).all()
        for i, p in enumerate(paths):
            np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), imgs[i])
        floats = rng.random((3, 8, 8, 3)).astype(np.float32)
        fpaths = [str(tmp_path / f"f{i}.png") for i in range(3)]
        assert native.save_batch(fpaths, floats, num_threads=2).all()
        for i, p in enumerate(fpaths):
            want = (np.clip(floats[i], 0, 1) * 255 + 0.5).astype(np.uint8)
            np.testing.assert_array_equal(np.asarray(Image.open(p).convert("RGB")), want)

    def test_unwritable_path_fails_cleanly(self, rng):
        img = rng.random((8, 8, 3)).astype(np.float32)
        assert not native.save_image("/nonexistent_dir_xyz/o.png", img)
        ok = native.save_batch_u8(["/nonexistent_dir_xyz/o.png"],
                                  (img[None] * 255).astype(np.uint8))
        assert ok.tolist() == [False]


class TestCallers:
    def test_pipeline_uses_native_and_matches_jax(self, tmp_path, rng):
        """The port's HostBatcher takes the native path, one call a batch,
        and decodes the clips JAX's does; the epoch's batches run."""
        from srgan_tpu.config import DataConfig as JDataConfig
        from srgan_tpu.data.pipeline import HostBatcher as JHostBatcher
        from srgan_tpu.data.dataset import ImageFolderDataset as JDataset
        from srgan_tpu_torch.config import DataConfig
        from srgan_tpu_torch.data.pipeline import TrainPipeline

        folder = tmp_path / "imgs"
        folder.mkdir()
        for i in range(4):
            _png(folder, rng.integers(0, 255, (40, 40, 3)).astype(np.uint8), f"i{i}.png")
        open(folder / "zz_bad.png", "wb").write(b"junk")
        cfg = DataConfig(hr_size=(16, 16), upscale_factor=2, batch_size=2,
                         split_ratio=1.0, device_cache="off")
        pipe = TrainPipeline(cfg, str(folder), use_split=False, device="cpu")
        try:
            assert pipe.batcher.native and pipe.batcher.pool is None
            got, ok = pipe.batcher.decode_many(np.arange(5))
            jb = JHostBatcher(JDataset(str(folder), (16, 16)), 2)
            want, want_ok = jb.decode_many(np.arange(5))
            jb.close()
            assert ok.tolist() == want_ok.tolist() == [True] * 4 + [False]
            np.testing.assert_array_equal(got[ok], want[want_ok])
            batches = list(pipe.epoch(0, torch.Generator().manual_seed(0)))
            assert len(batches) == 2
            hr, lr = batches[0]
            assert hr.shape == (2, 16, 16, 3) and lr.shape == (2, 8, 8, 3)
        finally:
            pipe.close()
        assert JDataConfig  # the JAX config is importable beside the port's

    def test_upscale_directory_native_equals_pil(self, tmp_path, rng, capsys, monkeypatch):
        """``upscale_directory`` serves through the native codec (and names
        it), writing the same pixels as its PIL path; a file the native
        decoder rejects but PIL reads is served by the retry."""
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.eval import inference as tinf

        src = tmp_path / "in"
        src.mkdir()
        for i in range(5):
            _png(src, rng.integers(0, 256, (10, 12, 3)).astype(np.uint8), f"s{i}.png")
        cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2)
        up = tinf.Upscaler.random_init(cfg, seed=3, device="cpu")

        n = tinf.upscale_directory(str(src), str(tmp_path / "nat"), upscaler=up,
                                   batch_size=4)
        assert n == 5 and "codec native" in capsys.readouterr().err
        monkeypatch.setattr(native, "available", lambda: False)
        n = tinf.upscale_directory(str(src), str(tmp_path / "pil"), upscaler=up,
                                   batch_size=4)
        assert n == 5 and "codec PIL" in capsys.readouterr().err
        for f in sorted(os.listdir(src)):
            a = np.asarray(Image.open(tmp_path / "nat" / f))
            b = np.asarray(Image.open(tmp_path / "pil" / f))
            assert a.shape == (20, 24, 3)
            np.testing.assert_array_equal(a, b)
