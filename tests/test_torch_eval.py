"""The port's ``evaluate_model`` and its CLI subcommands (``eval``,
``upscale``, ``upscale-dir``) against the JAX package on the CPU: the
same paired sets, the same weights (through ``utils/params.py``), the same
quirks, warnings, skips and errors. The CLI runs on a snapshot that the
port's own ``train --device cpu`` writes.

Bars: average PSNR abs 1e-3 dB, average SSIM abs 1e-5.
"""

import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.eval import evaluation as jeval
from srgan_tpu.eval import inference as jinf
from srgan_tpu_torch import cli
from srgan_tpu_torch.eval import evaluation as teval
from srgan_tpu_torch.eval import inference as tinf

from test_torch_serve import _jax_generator, _port

torch.set_num_threads(1)


def _pairs(root, sizes, factor=4, seed=3):
    """Paired LR/HR folders: one pair for each LR (h, w) in ``sizes``, the
    HR ``factor`` times larger; smooth content, so the scores are not
    noise-level."""
    rng = np.random.default_rng(seed)
    for sub in ("LRbicx4", "original"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        hr = rng.random((h * factor // 4 + 1, w * factor // 4 + 1, 3))
        hr = np.asarray(Image.fromarray((hr * 255).astype(np.uint8)).resize(
            (w * factor, h * factor), Image.BICUBIC))
        lr = np.asarray(Image.fromarray(hr).resize((w, h), Image.BICUBIC))
        Image.fromarray(hr).save(os.path.join(root, "original", f"p_{i}.png"))
        Image.fromarray(lr).save(os.path.join(root, "LRbicx4", f"p_{i}.png"))
    return root


def _upscalers(seed=0, **kw):
    jm, params, cfg = _jax_generator(seed, **kw)
    return jinf.Upscaler(jm, params), tinf.Upscaler(_port(params, cfg), device="cpu")


def _evaluate(root, jup, tup, **kw):
    want = jeval.evaluate_model(root, "LRbicx4", "original", upscaler=jup,
                                verbose=False, **kw)
    got = teval.evaluate_model(root, "LRbicx4", "original", upscaler=tup,
                               verbose=False, **kw)
    return got, want


def _same_scores(got, want):
    assert len(got) == 3 and got[2] is None
    assert abs(got[0] - want[0]) <= 1e-3, (got, want)
    assert abs(got[1] - want[1]) <= 1e-5, (got, want)


class TestEvaluateModel:
    @pytest.mark.parametrize("factor,extra_downscale,apply_enhance", [
        (4, True, True), (4, False, False), (4, True, False), (2, True, True),
    ])
    def test_matches_jax(self, tmp_path, factor, extra_downscale, apply_enhance):
        root = _pairs(str(tmp_path), [(24, 32), (24, 32)], factor=factor)
        jup, tup = _upscalers(upscale_factor=factor)
        got, want = _evaluate(root, jup, tup, extra_downscale=extra_downscale,
                              apply_enhance=apply_enhance)
        _same_scores(got, want)

    def test_bucketed_uniform_and_mixed_match_jax(self, tmp_path):
        jup, tup = _upscalers(upscale_factor=4)
        uniform = _pairs(str(tmp_path / "u"), [(24, 32)] * 2)
        got, want = _evaluate(uniform, jup, tup, bucketed=True)
        _same_scores(got, want)
        per_size, _ = _evaluate(uniform, jup, tup)
        _same_scores(got, per_size)  # no padding: the per-size numbers
        mixed = _pairs(str(tmp_path / "m"), [(24, 32), (20, 28), (16, 36)])
        for kw in ({}, {"extra_downscale": False}):
            got, want = _evaluate(mixed, jup, tup, bucketed=True, **kw)
            _same_scores(got, want)

    def test_groupnorm_padding_warns_as_jax(self, tmp_path):
        root = _pairs(str(tmp_path), [(32, 32), (12, 16)])
        jup, tup = _upscalers(upscale_factor=4)  # GroupNorm model
        for mod, up in ((jeval, jup), (teval, tup)):
            with pytest.warns(UserWarning, match="GroupNorm statistics"):
                mod.evaluate_model(root, "LRbicx4", "original", upscaler=up,
                                   bucketed=True, verbose=False)

    @pytest.mark.parametrize("bucketed", [False, True])
    def test_tiny_lr_skipped_as_jax(self, tmp_path, bucketed):
        root = _pairs(str(tmp_path), [(24, 32), (3, 5)])
        jup, tup = _upscalers(upscale_factor=4)
        with pytest.warns(UserWarning, match="too small to score"):
            got, want = _evaluate(root, jup, tup, bucketed=bucketed)
        _same_scores(got, want)
        assert math.isfinite(got[0])

    def test_nothing_to_score_returns_three_slots(self, tmp_path):
        """The JAX bucketed path returns a 2-tuple here; the port keeps
        the fixed 3-tuple."""
        root = _pairs(str(tmp_path), [(3, 5)])
        jup, tup = _upscalers(upscale_factor=4)
        with pytest.warns(UserWarning, match="too small"):
            got, want = _evaluate(root, jup, tup, bucketed=True)
        assert len(want) == 2 and all(math.isnan(v) for v in want)
        assert len(got) == 3 and math.isnan(got[0]) and math.isnan(got[1])
        assert got[2] is None

    def test_missing_checkpoint_warns(self, tmp_path):
        root = _pairs(str(tmp_path), [(16, 16)])
        with pytest.warns(RuntimeWarning, match="RANDOM"):
            psnr, ssim, _ = teval.evaluate_model(
                root, "LRbicx4", "original", results_dir=str(tmp_path / "none"),
                verbose=False, device="cpu")
        assert math.isfinite(psnr) and -1.0 <= ssim <= 1.0

    @pytest.mark.parametrize("kw,match", [
        ({"torch_checkpoint": "g.pth", "ensemble": True}, "--ensemble requires"),
        ({"torch_checkpoint": "g.pth", "ema": True}, "--ema requires"),
        ({"perceptual_metric": "e.npz", "bucketed": True}, "not supported with"),
    ])
    def test_value_errors_as_jax(self, tmp_path, kw, match):
        root = _pairs(str(tmp_path), [(16, 16)])
        with pytest.raises(ValueError, match=match):
            jeval.evaluate_model(root, "LRbicx4", "original", verbose=False, **kw)
        with pytest.raises(ValueError, match=match):
            teval.evaluate_model(root, "LRbicx4", "original", verbose=False,
                                 device="cpu", **kw)

    def test_perceptual_metric_names_its_item(self, tmp_path):
        """The metric is ported (tests/test_torch_perceptual.py holds it
        against JAX): a missing encoder archive raises FileNotFoundError, as
        in JAX, where it raised naming ROADMAP item 8 before."""
        root = _pairs(str(tmp_path), [(16, 16)])
        jup, tup = _upscalers()
        for evaluate, up, kw in ((jeval.evaluate_model, jup, {}),
                                 (teval.evaluate_model, tup, {"device": "cpu"})):
            with pytest.raises(FileNotFoundError):
                evaluate(root, "LRbicx4", "original", upscaler=up, verbose=False,
                         perceptual_metric=str(tmp_path / "e.npz"), **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port snapshot from ``train --device cpu`` (F=8, 1 block, 4x), and
    a paired set and a folder to serve."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    for sub, n in (("train", 6), ("val", 2)):
        os.makedirs(root / sub)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 72, 3), dtype=np.uint8)).save(
                root / sub / f"c{i}.png")
    res = str(root / "results")
    cli.main(["train", "--train-dir", str(root / "train"), "--val-dir",
              str(root / "val"), "--epochs", "1", "--batch-size", "2",
              "--hr-height", "32", "--hr-width", "64", "--num-features", "8",
              "--num-residuals", "1", "--results-dir", res, "--progress", "off",
              "--device", "cpu"])
    _pairs(str(root / "pairs"), [(24, 32), (24, 32)])
    os.makedirs(root / "serve")
    for i, hw in enumerate([(12, 16)] * 4 + [(10, 14)]):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            root / "serve" / f"s{i}.png")
    return root, res


class TestCLI:
    def test_upscale(self, trained, tmp_path):
        root, res = trained
        src = str(root / "serve" / "s4.png")
        up = tinf.Upscaler.from_checkpoint(res, device="cpu")
        up.upscale_file(src, str(tmp_path / "api.png"))
        cli.main(["upscale", src, str(tmp_path / "cli.png"), "--results-dir", res,
                  "--device", "cpu"])
        a = np.asarray(Image.open(tmp_path / "cli.png"))
        assert a.shape == (40, 56, 3)
        np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "api.png")))
        # --tile: the tiled path at the flags' sizes
        cli.main(["upscale", src, str(tmp_path / "tiled.png"), "--results-dir", res,
                  "--tile", "8", "--tile-overlap", "4", "--tile-batch", "3",
                  "--device", "cpu"])
        from srgan_tpu_torch.utils.image_io import array_to_image, load_image

        want = np.asarray(array_to_image(up.upscale_tiled(
            load_image(src), tile=8, overlap=4, batch_size=3)))
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "tiled.png")), want)

    def test_upscale_dir(self, trained, tmp_path, capsys):
        root, res = trained
        src = str(root / "serve")
        n = cli.main(["upscale-dir", src, str(tmp_path / "cli"), "--results-dir", res,
                      "--ensemble", "--batch-size", "3", "--device", "cpu"])
        assert n == 5 and "upscaled 5 images" in capsys.readouterr().out
        up = tinf.Upscaler.from_checkpoint(res, ensemble=True, device="cpu")
        tinf.upscale_directory(src, str(tmp_path / "api"), upscaler=up, batch_size=3)
        names = sorted(os.listdir(tmp_path / "cli"))
        assert names == sorted(os.listdir(tmp_path / "api")) == sorted(os.listdir(src))
        for name in names:
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "cli" / name)),
                np.asarray(Image.open(tmp_path / "api" / name)))

    def test_eval(self, trained):
        root, res = trained
        argv = ["-D", str(root / "pairs"), "--results-dir", res, "--device", "cpu"]
        got = cli.main(["eval", *argv])
        want = teval.evaluate_model(str(root / "pairs"), "LRbicx4", "original",
                                    results_dir=res, verbose=False, device="cpu")
        assert got == want and math.isfinite(got[0])
        assert teval.main(argv) == want  # the standalone script's contract

    @pytest.mark.parametrize("argv,exc,match", [
        (["train", "--pool-exec", "vmap", "--device", "cpu"], NotImplementedError,
         "item 7"),
        (["train", "--multihost", "--device", "cpu"], RuntimeError, "MASTER_ADDR"),
        (["eval", "--perceptual-metric", "e.npz", "--bucketed", "--device", "cpu"],
         ValueError, "not supported with --bucketed"),
    ])
    def test_unported_flags_name_their_item(self, argv, exc, match, monkeypatch):
        """The one unported flag, --pool-exec vmap, names its ROADMAP item
        (--dp is ported: ``tests/test_torch_parallel.py``); --multihost
        without torchrun's variables names them; --perceptual-metric is
        ported and refuses --bucketed, as in JAX."""
        from srgan_tpu_torch.parallel.mesh import ENV_VARS

        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(exc, match=match):
            cli.main(argv)

    def test_default_device_is_the_card(self, trained, tmp_path, monkeypatch):
        root, res = trained
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for argv in (["upscale", str(root / "serve" / "s0.png"), str(tmp_path / "o.png")],
                     ["upscale-dir", str(root / "serve"), str(tmp_path / "o")],
                     ["eval", "-D", str(root / "pairs")]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main([*argv, "--results-dir", res])

    def test_serving_leaves_tf32_off(self, trained, tmp_path):
        root, res = trained
        flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
        up = tinf.Upscaler.from_checkpoint(res, device="cpu")
        calls = (
            lambda: teval.evaluate_model(str(root / "pairs"), "LRbicx4", "original",
                                         upscaler=up, verbose=False),
            lambda: tinf.upscale_directory(str(root / "serve"), str(tmp_path / "o"),
                                           upscaler=up),
        )
        try:
            for call in calls:
                for f in flags:
                    f.allow_tf32 = True
                call()
                assert [f.allow_tf32 for f in flags] == [False, False]
        finally:
            for f in flags:
                f.allow_tf32 = False
