"""The port's serving modules against the JAX package on the CPU: the
masked metrics, the enhancer, the serving steps (pool ensemble, x8 TTA and
their uint8 twins), the paired dataset, ``to_float01``, the ``Upscaler``
(direct, uint8, file, tiled, from a port snapshot, from a reference
``.pth``) and ``upscale_directory``. The same seeded numpy inputs and the
same weights (through ``utils/params.py``) go through both packages.

Bars: fp32 SR max|Δ| ≤ 1e-4·max|y| (the generator's bar), bf16 2e-2·max;
uint8 ≤ 1 LSB (a value within rounding of a quantisation step may land on
either side); masked metrics rel 1e-5; the enhancer 1e-6 abs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from PIL import Image

from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.data import dataset as jdataset
from srgan_tpu.eval import inference as jinf
from srgan_tpu.models.enhancer import enhance as j_enhance
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.ops import metrics as jmetrics
from srgan_tpu.training import steps as jsteps
from srgan_tpu_torch.config import ModelConfig, PoolConfig
from srgan_tpu_torch.data import dataset as tdataset
from srgan_tpu_torch.eval import inference as tinf
from srgan_tpu_torch.models.enhancer import enhance
from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.ops import metrics, resize
from srgan_tpu_torch.training import checkpoint as ckpt
from srgan_tpu_torch.training import pool as tpool
from srgan_tpu_torch.training import steps
from srgan_tpu_torch.training.train_state import TrainState
from srgan_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)

BAR = {"float32": 1e-4, "bfloat16": 2e-2}
LSB = 1.0 / 255.0


def _jax_generator(seed=0, **kw):
    """A JAX generator (F=8, 1 block, 2x unless overridden) with every leaf
    perturbed, so biases and GroupNorm affines are exercised."""
    cfg = {"num_features": 8, "num_residuals": 1, "upscale_factor": 2, **kw}
    model, params = j_init_generator(JModelConfig(**cfg), jax.random.key(seed),
                                     sample_hw=(8, 16))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        jax.device_get(params),
    )
    return model, params, cfg


def _port(params, cfg) -> SRResNet:
    model = SRResNet.from_config(ModelConfig(**cfg))
    model.load_state_dict(from_jax_params(params))
    return model


def _stack(*trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _close(got, want, bar):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= bar * np.abs(want).max(), (err, np.abs(want).max())


def _lsb(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture
def lr(rng):
    # non-square, so the transposed TTA pair runs at (W, H)
    return rng.random((2, 10, 14, 3), dtype=np.float32)


class TestMetrics:
    @pytest.mark.parametrize("valid", [(16, 20), (11, 13), "tensors"])
    def test_masked_match_jax(self, rng, valid):
        a = rng.random((16, 20, 3), dtype=np.float32)
        b = np.clip(a + 0.1 * rng.standard_normal(a.shape, dtype=np.float32), 0, 1)
        vh, vw = (11, 13) if valid == "tensors" else valid
        tv = (torch.tensor(vh), torch.tensor(vw)) if valid == "tensors" else (vh, vw)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        for jfn, tfn in ((jmetrics.psnr_masked, metrics.psnr_masked),
                         (jmetrics.ssim_masked, metrics.ssim_masked)):
            want = float(jfn(jnp.asarray(a), jnp.asarray(b), vh, vw))
            got = float(tfn(ta, tb, *tv))
            assert got == pytest.approx(want, rel=1e-5)

    def test_full_extent_equals_unmasked(self, rng):
        a = torch.from_numpy(rng.random((12, 9, 3), dtype=np.float32))
        b = torch.from_numpy(rng.random((12, 9, 3), dtype=np.float32))
        assert float(metrics.psnr_masked(a, b, 12, 9)) == pytest.approx(
            float(metrics.psnr(a, b)), rel=1e-6)
        assert float(metrics.ssim_masked(a, b, 12, 9)) == pytest.approx(
            float(metrics.ssim(a, b)), rel=1e-6)

    def test_masked_ignores_padding(self, rng):
        a = rng.random((12, 9, 3), dtype=np.float32)
        b = rng.random((12, 9, 3), dtype=np.float32)
        a2, b2 = a.copy(), b.copy()
        a2[8:], b2[:, 6:] = 7.0, -3.0  # garbage outside the valid 8x6
        for fn in (metrics.psnr_masked, metrics.ssim_masked):
            assert float(fn(torch.from_numpy(a), torch.from_numpy(b), 8, 6)) == \
                float(fn(torch.from_numpy(a2), torch.from_numpy(b2), 8, 6))


def test_enhance_matches_jax(rng):
    x = rng.random((2, 9, 13, 3), dtype=np.float32) * 1.2 - 0.1
    for factor in (1.0, 0.5):
        want = np.asarray(j_enhance(jnp.asarray(x), factor=factor))
        got = enhance(torch.from_numpy(x), factor=factor).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


class TestServingSteps:
    @pytest.mark.parametrize("mode,dtype", [
        ("ensemble", "float32"), ("tta", "float32"), ("tta_ensemble", "float32"),
        ("ensemble", "bfloat16"), ("tta", "bfloat16"),
    ])
    def test_matches_jax(self, lr, mode, dtype):
        jm, p0, cfg = _jax_generator(0, compute_dtype=dtype)
        _, p1, _ = _jax_generator(1, compute_dtype=dtype)
        members = [_port(p0, cfg), _port(p1, cfg)]
        x, tx = jnp.asarray(lr), torch.from_numpy(lr)
        if mode == "ensemble":
            want = jsteps.infer_step_ensemble(jm.apply, _stack(p0, p1), x)
            got = steps.infer_step_ensemble(members, tx)
        elif mode == "tta":
            want = jsteps.infer_step_tta(jm.apply, p0, x)
            got = steps.infer_step_tta(members[0], tx)
        else:
            want = jsteps.infer_step_tta(jm.apply, _stack(p0, p1), x, ensemble=True)
            got = steps.infer_step_tta(members, tx, ensemble=True)
        _close(got.numpy(), want, BAR[dtype])
        if mode != "tta":
            # one module with the members' state_dicts: the same numbers
            sds = [m.state_dict() for m in members]
            fn = (steps.infer_step_ensemble if mode == "ensemble" else
                  lambda m, x, params: steps.infer_step_tta(m, x, True, params))
            assert torch.equal(fn(members[0], tx, params=sds), got)

    def test_dihedral_order_matches_jax(self, lr):
        """A position-dependent stand-in model: each of the 8 transforms
        and its inverse must be JAX's."""
        ramp = np.arange(14 * 10 * 3, dtype=np.float32).reshape(1, 10, 14, 3)

        def fwd_np(x):  # adds a ramp of x's own shape
            return x + np.resize(ramp, x.shape) / ramp.size

        want = jsteps._dihedral_mean(lambda x: jnp.asarray(fwd_np(np.asarray(x))),
                                     jnp.asarray(lr))
        got = steps._dihedral_mean(lambda x: torch.from_numpy(fwd_np(x.numpy())),
                                   torch.from_numpy(lr))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)

    @pytest.mark.parametrize("mode,enhance_out", [
        ("plain", False), ("plain", True), ("ensemble", True), ("tta", False),
        ("tta_ensemble", True),
    ])
    def test_u8_twins(self, lr, mode, enhance_out):
        jm, p0, cfg = _jax_generator(0)
        _, p1, _ = _jax_generator(1)
        members = [_port(p0, cfg), _port(p1, cfg)]
        x, tx = jnp.asarray(lr), torch.from_numpy(lr)
        if mode == "plain":
            want = jsteps.infer_step_u8(jm.apply, p0, x, enhance_out=enhance_out)
            got = steps.infer_step_u8(members[0], tx, enhance_out)
            sr = steps.infer_step(members[0], tx)
        elif mode == "ensemble":
            want = jsteps.infer_step_ensemble_u8(jm.apply, _stack(p0, p1), x,
                                                 enhance_out=enhance_out)
            got = steps.infer_step_ensemble_u8(members, tx, enhance_out)
            sr = steps.infer_step_ensemble(members, tx)
        else:
            ens = mode == "tta_ensemble"
            want = jsteps.infer_step_tta_u8(
                jm.apply, _stack(p0, p1) if ens else p0, x,
                enhance_out=enhance_out, ensemble=ens)
            got = steps.infer_step_tta_u8(members if ens else members[0], tx,
                                          enhance_out, ens)
            sr = steps.infer_step_tta(members if ens else members[0], tx, ens)
        _lsb(got.numpy(), np.asarray(want))
        # the device quantisation is the host formula, bit for bit
        if enhance_out:
            sr = enhance(sr)
        host = np.floor(np.clip(sr.numpy(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(got.numpy(), host)


def test_to_float01_matches_jax():
    dark = np.ones((4, 5, 3), np.uint8)  # every pixel 1: still /255
    cases = [dark, np.full((4, 5, 3), 200.0, np.float32),
             np.linspace(0, 1, 60, dtype=np.float32).reshape(4, 5, 3),
             np.linspace(0, 1, 60).reshape(4, 5, 3)]
    for arr in cases:
        got, want = tinf.to_float01(arr), jinf.to_float01(arr)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _write_png(path, arr):
    Image.fromarray(arr).save(path)


class TestPairedDataset:
    def test_matches_jax(self, tmp_path, rng):
        for sub, hw in (("lr", (6, 8)), ("hr", (12, 16))):
            os.makedirs(tmp_path / sub)
            for i in range(3):
                _write_png(tmp_path / sub / f"p{i}.png",
                           rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
        (tmp_path / "hr" / "p1.png").write_bytes(b"not an image")
        got = tdataset.PairedImageDataset(str(tmp_path), "lr", "hr")
        want = jdataset.PairedImageDataset(str(tmp_path), "lr", "hr")
        assert (got.dir1, got.files1, len(got)) == (want.dir1, want.files1, len(want))
        for i in range(3):
            g, w = got[i], want[i]
            assert (g is None) == (w is None) == (i == 1)
            if g is not None:
                for a, b in zip(g, w):
                    assert a.dtype == np.float32
                    np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tdataset.load_image_rgb(str(tmp_path / "lr" / "p0.png")),
            jdataset.load_image_rgb(str(tmp_path / "lr" / "p0.png")))

    def test_unequal_counts_assert_as_jax(self, tmp_path, rng):
        for sub, n in (("lr", 2), ("hr", 1)):
            os.makedirs(tmp_path / sub)
            for i in range(n):
                _write_png(tmp_path / sub / f"p{i}.png",
                           rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
        for mod in (tdataset, jdataset):
            with pytest.raises(AssertionError, match="the sizes have to be the same"):
                mod.PairedImageDataset(str(tmp_path), "lr", "hr")


def _upscalers(seed=0, enhance_output=False, **kw):
    jm, params, cfg = _jax_generator(seed, **kw)
    return (jinf.Upscaler(jm, params, enhance_output=enhance_output),
            tinf.Upscaler(_port(params, cfg), enhance_output=enhance_output,
                          device="cpu"))


class TestUpscaler:
    def test_upscale_u8_and_file_match_jax(self, tmp_path, rng):
        jup, tup = _upscalers(enhance_output=True)
        img = rng.random((10, 14, 3), dtype=np.float32)
        _close(tup.upscale(img), jup.upscale(img), BAR["float32"])
        _lsb(tup.upscale_u8(img), jup.upscale_u8(img))
        # uint8 input: divided on the device, the same numbers as /255
        img8 = (img * 255).astype(np.uint8)
        np.testing.assert_array_equal(
            tup.upscale(img8), tup.upscale(img8.astype(np.float32) / 255.0))
        _write_png(tmp_path / "in.png", img8)
        tup.upscale_file(str(tmp_path / "in.png"), str(tmp_path / "t.png"))
        jup.upscale_file(str(tmp_path / "in.png"), str(tmp_path / "j.png"))
        _lsb(np.asarray(Image.open(tmp_path / "t.png")),
             np.asarray(Image.open(tmp_path / "j.png")))

    def test_tiled(self, rng):
        jup, tup = _upscalers(norm="none")
        img = rng.random((48, 64, 3), dtype=np.float32)
        # one tile is the direct path
        small = img[:16, :16]
        np.testing.assert_allclose(tup.upscale_tiled(small, tile=16, overlap=4),
                                   tup.upscale(small), atol=1e-6, rtol=0)
        # overlap 20 covers the receptive field: exact, and JAX's blend
        tiled = tup.upscale_tiled(img, tile=32, overlap=20, batch_size=4)
        np.testing.assert_allclose(tiled, tup.upscale(img), atol=1e-4, rtol=0)
        _close(tiled, jup.upscale_tiled(img, tile=32, overlap=20, batch_size=4),
               BAR["float32"])
        # tiny image: reflect-padded up to one tile
        tiny = img[:10, :7]
        out = tup.upscale_tiled(tiny, tile=16, overlap=4)
        assert out.shape == (20, 14, 3)
        _close(out, jup.upscale_tiled(tiny, tile=16, overlap=4), BAR["float32"])
        # uint8 tiles: within one step of JAX's
        got = tup.upscale_tiled(img, tile=32, overlap=20, batch_size=4, fetch_u8=True)
        want = jup.upscale_tiled(img, tile=32, overlap=20, batch_size=4, fetch_u8=True)
        assert np.abs(got - want).max() <= LSB + 1e-6

    def test_entry_points_ask_for_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tinf.Upscaler.random_init(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            tinf.upscale_directory("nowhere", "nowhere")

    def test_leaves_tf32_off(self):
        flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
        try:
            for f in flags:
                f.allow_tf32 = True
            tinf.Upscaler.random_init(
                ModelConfig(num_features=8, num_residuals=1, upscale_factor=2),
                device="cpu")
            assert [f.allow_tf32 for f in flags] == [False, False]
        finally:
            for f in flags:
                f.allow_tf32 = False

    def test_ensemble_needs_the_flag(self):
        m = SRResNet.from_config(ModelConfig(num_features=8, num_residuals=1))
        with pytest.raises(ValueError, match="ensemble=True"):
            tinf.Upscaler([m, m], device="cpu")


def _save(results, params_list, cfg, ema_params=None, prefix="Training"):
    """A port snapshot of the bridged generators (``save_checkpoint``)."""
    states = []
    for params in params_list:
        state = TrainState(_port(params, cfg), ema_decay=0.5 if ema_params else 0.0)
        if ema_params:
            with torch.no_grad():
                sd = from_jax_params(ema_params)
                names = [n for n, _ in state.model.named_parameters()]
                for t, n in zip(state.ema_params, names):
                    t.copy_(sd[n])
        states.append(state)
    ckpt.save_checkpoint(str(results), prefix, pool=tpool.GeneratorPool(
        states, PoolConfig(num_generators=len(states))), epoch=1,
        model_config=ModelConfig(**cfg))


class TestFromCheckpoint:
    def test_plain_ensemble_ema_match_jax(self, tmp_path, lr):
        jm, p0, cfg = _jax_generator(0)
        _, p1, _ = _jax_generator(1)
        _, pe, _ = _jax_generator(2)
        _save(tmp_path / "pool", [p0, p1], cfg)
        _save(tmp_path / "one", [p0], cfg, ema_params=pe)
        cases = [
            (tinf.Upscaler.from_checkpoint(str(tmp_path / "pool"), device="cpu"),
             jinf.Upscaler(jm, p0)),
            (tinf.Upscaler.from_checkpoint(str(tmp_path / "pool"), ensemble=True,
                                           device="cpu"),
             jinf.Upscaler(jm, _stack(p0, p1), ensemble=True)),
            (tinf.Upscaler.from_checkpoint(str(tmp_path / "one"), ema=True,
                                           device="cpu"),
             jinf.Upscaler(jm, pe)),
        ]
        for got, want in cases:
            _close(got.upscale(lr), want.upscale(lr), BAR["float32"])
        assert len(cases[1][0].members) == 2 and cases[1][0].ensemble
        # a one-member snapshot with ensemble=True serves the plain forward
        one = tinf.Upscaler.from_checkpoint(str(tmp_path / "one"), ensemble=True,
                                            device="cpu")
        assert not one.ensemble
        np.testing.assert_array_equal(
            one.upscale(lr), tinf.Upscaler(_port(p0, cfg), device="cpu").upscale(lr))

    def test_raises_as_jax(self, tmp_path):
        empty = str(tmp_path / "empty")
        for cls in (tinf.Upscaler, jinf.Upscaler):
            with pytest.raises(FileNotFoundError, match="sidecar"):
                cls.from_checkpoint(empty)
        _, p0, cfg = _jax_generator(0)
        _save(tmp_path / "no_ema", [p0], cfg)
        with pytest.raises(KeyError, match="has no EMA shadows"):
            tinf.Upscaler.from_checkpoint(str(tmp_path / "no_ema"), ema=True,
                                          device="cpu")


class _RefBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv1 = nn.Conv2d(f, f, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(f)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(f)

    def forward(self, x):
        return self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x))))) + x


class _RefSRResNet(nn.Module):
    """The reference's state_dict layout (``src/models.py:44-87``) at small
    widths, as in ``tests/test_torch_port.py``."""

    def __init__(self, f=8, blocks=2, upscale=4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, f, 9, padding=4)
        self.residual_blocks = nn.Sequential(*[_RefBlock(f) for _ in range(blocks)])
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)
        layers = []
        for _ in range(upscale // 2):
            layers += [nn.Conv2d(f, 4 * f, 3, padding=1), nn.PixelShuffle(2), nn.ReLU()]
        self.upsample = nn.Sequential(*layers)
        self.conv3 = nn.Conv2d(f, 3, 9, padding=4)

    def forward(self, x):
        h = F.leaky_relu(self.conv1(x), 0.2)
        return self.conv3(self.upsample(self.conv2(self.residual_blocks(h)) + h))


@pytest.mark.parametrize("ddp_prefix", [False, True])
def test_from_torch_checkpoint_matches_jax(tmp_path, lr, ddp_prefix):
    torch.manual_seed(0)
    ref = _RefSRResNet()
    with torch.no_grad():  # random BN running stats, so the fold matters
        for m in ref.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
    ref.eval()
    sd = ref.state_dict()
    if ddp_prefix:
        sd = {f"module.{k}": v for k, v in sd.items()}
    path = str(tmp_path / "g.pth")
    torch.save(sd, path)
    got = tinf.Upscaler.from_torch_checkpoint(path, device="cpu")
    assert got.model.norm == "none" and got.model.head == "reference"
    want = jinf.Upscaler.from_torch_checkpoint(path).upscale(lr)
    _close(got.upscale(lr), want, BAR["float32"])
    with torch.no_grad():
        direct = ref(torch.from_numpy(lr).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.upscale(lr), direct.clamp(0, 1).numpy(), BAR["float32"])


def _serving_folder(root, rng):
    """5 images of one size (a direct bucket: 4 + a tail of 1 at batch 4),
    2 of distinct odd sizes (the tiled route) and a corrupt file."""
    os.makedirs(root)
    for i in range(5):
        _write_png(os.path.join(root, f"d{i}.png"),
                   rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
    for name, hw in (("odd_a.png", (10, 14)), ("odd_b.jpg", (20, 9))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(root, name), quality=95)
    with open(os.path.join(root, "broken.png"), "wb") as f:
        f.write(b"\x89PNG not really")


def test_upscale_directory_matches_jax(tmp_path, rng, capsys):
    jup, tup = _upscalers(seed=3)
    src = str(tmp_path / "in")
    _serving_folder(src, rng)
    kw = dict(batch_size=4, tile=32, tile_batch=2, tile_overlap=8)
    n_t = tinf.upscale_directory(src, str(tmp_path / "t"), upscaler=tup, **kw)
    err = capsys.readouterr().err
    assert "1 direct size bucket(s), 2 odd-size file(s)" in err
    assert "7 image(s)" in err
    n_j = jinf.upscale_directory(src, str(tmp_path / "j"), upscaler=jup, **kw)
    assert n_t == n_j == 7
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert "broken.png" not in names
    for name in names:
        a = np.asarray(Image.open(tmp_path / "t" / name))
        b = np.asarray(Image.open(tmp_path / "j" / name))
        src_hw = Image.open(os.path.join(src, name)).size[::-1]
        assert a.shape[:2] == (2 * src_hw[0], 2 * src_hw[1])
        if name.endswith(".jpg"):  # lossy encode: compare what was encoded
            continue
        _lsb(a, b)


def test_upscale_directory_skips_an_unwritable_file(tmp_path, rng, capsys):
    _, tup = _upscalers(seed=3)
    src, out = str(tmp_path / "in"), tmp_path / "out"
    _serving_folder(src, rng)
    os.makedirs(out / "d1.png")  # a directory where the output file goes
    n = tinf.upscale_directory(src, str(out), upscaler=tup, batch_size=4,
                               tile=32, tile_batch=2, tile_overlap=8)
    assert n == 6
    assert "failed to encode" in capsys.readouterr().err


def test_resize_weight_cache_is_bounded():
    resize._weights.cache_clear()
    resize._weights_np.cache_clear()
    x = torch.rand(1, 6, 5, 3)
    first = resize.resize_bilinear(x, (4, 5))
    for h in range(2, 2 + resize.WEIGHT_CACHE_SIZE + 20):
        resize.resize_bilinear(x, (h, 5))
    for fn in (resize._weights, resize._weights_np):
        info = fn.cache_info()
        assert info.maxsize == resize.WEIGHT_CACHE_SIZE == 64
        assert info.currsize <= info.maxsize
    # an evicted pair is rebuilt with the same numbers
    assert torch.equal(resize.resize_bilinear(x, (4, 5)), first)
