"""The port's generator, pixel shuffle and weight bridge against the JAX
package: same inputs (numpy, seeded), same weights through the bridge.

Forward tolerance atol 1e-4: flax's GroupNorm takes the variance as
E[x²]−E[x]² and torch as E[(x−μ)²], and the conv sums run in another
order; both differ only by fp32 rounding. In bf16, max|Δ| ≤ 2e-2·max|y|
(the tower tests' bar): the two packages round the same values to bf16 at
the same points, but a conv's f32 sum in another order can round to the
next bf16 value, about 4e-3 relative, and later layers carry that on.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.ops.pixel_shuffle import pixel_shuffle as j_pixel_shuffle
from srgan_tpu.ops.pixel_shuffle import pixel_unshuffle as j_pixel_unshuffle
from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.srresnet import SRResNet, init_generator
from srgan_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from srgan_tpu_torch.utils.params import from_jax_params, to_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_generator(rng, **kw):
    """A JAX generator with every leaf perturbed, so the conv biases and
    GroupNorm affines (zeros/ones at init) are exercised by the bridge."""
    cfg = JModelConfig(num_features=8, num_residuals=2, **kw)
    model, params = j_init_generator(cfg, jax.random.key(0), sample_hw=(8, 16))
    params = jax.tree.map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32),
        jax.device_get(params),
    )
    return model, params


def _port(params, **kw) -> SRResNet:
    model = SRResNet.from_config(ModelConfig(num_features=8, num_residuals=2, **kw))
    model.load_state_dict(from_jax_params(params))  # strict: every key maps
    return model


class TestPixelShuffle:
    @pytest.mark.parametrize("r", [2, 4])
    def test_shuffle_matches_jax(self, rng, r):
        x = rng.random((2, 3, 5, 3 * r * r)).astype(np.float32)
        want = np.asarray(j_pixel_shuffle(jnp.asarray(x), r))
        got = pixel_shuffle(torch.from_numpy(x), r).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("r", [2, 4])
    def test_unshuffle_matches_jax(self, rng, r):
        x = rng.random((2, 4 * r, 2 * r, 3)).astype(np.float32)
        want = np.asarray(j_pixel_unshuffle(jnp.asarray(x), r))
        got = pixel_unshuffle(torch.from_numpy(x), r).numpy()
        np.testing.assert_array_equal(got, want)
        back = pixel_shuffle(torch.from_numpy(got), r).numpy()
        np.testing.assert_array_equal(back, x)

    @pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
    @pytest.mark.parametrize("op", ["shuffle", "unshuffle"])
    def test_model_helpers_match_torch_and_stay_channels_last(self, rng, op, layout):
        """The model's (un)shuffle of an NCHW-shaped batch equals
        ``F.pixel_(un)shuffle`` bit for bit, in value and in gradient (a
        channels-last input's gradient in channels-last memory), and returns
        channels-last memory whatever the input's layout."""
        import torch.nn.functional as F

        from srgan_tpu_torch.models import srresnet

        shape = (2, 12, 6, 10) if op == "shuffle" else (2, 3, 6, 10)
        helper, ref = ((srresnet.pixel_shuffle, F.pixel_shuffle) if op == "shuffle"
                       else (srresnet.pixel_unshuffle, F.pixel_unshuffle))
        x = torch.from_numpy(rng.random(shape).astype(np.float32))
        x = x.contiguous(memory_format={"channels_last": torch.channels_last,
                                        "contiguous": torch.contiguous_format}[layout])
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        got, want = helper(xa), ref(xb, 2)
        assert torch.equal(got, want)
        assert got.is_contiguous(memory_format=torch.channels_last)
        g = torch.from_numpy(rng.random(tuple(want.shape)).astype(np.float32))
        g = g.contiguous(memory_format=torch.channels_last)
        got.backward(g)
        want.backward(g)
        assert torch.equal(xa.grad, xb.grad)
        if layout == "channels_last":  # a leaf's gradient takes the leaf's layout
            assert xa.grad.is_contiguous(memory_format=torch.channels_last)

    def test_bad_channels_raise(self):
        with pytest.raises(ValueError):
            pixel_shuffle(torch.zeros(1, 2, 2, 6), 2)
        with pytest.raises(ValueError):
            pixel_unshuffle(torch.zeros(1, 3, 2, 3), 2)


def test_model_lays_its_input_out_channels_last():
    """Whatever the strides of the NHWC batch (batch prep's resize einsum
    leaves its LR (B, H, C, W)-ordered), the stem gets a channels-last
    tensor, so cuDNN runs the model NHWC from its first conv; the output is
    a contiguous NHWC batch with the values of the NHWC-contiguous input's."""
    from srgan_tpu_torch.ops.resize import prepare_batch

    model = SRResNet(num_features=8, num_residuals=1)
    hr_u8 = torch.randint(0, 256, (2, 32, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    _, lr = prepare_batch(hr_u8, torch.Generator().manual_seed(1))
    assert not lr.is_contiguous()
    seen = []
    model.stem.register_forward_pre_hook(lambda mod, args: seen.append(
        args[0].is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        out = model(lr)
        want = model(lr.contiguous())
    assert seen == [True, True]
    assert out.is_contiguous() and torch.equal(out, want)


class TestSRResNetParity:
    @pytest.mark.parametrize(
        "head,factor",
        [("subpixel", 2), ("subpixel", 4), ("coarse", 2), ("coarse", 4),
         ("reference", 2), ("reference", 4)],
    )
    def test_forward_matches_jax(self, rng, head, factor):
        model_j, params = _jax_generator(rng, upscale_factor=factor, head=head)
        x = rng.random((2, 8, 16, 3)).astype(np.float32)
        want = np.asarray(model_j.apply({"params": params}, jnp.asarray(x)))
        model_t = _port(params, upscale_factor=factor, head=head)
        with torch.no_grad():
            got = model_t(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 8 * factor, 16 * factor, 3)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_norm_none_matches_jax(self, rng):
        model_j, params = _jax_generator(rng, upscale_factor=2, norm="none")
        x = rng.random((1, 8, 16, 3)).astype(np.float32)
        want = np.asarray(model_j.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = _port(params, upscale_factor=2, norm="none")(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    def test_remat_same_output_and_grads(self, rng):
        _, params = _jax_generator(rng, upscale_factor=2)
        x = torch.from_numpy(rng.random((1, 8, 16, 3)).astype(np.float32))
        outs = []
        for remat in (False, True):
            m = _port(params, upscale_factor=2, remat=remat)
            y = m(x)
            grads = torch.autograd.grad(y.square().sum(), list(m.parameters()))
            outs.append((y.detach(), grads))
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
        for a, b in zip(outs[0][1], outs[1][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


class TestBFloat16:
    @pytest.mark.parametrize("head", ["subpixel", "coarse", "reference"])
    def test_forward_matches_flax_bf16(self, rng, head):
        model_j, params = _jax_generator(rng, upscale_factor=4, head=head,
                                         compute_dtype="bfloat16")
        x = rng.random((2, 8, 16, 3)).astype(np.float32)
        want = np.asarray(model_j.apply({"params": params}, jnp.asarray(x)))
        assert want.dtype == np.float32
        model_t = _port(params, upscale_factor=4, head=head, compute_dtype="bfloat16")
        with torch.no_grad():
            got = model_t(torch.from_numpy(x))
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 2e-2 * float(np.abs(want).max())

    @pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
    def test_dtypes_where_flax_puts_them(self, rng, remat):
        """f32 params and f32 grads (the master copy), a bf16 block carry and
        bf16 block internals, an f32 output; remat gives the same bits."""
        _, params = _jax_generator(rng, upscale_factor=2)
        model = _port(params, upscale_factor=2, remat=remat, compute_dtype="bfloat16")
        seen = {}

        def record(name):
            def hook(module, args, out):
                seen[name] = (args[0].dtype, out.dtype)
            return hook

        model.blocks[1].register_forward_hook(record("block"))
        model.blocks[0].norm1.register_forward_hook(record("norm"))
        model.blocks[0].conv2.register_forward_hook(record("conv"))
        x = torch.from_numpy(rng.random((1, 8, 16, 3)).astype(np.float32))
        y = model(x)
        assert y.dtype == torch.float32
        assert seen["block"] == (torch.bfloat16, torch.bfloat16)  # the carry
        assert seen["norm"] == (torch.bfloat16, torch.bfloat16)
        assert seen["conv"] == (torch.bfloat16, torch.bfloat16)
        grads = torch.autograd.grad(y.square().sum(), list(model.parameters()))
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(g.dtype == torch.float32 and g.abs().sum() > 0 for g in grads)
        if remat:
            plain = _port(params, upscale_factor=2, compute_dtype="bfloat16")
            torch.testing.assert_close(plain(x), y, rtol=0, atol=0)


class TestBridge:
    @pytest.mark.parametrize("head", ["subpixel", "coarse", "reference"])
    def test_round_trip(self, rng, head):
        _, params = _jax_generator(rng, upscale_factor=4, head=head)
        back = to_jax_params(from_jax_params(params))
        flat_a = jax.tree_util.tree_leaves_with_path(params)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf)

    @pytest.mark.parametrize("head", ["subpixel", "reference"])
    def test_init_matches_flax_layout(self, head):
        """The port's own init has the flax tree's keys and shapes, and the
        same lecun-normal scale."""
        cfg_j = JModelConfig(num_features=16, num_residuals=2, head=head)
        _, params = j_init_generator(cfg_j, jax.random.key(0), sample_hw=(8, 8))
        want = from_jax_params(jax.device_get(params))
        got = init_generator(
            ModelConfig(num_features=16, num_residuals=2, head=head), seed=3
        ).state_dict()
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()
        }
        w_t, w_j = got["blocks.0.conv1.weight"], want["blocks.0.conv1.weight"]
        assert float(w_t.std()) == pytest.approx(float(w_j.std()), rel=0.1)
        assert float(got["blocks.0.conv1.bias"].abs().max()) == 0.0
        assert float(got["blocks.1.norm2.weight"].min()) == 1.0

    def test_init_is_seeded(self):
        cfg = ModelConfig(num_features=8, num_residuals=1)
        a = init_generator(cfg, seed=0).state_dict()
        b = init_generator(cfg, seed=0).state_dict()
        c = init_generator(cfg, seed=1).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["stem.weight"], c["stem.weight"])


class TestConfigErrors:
    def test_bad_factor_head_norm_raise(self):
        with pytest.raises(ValueError, match="power of two"):
            SRResNet(upscale_factor=3)
        with pytest.raises(ValueError, match="head"):
            SRResNet(head="Reference")
        with pytest.raises(ValueError, match="norm"):
            SRResNet(norm="Group")

    def test_bfloat16_names_roadmap(self):
        """bf16 compute is ported: "bfloat16" builds; any other dtype than
        it and "float32" raises, as the JAX package's ``_dtype`` does."""
        from srgan_tpu.models.srresnet import _dtype as j_dtype

        assert SRResNet.from_config(
            ModelConfig(compute_dtype="bfloat16")).compute_dtype == torch.bfloat16
        for bad in ("float16", "bf16", "float64"):
            with pytest.raises(KeyError):
                j_dtype(bad)
            with pytest.raises(ValueError, match="compute_dtype"):
                SRResNet.from_config(ModelConfig(compute_dtype=bad))

    def test_config_defaults_match_jax(self):
        import dataclasses

        import srgan_tpu.config as jc
        import srgan_tpu_torch.config as tc

        for name in ("ModelConfig", "DiscriminatorConfig", "DataConfig",
                     "PoolConfig", "MeshConfig", "TrainConfig"):
            port = dataclasses.asdict(getattr(tc, name)())
            if name == "ModelConfig":
                # the port's own fields: the architecture's name and SwinIR's
                # widths, at defaults that build SRResNet
                own = {k: port.pop(k) for k in tc.PORT_ONLY_FIELDS}
                assert own == {"generator": "srresnet", "embed_dim": 180,
                               "depths": (6,) * 6, "num_heads": (6,) * 6,
                               "window_size": 8, "mlp_ratio": 2.0}
                assert tc.shared_fields(tc.ModelConfig()) == port
            want = dataclasses.asdict(getattr(jc, name)())
            if name == "PoolConfig":
                # JAX's choice of pool layout: the port has one pool
                assert want.pop("stacked") is True
            assert port == want, name


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|srgan_tpu)(\.|\s|$)", re.M
)


class TestImports:
    def test_port_imports_no_jax(self):
        """Every module of the port (and chip_smoke.py) imports with JAX,
        flax, optax, orbax and the JAX package made unimportable, and with
        PIL and matplotlib too (imported only where an image is drawn or
        decoded)."""
        code = (
            "import sys, pkgutil, importlib\n"
            "for n in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'srgan_tpu',\n"
            "          'PIL', 'matplotlib'):\n"
            "    sys.modules[n] = None\n"
            "import srgan_tpu_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    srgan_tpu_torch.__path__, 'srgan_tpu_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "print(' '.join(names))\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        names = set(out.stdout.split())
        assert len(names) >= 40
        assert {"srgan_tpu_torch.eval.inference", "srgan_tpu_torch.eval.evaluation",
                "srgan_tpu_torch.models.enhancer",
                "srgan_tpu_torch.utils.torch_port", "srgan_tpu_torch.models.vgg",
                "srgan_tpu_torch.models.encoder",
                "srgan_tpu_torch.training.encoder_train",
                "srgan_tpu_torch.parallel.mesh", "srgan_tpu_torch.parallel.data_parallel",
                "srgan_tpu_torch.utils.profiling", "srgan_tpu_torch.native",
                "srgan_tpu_torch.parallel.spatial", "srgan_tpu_torch.models.s2d_trunk"} <= names

    def test_no_import_lines_of_jax(self):
        files = sorted((REPO / "srgan_tpu_torch").rglob("*.py"))
        files.append(REPO / "chip_smoke.py")
        bad = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
        assert not bad
