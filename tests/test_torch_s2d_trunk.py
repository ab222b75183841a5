"""The port's space-to-depth trunk (``srgan_tpu_torch/models/s2d_trunk.py``)
against JAX's (``srgan_tpu/models/s2d_trunk.py``), mirroring the four tests
of ``tests/test_s2d_trunk.py`` with the weights carried across by the
bridge (``utils/params.py``): the fold, the fine trunk, the s2d trunk's
equality to it, and the gradients that reach the fine parameters. Sizes
and bars as there: F=16, 3 blocks, 4 groups, out1 (2, 12, 16, 16);
rtol/atol 1e-5 (fold, fine trunk), 2e-4 (s2d trunk), 5e-3 (gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srgan_tpu.models import s2d_trunk as js2d
from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models import s2d_trunk as ts2d
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from srgan_tpu_torch.utils.params import to_jax_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(num_features=16, num_residuals=3, group_norm_groups=4)
    model = init_generator(cfg, seed=0)
    with torch.no_grad():  # non-zero biases and GN affines, so a dropped one shows
        g = torch.Generator().manual_seed(5)
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    params = jax.tree.map(jnp.asarray, to_jax_params(model.state_dict()))
    x = np.random.default_rng(1).random((2, 12, 16, 16)).astype(np.float32)
    return cfg, model, params, x


def _kw(cfg):
    return dict(num_residuals=cfg.num_residuals, group_norm_groups=cfg.group_norm_groups)


def test_fold_conv3x3_exact():
    rng = np.random.default_rng(2)
    k = rng.standard_normal((3, 3, 6, 10)).astype(np.float32)  # HWIO
    b = rng.standard_normal(10).astype(np.float32)
    x = rng.standard_normal((2, 8, 12, 6)).astype(np.float32)
    kc, bc = ts2d.fold_conv3x3_to_s2d(torch.from_numpy(k).permute(3, 2, 0, 1),
                                      torch.from_numpy(b))
    assert kc.shape == (40, 24, 3, 3)
    assert int((kc != 0).sum()) <= 9 * 6 * 10 * 4  # 25% density
    jkc, jbc = js2d.fold_conv3x3_to_s2d(jnp.asarray(k), jnp.asarray(b))
    np.testing.assert_array_equal(kc.permute(2, 3, 1, 0).numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jbc))

    xt = torch.from_numpy(x)
    fine = F.conv2d(xt.permute(0, 3, 1, 2), torch.from_numpy(k).permute(3, 2, 0, 1),
                    torch.from_numpy(b), padding=1).permute(0, 2, 3, 1)
    coarse = F.conv2d(pixel_unshuffle(xt, 2).permute(0, 3, 1, 2), kc, bc,
                      padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(pixel_shuffle(coarse, 2).numpy(), fine.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_fine_trunk_matches_jax_and_the_model(tiny):
    """The port's fine trunk against JAX's on the same params, and against
    the model's own blocks + mid conv + global skip."""
    cfg, model, params, x = tiny
    got = ts2d.fine_trunk(model, torch.from_numpy(x))
    want = js2d.fine_trunk(params, jnp.asarray(x), **_kw(cfg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        x1 = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = x1
        for blk in model.blocks:
            out = blk(out)
        out = (model.mid(out) + x1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), out.numpy(), rtol=1e-5, atol=1e-5)


def test_s2d_trunk_equals_fine_trunk(tiny):
    cfg, model, params, x = tiny
    a = ts2d.fine_trunk(model, torch.from_numpy(x))
    b = ts2d.s2d_trunk(model, torch.from_numpy(x))
    assert b.shape == a.shape
    np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=2e-4, atol=2e-4)
    want = js2d.s2d_trunk(params, jnp.asarray(x), **_kw(cfg))
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_s2d_trunk_gradients_flow(tiny):
    """The fold is a static gather: the gradients reach the fine params, equal
    to the fine trunk's and to JAX's s2d trunk's."""
    cfg, model, params, x = tiny
    xt = torch.from_numpy(x)
    trunk = [p for n, p in model.named_parameters() if n.startswith(("blocks.", "mid."))]
    g_fine = torch.autograd.grad(ts2d.fine_trunk(model, xt).square().sum(), trunk)
    g_s2d = torch.autograd.grad(ts2d.s2d_trunk(model, xt).square().sum(), trunk)
    for gf, gs in zip(g_fine, g_s2d):
        np.testing.assert_allclose(gs.numpy(), gf.numpy(), rtol=5e-3, atol=5e-3)

    sub = {k: v for k, v in params.items() if k.startswith("ResidualBlock_") or k == "Conv_1"}
    jg = jax.grad(lambda p: jnp.sum(js2d.s2d_trunk(p, jnp.asarray(x), **_kw(cfg)) ** 2))(sub)
    names = [n for n, p in model.named_parameters() if n.startswith(("blocks.", "mid."))]
    got = to_jax_params(dict(zip(names, g_s2d)))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jg):
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(leaf), rtol=5e-3, atol=5e-3)
