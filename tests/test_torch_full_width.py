"""The port at the flagship's layer shapes (F=64, 16 residual blocks, the 4x
subpixel head) against the JAX package, on an LR image of 8x16: the fp32
forward, one fp32 pixel step and the bf16 forward, from the same weights
(the port's seeded init, bridged to the flax tree: a flax init at this
width costs ~10 s of compile).

Tolerances: fp32 forward max|Δ| ≤ 1e-4·max|y| (measured 1.6e-5 of max|y|
~1.5: the sums of 16 blocks run in another order; elementwise, values near
0 differ by more than 1e-4 of themselves); step
losses rel 1e-4 and params atol 2·lr (one Adam step moves a weight by about
lr whatever its gradient's size); bf16 forward max|Δ| ≤ 2e-2·max|y|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.models.srresnet import SRResNet as JSRResNet
from srgan_tpu.training import steps as jsteps
from srgan_tpu.training import train_state as jts
from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.srresnet import SRResNet, init_generator
from srgan_tpu_torch.training import steps as tsteps
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.utils.params import from_jax_params, to_jax_params

torch.set_num_threads(1)

FULL = dict(num_features=64, num_residuals=16, upscale_factor=4, head="subpixel")


@pytest.fixture(scope="module")
def weights():
    # numpy leaves: the JAX step donates its input buffers
    params = to_jax_params(init_generator(ModelConfig(**FULL), seed=3).state_dict())
    return JSRResNet.from_config(JModelConfig(**FULL)), params


@pytest.fixture
def batch():
    rng = np.random.default_rng(0)
    hr = np.zeros((2, 32, 64, 3), np.float32)
    for i in range(2):  # sparse edges: the TV term is live
        y, x = rng.integers(2, 24), rng.integers(2, 54)
        hr[i, y:y + 6, x:x + 6] = rng.uniform(0.5, 1.0, 3)
    return hr, rng.random((2, 8, 16, 3)).astype(np.float32)


def _port(params, compute_dtype="float32"):
    model = SRResNet.from_config(ModelConfig(compute_dtype=compute_dtype, **FULL))
    model.load_state_dict(from_jax_params(params))
    return model


def test_fp32_forward_and_step(weights, batch):
    model_j, params = weights
    hr, lr_imgs = batch
    want = np.asarray(model_j.apply({"params": params}, jnp.asarray(lr_imgs)))
    model_t = _port(params)
    with torch.no_grad():
        got = model_t(torch.from_numpy(lr_imgs)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())

    lr = 1e-4
    j_state = jts.TrainState.create(apply_fn=model_j.apply, params=params)
    j_state, m_j = jsteps.generator_pixel_step(
        j_state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(lr)
    )
    t_state, m_t = tsteps.generator_pixel_step(
        tts.TrainState(model_t), torch.from_numpy(hr), torch.from_numpy(lr_imgs), lr
    )
    assert float(m_t["tv_loss"]) > 0.0
    np.testing.assert_allclose(m_t["packed"].numpy(), np.asarray(m_j["packed"]),
                               rtol=1e-4, atol=1e-7)
    got_p = to_jax_params(model_t.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(jax.device_get(j_state.params))
    # stem, mid, 2 upsample convs and the tail; 2 convs and 2 norms a block
    assert len(leaves) == 2 * 5 + 8 * 16
    for path, leaf in leaves:
        node = got_p
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, leaf, atol=2 * lr)


def test_bf16_forward(weights, batch):
    _, params = weights
    _, lr_imgs = batch
    model_j = JSRResNet.from_config(JModelConfig(compute_dtype="bfloat16", **FULL))
    want = np.asarray(model_j.apply({"params": params}, jnp.asarray(lr_imgs)))
    with torch.no_grad():
        got = _port(params, "bfloat16")(torch.from_numpy(lr_imgs))
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())
