"""The port's residual tower (``srgan_tpu_torch.ops.cuda.residual_tower_kernel``)
against the JAX package's (``srgan_tpu.ops.pallas.residual_tower_kernel``),
whose Pallas kernels run in interpret mode as ``tests/test_tower_kernel.py``
runs them on the CPU. On the CPU the port's op is its plain version under
autograd; the CUDA kernels K4/K5 are held against that plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Sizes follow ``tests/test_tower_kernel.py``: N=2, F=16, x (2, 8, 16, 16) in
f32; N=4, x (1, 8, 16, 16) in bf16. Tolerances: forward rtol 1e-4 atol
1e-5, gradients rtol 1e-3 atol 1e-4 (f32); bf16 max|Δ| ≤ 2e-2·max, the JAX
test's bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srgan_tpu.ops.pallas.residual_tower_kernel as jtk
from srgan_tpu_torch.models.srresnet import ResidualBlock
from srgan_tpu_torch.ops.cuda import residual_tower_kernel as ttk
from srgan_tpu_torch.utils.params import tower_params_from_jax, tower_params_to_jax

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jtk, "_INTERPRET", True)


def _inputs(seed, n, shape):
    """x, dy and JAX TowerParams (numpy) made like the JAX tests' params."""
    rng = np.random.default_rng(seed)
    f = shape[-1]
    w = lambda: (0.1 * rng.standard_normal((n, 3, 3, f, f))).astype(np.float32)
    full = lambda v: np.full((n, f), v, np.float32)
    params = jtk.TowerParams(w1=w(), s1=full(1.1), b1=full(0.05),
                             w2=w(), s2=full(0.9), b2=full(-0.02))
    x = rng.standard_normal(shape).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, dy, params


def _jax_grads(x, dy, params, compute_dtype=jnp.float32):
    def loss(x_, p_):
        return jnp.sum(jtk.residual_tower(x_, p_, compute_dtype) * dy)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), params)
    return [np.asarray(gx, np.float32)] + [
        np.asarray(getattr(gp, k), np.float32) for k in jtk.TowerParams._fields
    ]


def _port_grads(x, dy, params, compute_dtype=torch.float32):
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = [p.requires_grad_(True) for p in tower_params_from_jax(params)]
    y = ttk.residual_tower(xt, ttk.TowerParams(*pt), compute_dtype)
    grads = torch.autograd.grad(y, [xt, *pt], torch.from_numpy(dy))
    return y.detach().numpy(), [g.numpy() for g in grads]


NAMES = ["dx", *jtk.TowerParams._fields]


class TestForward:
    @pytest.mark.parametrize("oracle", ["kernel", "reference"])
    def test_matches_jax(self, oracle):
        x, _, params = _inputs(0, 2, (2, 8, 16, 16))
        fn = jtk.residual_tower if oracle == "kernel" else jtk.residual_tower_reference
        want = np.asarray(fn(jnp.asarray(x), params))
        got = ttk.residual_tower(torch.from_numpy(x), tower_params_from_jax(params))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    def test_plain_equals_reference_in_f32(self):
        x, _, params = _inputs(1, 2, (1, 8, 8, 16))
        xt, pt = torch.from_numpy(x), tower_params_from_jax(params)
        torch.testing.assert_close(
            ttk.residual_tower_plain(xt, pt), ttk.residual_tower_reference(xt, pt),
            rtol=0, atol=0,
        )

    def test_reference_matches_residual_blocks(self):
        """The port's oracle equals a chain of the port's ResidualBlocks
        with zero conv biases (the counterpart of
        ``test_reference_matches_flax_block``)."""
        f, n = 16, 2
        x, _, params = _inputs(2, n, (1, 8, 8, f))
        pt = tower_params_from_jax(params)
        blocks = []
        for i in range(n):
            blk = ResidualBlock(f)
            with torch.no_grad():
                blk.conv1.weight.copy_(pt.w1[i].permute(3, 2, 0, 1))
                blk.conv2.weight.copy_(pt.w2[i].permute(3, 2, 0, 1))
                blk.conv1.bias.zero_()
                blk.conv2.bias.zero_()
                blk.norm1.weight.copy_(pt.s1[i])
                blk.norm1.bias.copy_(pt.b1[i])
                blk.norm2.weight.copy_(pt.s2[i])
                blk.norm2.bias.copy_(pt.b2[i])
            blocks.append(blk)
        with torch.no_grad():
            want = torch.nn.Sequential(*blocks)(torch.from_numpy(x).permute(0, 3, 1, 2))
            got = ttk.residual_tower_reference(torch.from_numpy(x), pt)
        np.testing.assert_allclose(
            got.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=1e-4, atol=1e-5
        )


class TestBackward:
    def test_grads_match_jax(self):
        x, dy, params = _inputs(3, 2, (2, 8, 16, 16))
        want = _jax_grads(x, dy, params)
        _, got = _port_grads(x, dy, params)
        for name, a, b in zip(NAMES, got, want):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4, err_msg=name)


class TestBfloat16:
    def test_forward_and_grads_match_jax(self):
        """bf16 compute against the JAX op in bf16 (its kernels K4 and K5),
        with the JAX test's bar: max|Δ| ≤ 2e-2·max."""
        x, dy, params = _inputs(4, 4, (1, 8, 16, 16))
        y_want = np.asarray(
            jtk.residual_tower(jnp.asarray(x), params, jnp.bfloat16), np.float32
        )
        want = _jax_grads(x, dy, params, jnp.bfloat16)
        y_got, got = _port_grads(x, dy, params, torch.bfloat16)
        for name, a, b in zip(["y", *NAMES], [y_got, *got], [y_want, *want]):
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= 2e-2, f"{name}: max|Δ| {err:.4f}·max > 2e-2"


class TestBridgeAndChecks:
    def test_tower_params_round_trip(self):
        _, _, params = _inputs(5, 3, (1, 4, 4, 16))
        tree = jax.device_get(jax.tree_util.tree_map(jnp.asarray, params))
        port = tower_params_from_jax(tree)
        back = jtk.TowerParams(**tower_params_to_jax(port))
        for name in jtk.TowerParams._fields:
            a, b = getattr(back, name), getattr(params, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(getattr(port, name).numpy(), b)

    def test_group_indicator_matches_jax(self):
        np.testing.assert_array_equal(ttk.group_indicator(32, 8), jtk.group_indicator(32, 8))

    def test_rejects_features_not_multiple_of_groups(self):
        x, _, params = _inputs(6, 1, (1, 4, 4, 16))
        p12 = ttk.TowerParams(*(
            t[..., :12, :12] if t.dim() == 5 else t[:, :12]
            for t in tower_params_from_jax(params)
        ))
        with pytest.raises(ValueError, match="multiple of 8"):
            ttk.residual_tower(torch.from_numpy(x)[..., :12].contiguous(), p12)

    def test_kernel_wrappers_take_only_cuda_tensors(self):
        x, dy, params = _inputs(7, 1, (1, 4, 4, 16))
        xt, pt = torch.from_numpy(x), tower_params_from_jax(params)
        ttk.reset_launches()
        with pytest.raises(ValueError, match="CUDA"):
            ttk.tower_fwd(xt, pt)
        with pytest.raises(ValueError, match="CUDA"):
            ttk.tower_bwd(torch.from_numpy(dy), xt, pt)
        ttk.residual_tower(xt, pt)  # the plain version: no launch counted
        assert ttk.launches == {"tower_fwd": 0, "tower_bwd": 0}
