"""The rest of ``ops/resize.py`` against ``srgan_tpu/ops/resize.py``: salt
and pepper (``grow_spots``, ``add_salt_pepper``, ``degrade_batch`` with
spots) on JAX's own draws, injected, exact; ``resize_bicubic`` against
``jax.image.resize(..., "cubic", antialias=True)`` within 1e-5;
``add_gaussian_noise`` on injected noise, exact, the clip included; and the
draws of a rank of a multi-process run (``shard``), which are this rank's
rows of the global batch's draws, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srgan_tpu.ops import resize as jr
from srgan_tpu_torch.ops import resize as tr


def _jax_spot_draws(key, h, w, salt_prob, pepper_prob):
    """The draws inside JAX's ``add_salt_pepper`` for one image."""
    k_s, k_p, k_su, k_pu = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    return {
        "salt_density": t(jax.random.uniform(k_su, (), minval=0.0, maxval=salt_prob)),
        "pepper_density": t(jax.random.uniform(k_pu, (), minval=0.0, maxval=pepper_prob)),
        "salt_u": t(jax.random.uniform(k_s, (h, w))),
        "pepper_u": t(jax.random.uniform(k_p, (h, w))),
    }


@pytest.mark.parametrize("spot_size", [1, 2, 3, 5])
def test_grow_spots_matches_jax(rng, spot_size):
    seeds = rng.random((2, 17, 23)) < 0.04
    want = np.stack([np.asarray(jr.grow_spots(jnp.asarray(s), spot_size)) for s in seeds])
    got = tr.grow_spots(torch.from_numpy(seeds), spot_size).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spot_size", [1, 3])
def test_add_salt_pepper_matches_jax_on_its_draws(rng, spot_size):
    h, w = 24, 31
    img = rng.random((h, w, 3)).astype(np.float32)
    key = jax.random.key(7)
    want = np.asarray(jr.add_salt_pepper(jnp.asarray(img), key, 0.05, 0.04, spot_size))
    draws = _jax_spot_draws(key, h, w, 0.05, 0.04)
    got = tr.add_salt_pepper_from(torch.from_numpy(img), draws, spot_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 1.0).any() and (want == 0.0).any()  # both kinds of spot


def test_pepper_wins_where_spots_overlap():
    img = torch.full((4, 4, 1), 0.5)
    every = {"salt_density": torch.tensor(1.0), "pepper_density": torch.tensor(1.0),
             "salt_u": torch.zeros(4, 4), "pepper_u": torch.zeros(4, 4)}
    assert torch.equal(tr.add_salt_pepper_from(img, every), torch.zeros(4, 4, 1))


@pytest.mark.parametrize("spot_size", [1, 2])
def test_degrade_batch_with_spots_matches_jax(rng, spot_size):
    b, factor = 3, 2
    hr = rng.random((b, 32, 40, 3)).astype(np.float32)
    key = jax.random.key(11)
    want = np.asarray(jr.degrade_batch(jnp.asarray(hr), key, factor=factor,
                                       noise_std_max=0.03, salt_prob=0.02,
                                       pepper_prob=0.03, spot_size=spot_size))
    k_std, k_noise, k_sp = jax.random.split(key, 3)
    lr_shape = (b, 16, 20, 3)
    std = jax.random.uniform(k_std, (b, 1, 1, 1), minval=0.0, maxval=0.03)
    noise = jax.random.normal(k_noise, lr_shape)
    per_image = [_jax_spot_draws(k, 16, 20, 0.02, 0.03) for k in jax.random.split(k_sp, b)]
    spots = {k: torch.stack([d[k] for d in per_image]) for k in per_image[0]}
    got = tr.degrade_batch_from(
        torch.from_numpy(hr), torch.from_numpy(np.asarray(noise)),
        torch.from_numpy(np.asarray(std)), factor, spots, spot_size,
    ).numpy()
    # the spots land on the same pixels, exactly; elsewhere the bilinear
    # resize's parity bar (tests/test_torch_data.py)
    for v in (0.0, 1.0):
        np.testing.assert_array_equal(got == v, want == v)
    assert (want == 1.0).any() and (want == 0.0).any()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_degrade_batch_draws_spots_from_the_generator():
    hr = torch.full((2, 64, 64, 3), 0.5)
    a = tr.degrade_batch(hr, torch.Generator().manual_seed(1), salt_prob=0.2,
                         pepper_prob=0.2, spot_size=2, noise_std_max=0.0, factor=2)
    b = tr.degrade_batch(hr, torch.Generator().manual_seed(1), salt_prob=0.2,
                         pepper_prob=0.2, spot_size=2, noise_std_max=0.0, factor=2)
    assert torch.equal(a, b) and bool((a == 1.0).any()) and bool((a == 0.0).any())


@pytest.mark.parametrize("src,dst", [((32, 64), (8, 16)), ((30, 45), (7, 11)),
                                     ((12, 10), (24, 20)), ((16, 16), (16, 8)),
                                     ((9, 13), (20, 5))])
def test_resize_bicubic_matches_jax(rng, src, dst):
    x = rng.random((2, *src, 3)).astype(np.float32)
    want = np.asarray(jr.resize_bicubic(jnp.asarray(x), dst))
    got = tr.resize_bicubic(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # one HWC image too
    np.testing.assert_allclose(tr.resize_bicubic(torch.from_numpy(x[0]), dst).numpy(),
                               want[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("std,mean", [(0.01, 0.0), (0.3, 0.1)])
def test_add_gaussian_noise_matches_jax_on_its_noise(rng, std, mean):
    """Exact against JAX's function run op by op (``disable_jit``): under
    jit, XLA fuses the normal draw's transcendentals with the scale and
    rounds ~1 % of elements 1 ulp apart from the same ops one at a time."""
    img = rng.random((2, 9, 11, 3)).astype(np.float32)
    key = jax.random.key(3)
    with jax.disable_jit():
        want = np.asarray(jr.add_gaussian_noise(jnp.asarray(img), key, std, mean))
        noise = torch.from_numpy(np.array(jax.random.normal(key, img.shape)))
    got = tr.add_gaussian_noise_from(torch.from_numpy(img), noise, std, mean).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() <= 1.0
    if std > 0.1:
        assert (got == 1.0).any() and (got == 0.0).any()  # the clip acts
    out = tr.add_gaussian_noise(torch.from_numpy(img), torch.Generator().manual_seed(0), std)
    assert out.shape == img.shape and float(out.min()) >= 0.0 and float(out.max()) <= 1.0


@pytest.mark.parametrize("spots", [False, True], ids=["noise", "noise+spots"])
def test_shard_draws_are_the_global_batch_rows(rng, spots):
    """Two ranks of 2 rows each, from generators seeded alike, draw what one
    process draws for their 4 rows concatenated in rank order: the same
    flips, noise and spots, so the P-process run degrades the global batch
    as the one-process run does."""
    hr_u8 = torch.from_numpy(rng.integers(0, 256, (4, 16, 24, 3), dtype=np.uint8))
    kw = dict(factor=2, noise_std_max=0.03, augment_flips=True,
              salt_prob=0.05 if spots else 0.0, pepper_prob=0.05 if spots else 0.0,
              spot_size=2)
    hr_all, lr_all = tr.prepare_batch(hr_u8, torch.Generator().manual_seed(4), **kw)
    for rank in range(2):
        rows = slice(2 * rank, 2 * rank + 2)
        hr, lr = tr.prepare_batch(hr_u8[rows], torch.Generator().manual_seed(4),
                                  shard=(rank, 2), **kw)
        assert torch.equal(hr, hr_all[rows]) and torch.equal(lr, lr_all[rows])
