"""The port's W-sharded inference (``srgan_tpu_torch/parallel/spatial.py``)
on a real 2-process CPU cluster (``torch.distributed`` over gloo, spawned
from ``tests/torch_multiprocess_worker.py``), against the port's unsharded
forward and against JAX's ``upscale_spatially_sharded`` on a 2-device mesh
of the suite's virtual CPU devices (so that both pad alike).

Cases: the three heads, both norms, at 4x, F=8, 2 blocks, LR 12 rows:
  - W=48 (24 columns a stripe): equal to the unsharded forward (JAX's bar,
    rtol 1e-4 / atol 1e-5, ``tests/test_parallel.py``);
  - W=37: both packages edge-pad to 38 and crop. The result equals the
    unsharded forward of the padded image, cropped, and JAX's sharded
    result: JAX's approximation near the right border (and its GroupNorm
    statistics shift) reproduced, not avoided;
  - W=6 (3 columns a stripe, narrower than the 9x9 stem's 4-column halo):
    the halo reaches across more than the adjacent stripe.
Also: world size 1 and no group are the plain forward, and a strided conv
is refused.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from srgan_tpu.config import ModelConfig as JModelConfig
from srgan_tpu.models.srresnet import init_generator as j_init_generator
from srgan_tpu.parallel.spatial import upscale_spatially_sharded as j_sharded
from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.parallel.spatial import upscale_spatially_sharded
from srgan_tpu_torch.utils.params import to_jax_params

SPATIAL_CASES = list(itertools.product(("subpixel", "coarse", "reference"),
                                       ("group", "none"), (48, 37, 6)))
SMALL = dict(num_features=8, num_residuals=2, upscale_factor=4)


def spatial_case(head, norm, width):
    """The model (seed 0) and the HWC image (seed ``width``) of one case."""
    model = init_generator(ModelConfig(head=head, norm=norm, **SMALL), seed=0)
    img = np.random.default_rng(width).random((12, width, 3)).astype(np.float32)
    return model, img


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case's output from one 2-process cluster, keyed by case."""
    from test_torch_multiprocess import _cluster

    tmp = tmp_path_factory.mktemp("spatial")
    _, outs = _cluster("spatial", tmp)
    got = []
    for out in outs:
        with np.load(out + ".spatial.npz") as z:
            got.append({k: z[k] for k in z.files})
    for k in got[0]:  # every rank holds the whole output
        np.testing.assert_array_equal(got[0][k], got[1][k])
    return got[0]


def _unsharded(model, img, width):
    """The plain forward of the image edge-padded to an even width, cropped."""
    pad = (-width) % 2
    x = np.pad(img, ((0, 0), (0, pad), (0, 0)), mode="edge")
    with torch.no_grad():
        y = model(torch.from_numpy(x)[None])[0].numpy()
    return y[:, : y.shape[1] * width // x.shape[1]]


@pytest.mark.parametrize("case", SPATIAL_CASES, ids=["-".join(map(str, c)) for c in SPATIAL_CASES])
def test_sharded_equals_unsharded_and_jax(sharded, case):
    head, norm, width = case
    model, img = spatial_case(*case)
    got = sharded["-".join(map(str, case))]
    assert got.shape == (48, 4 * width, 3)
    np.testing.assert_allclose(got, _unsharded(model, img, width), rtol=1e-4, atol=1e-5)

    j_model, _ = j_init_generator(JModelConfig(head=head, norm=norm, **SMALL),
                                  jax.random.key(0), sample_hw=(8, 8))
    params = jax.tree.map(np.asarray, to_jax_params(model.state_dict()))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    want = j_sharded(j_model.apply, params, img, mesh=mesh)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_one_rank_and_no_group_are_the_plain_forward():
    """A group of one rank (gloo, in this process) and no group give the
    plain forward's bits; NHWC in gives NHWC out."""
    import socket

    import torch.distributed as dist

    model, img = spatial_case("subpixel", "group", 37)
    alone = upscale_spatially_sharded(model, img, device="cpu")
    with torch.no_grad():  # after the call: it sets the deterministic mode
        want = model(torch.from_numpy(img)[None])[0].numpy()
    np.testing.assert_array_equal(alone, want)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        got = upscale_spatially_sharded(model, img[None], dist.group.WORLD, device="cpu")
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(got, want[None])


def test_strided_conv_is_refused():
    from srgan_tpu_torch.parallel.spatial import _sharded_conv

    conv = torch.nn.Conv2d(3, 3, 3, stride=2, padding=1)
    with pytest.raises(ValueError, match="stride-1 SAME"):
        _sharded_conv(conv, conv.forward, None)
