"""The port's parallel, profiling and head-fold pieces against the JAX
package, in one process: ``EpochSampler``'s shards index-equal to JAX's;
``combine_host_metrics`` / ``reduce_metrics`` equal to JAX's on the same
dicts; the head folds equal to JAX's (and exact as convolutions, 1e-5);
``Upscaler(devices=[cpu, cpu])`` against one device (1e-6); the process-group
reconstruction loss at world size 1 (a one-rank gloo group) against no
group, to fp32 rounding (the plain form sums in fp64 totals; the kernels'
world-1 bit-equality is held on their emulated source,
``tests/test_torch_recon_source.py``); and the trace file. Two-process
runs are in ``tests/test_torch_multiprocess.py``."""

import json
import os
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from srgan_tpu.data.pipeline import EpochSampler as JEpochSampler
from srgan_tpu.models import srresnet as jsr
from srgan_tpu.parallel import mesh as jmesh
from srgan_tpu_torch.data.pipeline import EpochSampler
from srgan_tpu_torch.models import srresnet as tsr
from srgan_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from srgan_tpu_torch.parallel import mesh
from srgan_tpu_torch.utils import profiling


@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo group for this module, destroyed after it (a live
    default group would be joined by any later Trainer in the process)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


class TestSampler:
    @pytest.mark.parametrize("n,shards", [(16, 1), (16, 2), (17, 2), (16, 4), (23, 3)])
    def test_shards_equal_jax(self, n, shards):
        idx = np.arange(100, 100 + n)
        for epoch in (0, 3):
            got = [EpochSampler(idx, num_shards=shards, shard_index=r, seed=5)
                   .epoch_indices(epoch) for r in range(shards)]
            want = [JEpochSampler(idx, num_shards=shards, shard_index=r, seed=5)
                    .epoch_indices(epoch) for r in range(shards)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            flat = np.concatenate(got)
            assert len(set(flat)) == len(flat) == (n // shards) * shards


class TestMetrics:
    RECORDS = [
        {"epoch": 3, "g_loss": 0.25, "psnr": 21.5, "n_batches": 4, "ok": True,
         "pool": [{"running_loss": 0.1}], "name": "a", "nan": float("nan")},
        {"epoch": 3, "g_loss": 0.35, "psnr": 22.0, "n_batches": 4, "ok": False,
         "pool": [{"running_loss": 0.2}], "name": "b", "nan": 1.0},
        {"epoch": 3, "g_loss": 0.15, "psnr": 23.5, "n_batches": 5, "ok": True,
         "pool": [{"running_loss": 0.3}], "name": "c", "nan": 3.0},
    ]

    def test_combine_host_metrics_equals_jax(self):
        for k in (1, 2, 3):
            got = mesh.combine_host_metrics(self.RECORDS[:k])
            want = jmesh.combine_host_metrics(self.RECORDS[:k])
            assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
            assert type(got["n_batches"]) is type(want["n_batches"])

    def test_reducible_equals_jax(self):
        for k, v in [("epoch", 1), ("ok", True), ("x", 1), ("x", 1.5),
                     ("x", np.float32(2)), ("x", "s"), ("x", None), ("x", [1])]:
            assert mesh._reducible(k, v) == jmesh._reducible(k, v), (k, v)

    def test_single_process_identities(self):
        rec = self.RECORDS[0]
        assert mesh.reduce_metrics(rec) == jmesh.reduce_metrics(rec) == rec
        assert mesh.any_process_flag(True) is True and mesh.any_process_flag(0) is False
        assert mesh.process_shard_info() == (1, 0)
        g = [torch.ones(3)]
        assert mesh.average_grads(g) == g and mesh.sum_over_ranks(g[0]) is g[0]

    def test_world1_group_collectives(self, world1):
        rec = dict(self.RECORDS[1])
        got = mesh.reduce_metrics(rec, world1)
        assert got["g_loss"] == float(np.float32(0.35))  # crosses as float32, as in JAX
        assert got["n_batches"] == 4 and got["pool"] == rec["pool"]
        assert mesh.any_process_flag(True, world1) and not mesh.any_process_flag(False, world1)
        x = torch.tensor([1.5, -2.0], dtype=torch.float64)
        assert torch.equal(mesh.sum_over_ranks(x, world1), x)
        assert torch.equal(mesh.average_grads([x], world1)[0], x)
        assert mesh.process_shard_info(world1) == (1, 0)


class TestHeadFolds:
    def test_equal_jax(self, rng):
        k9 = rng.standard_normal((9, 9, 4, 3)).astype(np.float32)
        b3 = rng.standard_normal(3).astype(np.float32)
        for got, want in zip(tsr.reference_head_to_subpixel(k9, b3),
                             jsr.reference_head_to_subpixel(jnp.asarray(k9), b3)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
        k5 = rng.standard_normal((5, 5, 4, 3)).astype(np.float32)
        for got, want in zip(tsr.fold_phase_conv_to_coarse(torch.from_numpy(k5), b3),
                             jsr.fold_phase_conv_to_coarse(jnp.asarray(k5), b3)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)

    @staticmethod
    def _conv(x, k, b):
        """NHWC conv with an HWIO kernel, 'same' zero padding."""
        w = torch.from_numpy(k).permute(3, 2, 0, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, torch.from_numpy(b), padding=k.shape[0] // 2)
        return y.permute(0, 2, 3, 1)

    def test_folds_are_exact_as_convolutions(self, rng):
        x = torch.from_numpy(rng.standard_normal((1, 6, 7, 16)).astype(np.float32))
        k9 = rng.standard_normal((9, 9, 4, 3)).astype(np.float32) * 0.1
        b3 = rng.standard_normal(3).astype(np.float32)
        k5, b12 = tsr.reference_head_to_subpixel(k9, b3)
        torch.testing.assert_close(self._conv(pixel_shuffle(x), k9, b3),
                                   pixel_shuffle(self._conv(x, k5, b12)),
                                   atol=1e-5, rtol=1e-5)
        y = torch.from_numpy(rng.standard_normal((1, 8, 10, 4)).astype(np.float32))
        k5 = rng.standard_normal((5, 5, 4, 12)).astype(np.float32) * 0.1
        b12 = rng.standard_normal(12).astype(np.float32)
        k3, b48 = tsr.fold_phase_conv_to_coarse(k5, b12)
        torch.testing.assert_close(
            pixel_shuffle(self._conv(y, k5, b12)),
            pixel_shuffle(pixel_shuffle(self._conv(pixel_unshuffle(y), k3, b48))),
            atol=1e-5, rtol=1e-5)


class TestDataParallelServing:
    @pytest.mark.parametrize("ensemble,tta", [(False, False), (True, False), (False, True)])
    def test_two_devices_equal_one(self, rng, ensemble, tta):
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.eval.inference import Upscaler
        from srgan_tpu_torch.models.srresnet import init_generator

        cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2)
        models = [init_generator(cfg, seed=s) for s in range(2 if ensemble else 1)]
        one = Upscaler(models if ensemble else models[0], ensemble=ensemble, tta=tta,
                       device="cpu", enhance_output=True)
        two = Upscaler(models if ensemble else models[0], ensemble=ensemble, tta=tta,
                       devices=["cpu", "cpu"], enhance_output=True)
        assert len(two.replicas) == 2 and two.replicas[1][0] is not two.members[0]
        x = rng.random((3, 8, 10, 3)).astype(np.float32)  # 3 rows: one padded
        np.testing.assert_allclose(two.upscale(x), one.upscale(x), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(two.upscale_u8(x), one.upscale_u8(x))
        np.testing.assert_allclose(two.upscale(x[0]), one.upscale(x[0]), atol=1e-6, rtol=0)

    def test_cli_dp_on_the_cpu(self, tmp_path, rng, capsys):
        from PIL import Image

        from srgan_tpu_torch import cli

        src = tmp_path / "in"
        src.mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (8, 10, 3), dtype=np.uint8)).save(
                src / f"i{i}.png")
        argv = ["--results-dir", str(tmp_path / "none"), "--device", "cpu"]
        cli.main(["upscale", str(src / "i0.png"), str(tmp_path / "a.png"), "--dp", *argv])
        cli.main(["upscale", str(src / "i0.png"), str(tmp_path / "b.png"), *argv])
        a, b = (np.asarray(Image.open(tmp_path / f)) for f in ("a.png", "b.png"))
        np.testing.assert_array_equal(a, b)
        assert cli.main(["upscale-dir", str(src), str(tmp_path / "o"), "--dp", *argv]) == 3


class TestGroupLoss:
    def test_world1_group_equals_no_group(self, rng, world1):
        from srgan_tpu_torch.ops.recon_loss import reconstruction_loss

        hr = np.zeros((2, 32, 48, 3), np.float32)  # sparse edges: a live TV term
        hr[:, 10:15, 20:25] = rng.random(3)
        hr = torch.from_numpy(hr)
        sr = torch.from_numpy(rng.random((2, 32, 48, 3)).astype(np.float32))
        outs = []
        for group in (None, world1):
            s = sr.clone().requires_grad_(True)
            e, tv = reconstruction_loss(hr, s, group)
            (g,) = torch.autograd.grad(e + 0.5 * tv, s)
            outs.append((e.detach(), tv.detach(), g))
        (e0, tv0, g0), (e1, tv1, g1) = outs
        assert float(tv0) > 0  # the TV term and its gradient are live
        assert float(e1) == pytest.approx(float(e0), rel=1e-6)
        assert float(tv1) == pytest.approx(float(tv0), rel=1e-6)
        assert float((g1 - g0).abs().max()) <= 1e-6 * float(g0.abs().max())


class TestProfiling:
    def test_trace_writes_a_file(self, tmp_path):
        with profiling.trace(str(tmp_path / "tr")):
            with profiling.span("my_region"):
                torch.ones(8).sum()
        path = tmp_path / "tr" / profiling.TRACE_FILE
        text = path.read_text()
        assert path.exists() and "my_region" in text
        assert isinstance(json.loads(text), dict)

    def test_cli_profile_dir(self, tmp_path, rng):
        """``train --profile-dir`` traces the run: the trace file appears and
        names the run's steps."""
        from PIL import Image

        from srgan_tpu_torch import cli

        for d, n in (("train", 4), ("val", 2)):
            os.makedirs(tmp_path / d)
            for i in range(n):
                Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
                    tmp_path / d / f"{i}.png")
        cli.main(["train", "--train-dir", str(tmp_path / "train"), "--val-dir",
                  str(tmp_path / "val"), "--epochs", "1", "--batch-size", "2",
                  "--hr-height", "16", "--hr-width", "16", "--upscale", "2",
                  "--num-features", "8", "--num-residuals", "1", "--results-dir",
                  str(tmp_path / "res"), "--progress", "off", "--device", "cpu",
                  "--profile-dir", str(tmp_path / "prof")])
        text = (tmp_path / "prof" / profiling.TRACE_FILE).read_text()
        assert "aten::convolution" in text


class TestDeterminism:
    """Every entry point leaves deterministic algorithms on (the fault it
    repairs shows only on the card: ``chip_smoke.py``'s determinism phase)."""

    @staticmethod
    def _off():
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True

    @staticmethod
    def _assert_on():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        assert os.environ.get("CUBLAS_WORKSPACE_CONFIG")

    def test_trainer(self):
        from srgan_tpu_torch.config import Config, ModelConfig
        from srgan_tpu_torch.training.loop import Trainer

        self._off()
        Trainer(Config(model=ModelConfig(num_features=8, num_residuals=1)), device="cpu")
        self._assert_on()

    def test_serving(self):
        from srgan_tpu_torch.config import ModelConfig
        from srgan_tpu_torch.eval.inference import Upscaler

        self._off()
        Upscaler.random_init(ModelConfig(num_features=8, num_residuals=1), device="cpu")
        self._assert_on()

    def test_train_encoder(self, tmp_path, rng):
        from PIL import Image

        from srgan_tpu_torch.training.encoder_train import train_contrastive_encoder

        os.makedirs(tmp_path / "d")
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
                tmp_path / "d" / f"{i}.png")
        self._off()
        train_contrastive_encoder(str(tmp_path / "d"), str(tmp_path / "e.npz"), steps=1,
                                  batch=2, crop=16, load_size=24, features=(4, 8),
                                  embed_dim=8, verbose=False, device="cpu")
        self._assert_on()


def test_rows_helpers_are_this_ranks_rows(rng):
    """Each rank holds its own rows: ``put_global`` moves them to its device
    and ``host_local_rows`` reads them back whole (JAX assembles and splits
    a global array; ``srgan_tpu/parallel/mesh.py:63-116``)."""
    rows = rng.random((3, 4, 5, 3)).astype(np.float32)
    t = mesh.put_global(rows, "cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_array_equal(mesh.host_local_rows(t), rows)
    np.testing.assert_array_equal(mesh.host_local_rows(rows), rows)
    np.testing.assert_array_equal(jmesh.host_local_rows(rows), mesh.host_local_rows(rows))
