"""The port's contrastive encoder training against the JAX package on the
CPU: ``load_corpus``, the two augmented views with JAX's random draws
injected (torch cannot reproduce ``jax.random``, so the port splits the
draws from their application), one ``encoder_train_step`` against JAX's
step from the same weights and views, ``train_contrastive_encoder``'s
refusal, and the ``train-encoder`` subcommand end to end at a tiny size,
whose archive then drives ``train --perceptual-encoder`` and ``eval
--perceptual-metric``.

Bars: the views 1e-6 abs; the step's losses rel 1e-4, its Adam first
moment within 1e-2 of its norm (tests/test_torch_gan.py's bar), the params
after it within 2·lr (Adam moves each weight by about lr).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srgan_tpu.data import dataset as jds
from srgan_tpu.models import encoder as jenc
from srgan_tpu.ops.gan_loss import uniformity_loss as j_uniformity_loss
from srgan_tpu.training import encoder_train as jet
from srgan_tpu.training import train_state as jts
from srgan_tpu_torch import cli
from srgan_tpu_torch.eval import evaluation as teval
from srgan_tpu_torch.models import encoder as tenc
from srgan_tpu_torch.training import encoder_train as tet
from srgan_tpu_torch.training import train_state as tts
from srgan_tpu_torch.utils.params import encoder_from_jax_params, encoder_to_jax_params

from test_torch_eval import _pairs
from test_torch_gan import assert_moments_close

torch.set_num_threads(1)


def _images(path, n, seed, hw=(64, 64)):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = rng.integers(0, 255, (hw[0] // 2, hw[1] // 2, 3), dtype=np.uint8)
        Image.fromarray(arr).resize((hw[1], hw[0])).save(os.path.join(path, f"im{i}.png"))
    return path


def _jax_draws(key, n, size, crop):
    """JAX's ``two_views`` draws, made as its ``one_view`` makes them (the
    key splits per view, per image, then six ways)."""
    views = []
    for kv in jax.random.split(key):
        d = {k: [] for k in ("oy", "ox", "flip", "brightness", "contrast", "noise")}
        for k in jax.random.split(kv, n):
            kcy, kcx, kf, kb, kcon, kn = jax.random.split(k, 6)
            d["oy"].append(int(jax.random.randint(kcy, (), 0, size - crop + 1)))
            d["ox"].append(int(jax.random.randint(kcx, (), 0, size - crop + 1)))
            d["flip"].append(np.asarray(jax.random.bernoulli(kf, shape=(2,))))
            d["brightness"].append(float(jax.random.uniform(kb, (), minval=-0.15,
                                                            maxval=0.15)))
            d["contrast"].append(float(jax.random.uniform(kcon, (), minval=0.8,
                                                          maxval=1.2)))
            d["noise"].append(np.asarray(jax.random.normal(kn, (crop, crop, 3))))
        views.append({
            "oy": torch.tensor(d["oy"]), "ox": torch.tensor(d["ox"]),
            "flip": torch.from_numpy(np.stack(d["flip"])),
            "brightness": torch.tensor(d["brightness"], dtype=torch.float32),
            "contrast": torch.tensor(d["contrast"], dtype=torch.float32),
            "noise": torch.from_numpy(np.stack(d["noise"])),
        })
    return views


class TestViews:
    def test_load_corpus_matches_jax(self, tmp_path, monkeypatch):
        """Equal to JAX's PIL path (its native decoder, where built, is
        within 1 LSB of PIL; the port decodes with PIL, ROADMAP item 5)."""
        monkeypatch.setattr(jds, "_native_available", lambda: False)
        folder = _images(str(tmp_path / "imgs"), 4, 0, hw=(40, 56))
        with open(os.path.join(folder, "zz_corrupt.png"), "wb") as f:
            f.write(b"not an image")
        got, want = tet.load_corpus(folder, 48), jet.load_corpus(folder, 48)
        assert got.shape == (4, 48, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        os.makedirs(tmp_path / "empty")
        for load in (tet.load_corpus, jet.load_corpus):
            with pytest.raises(FileNotFoundError, match="no readable images"):
                load(str(tmp_path / "empty"), 48)

    def test_views_match_jax_with_injected_draws(self, rng):
        n, size, crop = 6, 40, 24
        imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
        key = jax.random.key(5)
        v1_j, v2_j = jet.two_views(jnp.asarray(imgs), key, crop)
        d1, d2 = _jax_draws(key, n, size, crop)
        assert d1["flip"].any() and not d1["flip"].all()  # both branches taken
        for d, want in ((d1, v1_j), (d2, v2_j)):
            got = tet.apply_view(torch.from_numpy(imgs), d, crop)
            assert got.shape == (n, crop, crop, 3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)

    def test_draws_ranges_and_seed(self):
        n, size, crop = 256, 48, 32
        draws = tet.draw_views(n, size, crop, torch.Generator().manual_seed(0))
        again = tet.draw_views(n, size, crop, torch.Generator().manual_seed(0))
        for d, e in zip(draws, again):
            assert all(torch.equal(d[k], e[k]) for k in d)
            assert 0 <= int(d["oy"].min()) and int(d["ox"].max()) <= size - crop
            assert int(d["oy"].max()) == size - crop  # the last offset is drawn too
            assert 0.3 < float(d["flip"].float().mean()) < 0.7
            assert -0.15 <= float(d["brightness"].min()) < float(d["brightness"].max()) <= 0.15
            assert 0.8 <= float(d["contrast"].min()) < float(d["contrast"].max()) <= 1.2
            assert d["noise"].shape == (n, crop, crop, 3)
            assert abs(float(d["noise"].std()) - 1.0) < 0.02
        assert not torch.equal(draws[0]["noise"], draws[1]["noise"])
        imgs = torch.randint(0, 256, (4, size, size, 3), dtype=torch.uint8)
        v1, v2 = tet.two_views(imgs, crop, torch.Generator().manual_seed(1))
        assert v1.shape == v2.shape == (4, crop, crop, 3)
        assert float(v1.min()) >= 0.0 and float(v1.max()) <= 1.0


class TestStep:
    def test_encoder_train_step_matches_jax(self, rng):
        """One step of JAX's ``train_contrastive_encoder`` objective (its
        ``loss_fn`` / ``train_step``, rebuilt here from its parts) against
        ``encoder_train_step`` from the same weights and views."""
        lr, lam = 1e-3, 0.7
        model = jenc.ConvEncoder(features=(8, 16), embed_dim=16)
        init = jax.jit(lambda k, x: model.init(k, x, method=jenc.ConvEncoder.embed))
        params = jax.device_get(init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
        # non-zero biases and affines, so that each shows
        params = jax.tree.map(
            lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
        v1 = rng.random((6, 32, 32, 3)).astype(np.float32)
        v2 = np.clip(v1 + 0.05 * rng.standard_normal(v1.shape), 0, 1).astype(np.float32)

        def loss_fn(p):
            z1 = model.apply({"params": p}, jnp.asarray(v1), method=jenc.ConvEncoder.embed)
            z2 = model.apply({"params": p}, jnp.asarray(v2), method=jenc.ConvEncoder.embed)
            align = jenc.alignment_loss(z1, z2)
            unif = 0.5 * (j_uniformity_loss(z1) + j_uniformity_loss(z2))
            return align + lam * unif, (align, unif)

        j_state = jts.TrainState.create(apply_fn=model.apply, params=params)
        (loss_j, (align_j, unif_j)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(j_state.params)
        j_state = j_state.apply_gradients(grads, jnp.float32(lr))

        port = tenc.ConvEncoder((8, 16), embed_dim=16)
        port.load_state_dict(encoder_from_jax_params(params))
        t_state = tts.TrainState(port)
        t_state, loss, align, unif = tet.encoder_train_step(
            t_state, torch.from_numpy(v1), torch.from_numpy(v2), lr, lam)
        for got, want in ((loss, loss_j), (align, align_j), (unif, unif_j)):
            assert float(got) == pytest.approx(float(want), rel=1e-4)
        names = [n for n, _ in port.named_parameters()]
        assert_moments_close(encoder_to_jax_params(dict(zip(names, t_state.mu))),
                             j_state.opt_state.mu, 1e-2, "encoder")
        got_params = encoder_to_jax_params(port.state_dict())
        for path, leaf in jax.tree_util.tree_leaves_with_path(jax.device_get(j_state.params)):
            node = got_params
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, leaf, atol=2 * lr, rtol=0)

    def test_steps_below_one_raise_without_writing(self, tmp_path):
        out = str(tmp_path / "enc.npz")
        for train in (jet.train_contrastive_encoder, tet.train_contrastive_encoder):
            with pytest.raises(ValueError, match="steps"):
                train(str(tmp_path), out, steps=0, verbose=False)
        assert not os.path.exists(out)


class TestEntryPoint:
    def test_train_encoder_end_to_end_tiny(self, tmp_path, capsys):
        """``train-encoder`` on 6 images (a batch of 8 draws with
        replacement): one JSON line, the objective down, an archive that both
        packages load with equal taps; TF32 left off."""
        folder = _images(str(tmp_path / "imgs"), 6, 0)
        out = str(tmp_path / "enc.npz")
        rec = cli.main(["train-encoder", "--data", folder, "--out", out, "--steps", "30",
                        "--batch", "8", "--crop", "32", "--load-size", "48",
                        "--features", "8", "16", "--embed-dim", "16", "--device", "cpu"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line) == rec
        assert set(rec) == {"out", "steps", "images", "loss0", "lossN", "align", "unif",
                            "wall_s"}
        assert rec["steps"] == 30 and rec["images"] == 6 and rec["out"] == out
        assert rec["lossN"] < rec["loss0"]
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        port = tenc.load_encoder_npz(out)
        model_j, params_j = jenc.load_encoder_npz(out)
        assert port.features == model_j.features == (8, 16) and port.embed_dim == 16
        x = np.random.default_rng(1).random((1, 36, 44, 3)).astype(np.float32)
        want = model_j.apply({"params": params_j}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=1e-4 * float(np.abs(want[k]).max()))

    def test_default_device_is_the_card(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train-encoder", "--data", str(tmp_path), "--out",
                      str(tmp_path / "e.npz"), "--steps", "1"])

    def test_perceptual_train_and_eval_cli(self, tmp_path):
        """The archive drives ``train --perceptual 0.1 --perceptual-encoder``
        (one epoch, the term in the JSONL) and ``eval
        --perceptual-metric``, whose third slot is ``evaluate_model``'s."""
        enc = tenc.init_encoder(0, features=(8, 16), embed_dim=16)
        path = str(tmp_path / "enc.npz")
        tenc.save_encoder_npz(enc, path)
        for sub, n in (("train", 6), ("val", 2)):
            _images(str(tmp_path / sub), n, len(sub), hw=(40, 72))
        res = str(tmp_path / "results")
        cli.main(["train", "--train-dir", str(tmp_path / "train"), "--val-dir",
                  str(tmp_path / "val"), "--epochs", "1", "--batch-size", "2",
                  "--hr-height", "32", "--hr-width", "64", "--num-features", "8",
                  "--num-residuals", "1", "--results-dir", res, "--progress", "off",
                  "--perceptual", "0.1", "--perceptual-encoder", path, "--device", "cpu"])
        with open(os.path.join(res, "Training_metrics.jsonl")) as f:
            rec = json.loads(f.readline())
        assert rec["p_loss"] > 0 and math.isfinite(rec["g_loss"])
        root = _pairs(str(tmp_path / "pairs"), [(24, 32), (24, 32)])
        got = cli.main(["eval", "-D", root, "--results-dir", res,
                        "--perceptual-metric", path, "--device", "cpu"])
        want = teval.evaluate_model(root, "LRbicx4", "original", results_dir=res,
                                    perceptual_metric=path, verbose=False, device="cpu")
        assert got == want and want[2] > 0
