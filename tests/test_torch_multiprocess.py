"""The port's multi-process training in a real 2-process CPU cluster
(``torch.distributed`` over gloo, each rank joining through the variables
``torchrun`` sets, as ``train --multihost`` does), after
``tests/test_multiprocess.py``:

  (a) the ranks train on disjoint shards that cover the dataset;
  (b) the reduced epoch records are identical on both ranks;
  (c) the first global batch (decode, degradation noise) equals the
      one-process run's over the same global batch order bit for bit, and
      the final params equal that run's at the JAX test's bar (atol
      2.5e-4: Adam amplifies the all-reduce's summation-order ulps,
      ``tests/test_multiprocess.py:197-233``);
  (d) the GAN pool of 2 stays in lockstep (records, pool bookkeeping,
      params bit-identical across ranks);
  (e) a SIGTERM to rank 0 alone stops both ranks at the same boundary with
      no deadlock, and a resume on the shared results dir completes;
  (d') the vmap pool executor's GAN pool of 2 under the group equals the
      one-process run over the same global batch order (atol 2.5e-4);
  (f) the process-group loss of each rank's half is the whole batch's,
      and the DDP pixel step (``parallel/data_parallel.py``) equals JAX's
      ``make_shardmap_pixel_step`` on a 2-device mesh.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multiprocess_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _make_images(folder, n, size=(48, 48)):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n):
        base = rng.integers(40, 215, (8, 8, 3), dtype=np.uint8)
        Image.fromarray(base).resize(size, Image.BICUBIC).save(
            os.path.join(folder, f"im_{i:02d}.png"))


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tmpdata")
    train_dir, val_dir = str(root / "train"), str(root / "val")
    _make_images(train_dir, 16)
    _make_images(val_dir, 8)
    return train_dir, val_dir


def _spawn(mode, tmp, data_dirs=("", ""), *, n_procs=2, results_dir=None, tag=None):
    """Start the ranks of one cluster (not waited for)."""
    port, tag = _free_port(), tag or mode
    results_dir = results_dir or str(tmp / f"{tag}_results")
    procs, outs = [], []
    for rank in range(n_procs):
        out = str(tmp / f"{tag}_r{rank}.json")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n_procs), RANK=str(rank), LOCAL_RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--mode", mode, "--train-dir", data_dirs[0],
             "--val-dir", data_dirs[1], "--results-dir", results_dir, "--out", out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    return procs, outs, results_dir


def _wait(procs, timeout=300):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"


def _cluster(mode, tmp, data_dirs=("", ""), **kw):
    procs, outs, _ = _spawn(mode, tmp, data_dirs, **kw)
    _wait(procs)
    return [json.load(open(o)) for o in outs], outs


def _same_records(r0, r1):
    assert set(r0) == set(r1)
    for k in r0:
        if k == "wall_s":
            continue  # each rank's own clock
        assert r0[k] == r1[k], k


def _params(out):
    with np.load(out + ".params.npz") as z:
        return [z[f] for f in z.files]


class TestPixel:
    @pytest.fixture(scope="class")
    def cluster(self, data_dirs, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("tmp_pixel")
        results, outs = _cluster("pixel", tmp, data_dirs)
        ref, ref_outs = _cluster("reference", tmp, data_dirs, n_procs=1)
        return results, outs, ref[0], ref_outs[0]

    def test_topology_and_shards(self, cluster):
        results, _, _, _ = cluster
        assert [(r["world"], r["rank"]) for r in results] == [(2, 0), (2, 1)]
        s0, s1 = (set(r["shard_indices"]) for r in results)
        assert s0 and not (s0 & s1) and len(s0) == len(s1) and len(s0 | s1) == 16

    def test_reduced_records_identical_across_ranks(self, cluster):
        results, _, _, _ = cluster
        _same_records(results[0]["record"], results[1]["record"])
        assert results[0]["record"]["n_batches"] == 4
        assert np.isfinite(results[0]["record"]["psnr"])

    def test_global_batch_equals_single_process(self, cluster):
        results, _, ref, _ = cluster
        for k in ("hr_sums", "lr_sums"):
            got = results[0]["first_batch"][k] + results[1]["first_batch"][k]
            assert got == ref["first_batch"][k], k

    def test_params_and_losses_match_single_process(self, cluster):
        results, outs, ref, ref_out = cluster
        want = _params(ref_out)
        for out in outs:
            got = _params(out)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-4)
        p0, p1 = _params(outs[0]), _params(outs[1])
        for a, b in zip(p0, p1):
            np.testing.assert_array_equal(a, b)  # one Adam step on every rank
        for k in ("g_loss", "com_loss", "tv_loss"):
            assert results[0]["record"][k] == pytest.approx(ref["record"][k], rel=2e-2), k


def test_gan_pool_cluster_runs_in_lockstep(data_dirs, tmp_path):
    results, outs = _cluster("gan_pool", tmp_path, data_dirs)
    r0, r1 = results[0]["record"], results[1]["record"]
    _same_records(r0, r1)
    assert np.isfinite(r0["d_loss"]) and results[0]["pool_meta"] == results[1]["pool_meta"]
    assert sum(m["gan_updates"] + m["pixel_updates"] for m in results[0]["pool_meta"]) == 8
    for a, b in zip(_params(outs[0]), _params(outs[1])):
        np.testing.assert_array_equal(a, b)


def test_vmap_pool_cluster_matches_single_process(data_dirs, tmp_path):
    """``--pool-exec vmap`` under ``--multihost``: the pooled K1-K3's totals
    and every gradient go through the group; both ranks end bit-identical,
    and the leader's params equal one process over the same global batch
    order at the JAX test's bar."""
    results, outs = _cluster("vmap_pool", tmp_path, data_dirs)
    ref, ref_outs = _cluster("vmap_reference", tmp_path, data_dirs, n_procs=1)
    r0, r1 = results[0]["record"], results[1]["record"]
    _same_records(r0, r1)
    assert r0["n_batches"] == 4 and np.isfinite(r0["d_loss"])
    assert [m["gan_updates"] for m in results[0]["pool_meta"]] == [2, 2]
    assert results[0]["pool_meta"] == results[1]["pool_meta"]
    for m, w in zip(results[0]["pool_meta"], ref[0]["pool_meta"]):
        assert (m["gan_updates"], m["pixel_updates"]) == (w["gan_updates"], w["pixel_updates"])
        for k in ("running_loss", "gan_threshold"):
            assert m[k] == pytest.approx(w[k], rel=1e-5), k
    for a, b in zip(_params(outs[0]), _params(outs[1])):
        np.testing.assert_array_equal(a, b)
    want = _params(ref_outs[0])
    got = _params(outs[0])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.5e-4)
    for k in ("g_loss", "com_loss", "tv_loss", "d_loss"):
        assert r0[k] == pytest.approx(ref[0]["record"][k], rel=2e-2), k


class TestSigterm:
    @pytest.fixture(scope="class")
    def interrupted(self, data_dirs, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("tmp_sig")
        procs, outs, results_dir = _spawn("sigterm", tmp, data_dirs, tag="sig")
        metrics = os.path.join(results_dir, "Training_metrics.jsonl")
        deadline = time.time() + 240
        try:
            while time.time() < deadline:
                if os.path.exists(metrics) and os.path.getsize(metrics) > 0:
                    break
                if any(p.poll() is not None for p in procs):
                    break
                time.sleep(0.2)
            assert os.path.exists(metrics), "training never logged an epoch"
            procs[0].send_signal(signal.SIGTERM)  # rank 0 only
        finally:
            _wait(procs)  # a rank that stopped alone would deadlock its peer here
        return [json.load(open(o)) for o in outs], results_dir, tmp

    def test_collective_stop_no_deadlock(self, interrupted):
        results, _, _ = interrupted
        r0, r1 = results[0]["record"], results[1]["record"]
        assert r0.get("interrupted") == r1.get("interrupted")
        assert r0["epoch"] == r1["epoch"] < 200
        if r0.get("interrupted"):
            assert r0["interrupted_after_batches"] == r1["interrupted_after_batches"]
        assert results[0]["ckpt_dir"] is not None
        assert results[0]["ckpt_dir"] == results[1]["ckpt_dir"]

    def test_resume_completes(self, interrupted, data_dirs):
        sig, results_dir, tmp = interrupted
        results, outs = _cluster("resume", tmp, data_dirs, results_dir=results_dir,
                                 tag="res")
        sig_epoch = int(sig[0]["ckpt_dir"].split("@")[1].split(".")[0])
        assert [r["resume_from_epoch"] for r in results] == [sig_epoch] * 2
        n = results[0]["num_epochs"]
        assert n >= sig_epoch + 2 and results[0]["record"]["epoch"] == n
        for r in results:
            assert r["logged_epochs"] == list(range(1, n + 1))
        _same_records(results[0]["record"], results[1]["record"])
        for a, b in zip(_params(outs[0]), _params(outs[1])):
            np.testing.assert_array_equal(a, b)


def test_group_loss_and_ddp_step_match(tmp_path):
    """Each rank's process-group loss of its half is the whole batch's
    (rel 1e-6), its gradient the whole batch's gradient's rows scaled by
    the world size (1e-6·max; averaged across ranks it is the global
    loss's). One DDP step (``parallel/data_parallel.py``) from the same
    weights equals JAX's ``make_shardmap_pixel_step`` on a 2-device mesh:
    params within 2·lr (the repo's Adam-step bar,
    ``tests/test_torch_training.py``), metrics within rel 1e-4."""
    import jax
    import jax.numpy as jnp

    from srgan_tpu.config import ModelConfig as JModelConfig
    from srgan_tpu.models.srresnet import init_generator as j_init_generator
    from srgan_tpu.parallel.data_parallel import make_shardmap_pixel_step
    from srgan_tpu.parallel.mesh import make_mesh
    from srgan_tpu.training.train_state import TrainState as JTrainState
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.ops.recon_loss import reconstruction_loss
    from srgan_tpu_torch.utils.params import to_jax_params

    results, outs = _cluster("steps", tmp_path)
    rng = np.random.default_rng(0)  # the worker's inputs
    hr = np.zeros((4, 32, 32, 3), np.float32)
    for i in range(4):
        y, x = rng.integers(0, 26, 2)
        hr[i, y:y + 6, x:x + 6] = rng.random(3)
    sr = rng.random((4, 32, 32, 3)).astype(np.float32)
    lr_imgs = rng.random((4, 16, 16, 3)).astype(np.float32)

    s = torch.from_numpy(sr).requires_grad_(True)
    e, tv = reconstruction_loss(torch.from_numpy(hr), s)
    (g,) = torch.autograd.grad(e + 0.5 * tv, s)
    assert float(tv.detach()) > 0
    for r in results:
        assert r["edge_loss"] == pytest.approx(float(e), rel=1e-6)
        assert r["tv_loss"] == pytest.approx(float(tv), rel=1e-6)
        rows = g[r["rank"] * 2:r["rank"] * 2 + 2] * 2
        assert float((torch.tensor(r["dsr"]) - rows).abs().max()) <= 1e-6 * float(g.abs().max())

    small = dict(num_features=8, num_residuals=1, upscale_factor=2)
    model = init_generator(ModelConfig(**small), seed=0)
    model_j, _ = j_init_generator(JModelConfig(**small), jax.random.key(0), sample_hw=(16, 16))
    state = JTrainState.create(apply_fn=model_j.apply,
                               params=jax.tree.map(jnp.asarray, to_jax_params(model.state_dict())))
    mesh = make_mesh(devices=jax.devices()[:2])
    step = make_shardmap_pixel_step(mesh, model_j.apply)
    state, m = step(state, jnp.asarray(hr), jnp.asarray(lr_imgs), jnp.float32(STEP_LR))
    want = jax.device_get(state.params)
    for out in outs:
        with torch.no_grad():
            for p, a in zip(model.parameters(), _params(out)):
                p.copy_(torch.from_numpy(a))
        got = to_jax_params(model.state_dict())
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            node = got
            for k in path:
                node = node[k.key]
            np.testing.assert_allclose(node, leaf, atol=2 * STEP_LR, rtol=0)
    for k in ("g_loss", "com_loss", "tv_loss"):
        assert results[0]["ddp_metrics"][k] == pytest.approx(float(m[k]), rel=1e-4), k
    assert results[0]["ddp_metrics"] == results[1]["ddp_metrics"]


STEP_LR = 1e-4  # the worker's steps mode
