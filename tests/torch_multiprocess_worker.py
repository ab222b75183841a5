"""One process of a CPU cluster of the port (``torch.distributed``, gloo),
launched by ``tests/test_torch_multiprocess.py`` with the variables
``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK),
after ``tests/multiprocess_worker.py``. Not a pytest module.

Modes:
``pixel``      one generator, pixel loss, streaming pipeline, 1 epoch;
               dumps the epoch-0 shard, the first batch's row sums, the
               (reduced) epoch record and the final params.
``reference``  ONE process over the same global batch order (each global
               batch the ranks' local batches concatenated in rank order),
               the params-parity oracle of ``pixel``.
``gan_pool``   a pool of 2 with GAN, the device cache and reduce_metrics,
               1 epoch.
``vmap_pool``  a pool of 2 with GAN through the vmap pool executor
               (``member_exec="vmap"``; every member takes the adversarial
               term from the third batch on), streaming pipeline, 1 epoch.
``vmap_reference``  ONE process of ``vmap_pool`` over the same global batch
               order, as ``reference`` is to ``pixel``.
``sigterm``    like ``pixel`` but 200 epochs; the test sends SIGTERM to
               rank 0 only, and every rank must stop at the same boundary.
``resume``     relaunch of ``sigterm``'s cluster with ``resume=True`` on its
               shared results dir, trained to a short end.
``spatial``    ``parallel.spatial.upscale_spatially_sharded`` of every
               case of ``tests/test_torch_spatial.py`` (``SPATIAL_CASES``:
               head, norm, width), each output in ``<out>.spatial.npz``.
``steps``      the process-group loss and the DDP pixel step on fixed
               inputs: each rank's loss of its half against the whole
               batch's, and each rank's params after one
               ``make_shardmap_pixel_step`` (the test holds them against
               JAX's on a 2-device mesh).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

LOCAL_BATCH = 2


def build_cfg(args, batch_size: int):
    from srgan_tpu_torch.config import (Config, DataConfig, DiscriminatorConfig,
                                        ModelConfig, PoolConfig, TrainConfig)

    vmap = args.mode in ("vmap_pool", "vmap_reference")
    gan = args.mode == "gan_pool" or vmap
    sig = args.mode in ("sigterm", "resume")
    epochs = {"sigterm": 200, "resume": getattr(args, "resume_num_epochs", 4)}
    return Config(
        model=ModelConfig(num_features=8, num_residuals=1, upscale_factor=2),
        discriminator=DiscriminatorConfig(num_filters=8, num_stages=2),
        data=DataConfig(hr_size=(32, 32), upscale_factor=2, batch_size=batch_size,
                        split_ratio=1.0, num_workers=2,
                        device_cache="on" if gan and not vmap else "off"),
        pool=PoolConfig(num_generators=2 if gan else 1,
                        member_exec="vmap" if vmap else "scan",
                        # the vmap run takes the adversarial term from the
                        # third batch on (the gate reads losses two behind)
                        p_gan_above=1.0 if vmap else 0.1),
        train=TrainConfig(
            num_epochs=epochs.get(args.mode, 1),
            validate_every=1000 if sig else 1,
            score_max_batches=1 if sig else 2,
            stop_sync_every_batches=2,
            results_dir=args.results_dir,
            seed=3,
            use_gan=gan,
            reduce_metrics=True,
            progress="off",
        ),
    )


def first_batch_sums(cfg, train_dir, num_shards, shard_index):
    """Per-row pixel sums of this rank's rows of the first training batch
    (epoch 0) through the pipeline the Trainer builds, degradation noise
    included."""
    from srgan_tpu_torch.data.pipeline import TrainPipeline
    from srgan_tpu_torch.training.loop import _epoch_generator

    pipe = TrainPipeline(cfg.data, train_dir, use_split=True, num_shards=num_shards,
                         shard_index=shard_index, seed=cfg.train.seed, device="cpu")
    try:
        for hr, lr in pipe.epoch(0, _epoch_generator(torch.device("cpu"),
                                                      cfg.train.seed, 0)):
            return {"hr_sums": hr.double().sum((1, 2, 3)).tolist(),
                    "lr_sums": lr.double().sum((1, 2, 3)).tolist()}
    finally:
        pipe.close()
    return {}


def steps_mode(args, rank, world, group):
    """The group loss of this rank's half against the whole batch's, and one
    DDP pixel step from seed 0's weights on fixed inputs."""
    from srgan_tpu_torch.config import ModelConfig
    from srgan_tpu_torch.models.srresnet import init_generator
    from srgan_tpu_torch.ops.recon_loss import reconstruction_loss
    from srgan_tpu_torch.parallel.data_parallel import make_shardmap_pixel_step
    from srgan_tpu_torch.training.train_state import TrainState

    rng = np.random.default_rng(0)
    hr = np.zeros((4, 32, 32, 3), np.float32)
    for i in range(4):
        y, x = rng.integers(0, 26, 2)
        hr[i, y:y + 6, x:x + 6] = rng.random(3)
    sr = rng.random((4, 32, 32, 3)).astype(np.float32)
    lr_imgs = rng.random((4, 16, 16, 3)).astype(np.float32)
    rows = slice(rank * 2, rank * 2 + 2)
    s = torch.from_numpy(sr[rows]).requires_grad_(True)
    e, tv = reconstruction_loss(torch.from_numpy(hr[rows]), s, group)
    (g,) = torch.autograd.grad(e + 0.5 * tv, s)
    out = {"edge_loss": float(e), "tv_loss": float(tv), "dsr": g.numpy().tolist()}

    cfg = ModelConfig(num_features=8, num_residuals=1, upscale_factor=2)
    state = TrainState(init_generator(cfg, seed=0))
    step = make_shardmap_pixel_step(group)
    state, m = step(state, torch.from_numpy(hr[rows]), torch.from_numpy(lr_imgs[rows]), 1e-4)
    out["ddp_metrics"] = {k: float(v) for k, v in m.items()}
    np.savez(args.out + ".params.npz", *[p.detach().numpy() for p in state.params])
    return out


def spatial_mode(args):
    """Every spatial case's W-sharded output, from the test module's own
    model and image makers."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_spatial import SPATIAL_CASES, spatial_case

    from srgan_tpu_torch.parallel.mesh import default_group
    from srgan_tpu_torch.parallel.spatial import upscale_spatially_sharded

    outs = {}
    for case in SPATIAL_CASES:
        model, img = spatial_case(*case)
        outs["-".join(map(str, case))] = upscale_spatially_sharded(
            model, img, default_group(), device="cpu")
    np.savez(args.out + ".spatial.npz", **outs)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mode", required=True, choices=[
        "pixel", "reference", "gan_pool", "vmap_pool", "vmap_reference", "sigterm",
        "resume", "steps", "spatial"])
    p.add_argument("--train-dir", default="")
    p.add_argument("--val-dir", default="")
    p.add_argument("--results-dir", default="")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)

    from srgan_tpu_torch.parallel import mesh

    out = {"mode": args.mode}
    one_process = args.mode in ("reference", "vmap_reference")
    if not one_process:
        mesh.initialize_multihost("cpu")
    group = mesh.default_group()
    world, rank = mesh.process_shard_info(group)
    out.update(world=world, rank=rank)
    if args.mode in ("steps", "spatial"):
        if args.mode == "steps":
            out.update(steps_mode(args, rank, world, group))
        else:
            spatial_mode(args)
        with open(args.out, "w") as f:
            json.dump(out, f)
        torch.distributed.destroy_process_group()
        return

    batch = 2 * LOCAL_BATCH if one_process else LOCAL_BATCH
    if args.mode == "resume":
        from srgan_tpu_torch.training.checkpoint import latest_ckpt_dir

        d = latest_ckpt_dir(args.results_dir, "Training")
        assert d is not None, "resume needs a committed snapshot"
        out["resume_from_epoch"] = int(os.path.basename(d).split("@")[1].split(".")[0])
        args.resume_num_epochs = max(4, out["resume_from_epoch"] + 2)
    cfg = build_cfg(args, batch)

    if one_process:
        # each global batch is the two ranks' local batches, rank 0 first
        from srgan_tpu_torch.data import pipeline as pl

        def emulated(self, epoch):
            perm = np.random.default_rng((self.seed, epoch)).permutation(len(self.indices))
            shuffled = self.indices[perm]
            per = len(shuffled) // 2
            shards = [shuffled[i::2][:per] for i in range(2)]
            chunks = [s[b * LOCAL_BATCH:(b + 1) * LOCAL_BATCH]
                      for b in range(per // LOCAL_BATCH) for s in shards]
            return np.concatenate(chunks)

        pl.EpochSampler.epoch_indices = emulated

    from srgan_tpu_torch.training.loop import Trainer

    trainer = Trainer(cfg, device="cpu")
    last = trainer.train(args.train_dir, args.val_dir, resume=args.mode == "resume")
    out["record"] = {k: v for k, v in last.items() if not isinstance(v, (list, dict))}
    out["pool_meta"] = last.get("pool")
    if args.mode in ("sigterm", "resume"):
        from srgan_tpu_torch.training.checkpoint import latest_ckpt_dir

        d = latest_ckpt_dir(args.results_dir, "Training")
        out["ckpt_dir"] = os.path.basename(d) if d else None
    if args.mode == "resume":
        out["num_epochs"] = cfg.train.num_epochs
        name = ("Training_metrics.jsonl" if rank == 0
                else f"Training_rank{rank}_metrics.jsonl")
        with open(os.path.join(args.results_dir, name)) as f:
            out["logged_epochs"] = [json.loads(ln)["epoch"] for ln in f if ln.strip()]
    if args.mode in ("pixel", "gan_pool"):
        out["shard_indices"] = [int(i) for i in trainer_shard(cfg, args, world, rank)]
    if args.mode in ("pixel", "reference"):
        out["first_batch"] = first_batch_sums(cfg, args.train_dir, world, rank)
    leader = trainer._leader()
    np.savez(args.out + ".params.npz", *[t.detach().numpy() for t in leader.parameters()])
    with open(args.out, "w") as f:
        json.dump(out, f)
    if group is not None:
        torch.distributed.destroy_process_group()
    print(f"[{args.mode}:{rank}] OK", flush=True)


def trainer_shard(cfg, args, world, rank):
    """The epoch-0 slice this rank trains on, from the sampler the Trainer
    builds."""
    from srgan_tpu_torch.data.pipeline import TrainPipeline

    pipe = TrainPipeline(cfg.data, args.train_dir, use_split=True, num_shards=world,
                         shard_index=rank, seed=cfg.train.seed, device="cpu")
    try:
        return pipe.sampler.epoch_indices(0)
    finally:
        pipe.close()


if __name__ == "__main__":
    sys.exit(main())
