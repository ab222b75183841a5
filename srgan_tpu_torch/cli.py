"""Command-line entry point of the port: ``python -m srgan_tpu_torch.cli
{train,train-encoder,eval,upscale,upscale-dir} ...``, the counterpart of
``srgan_tpu/cli.py`` with the same flags, defaults and ``Config`` mapping,
plus ``--device`` on every subcommand (default ``cuda``; ``cpu`` runs on
the CPU), the counterpart of ``JAX_PLATFORMS``.

``train``: ``--gan`` trains with the discriminator and ``--num-generators
N`` trains a pool of N generators (the scan executor when N > 1, or
``--pool-exec vmap``); ``--perceptual WEIGHT`` adds the perceptual term,
its features from ``--perceptual-encoder`` (a trained encoder) or VGG19
(``--vgg-weights``).
``train-encoder`` trains that encoder and prints one JSON line. ``eval``
scores a paired LR/HR set (``eval/evaluation.py``; ``--perceptual-metric``
adds the encoder distance), ``upscale`` one image (``--tile`` for the tiled
path) and ``upscale-dir`` a folder (``eval/inference.py``);
``--ensemble``, ``--tta`` and ``--ema`` select the serving mode; ``--dp``
serves on every visible CUDA device. ``train --multihost`` joins the
process group ``torchrun`` describes (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; NCCL on the card, gloo with
``--device cpu``) and trains data-parallel, one rank a device;
``--profile-dir`` writes a ``torch.profiler`` trace of the run there;
``--pool-exec vmap`` runs a pool's members in one vmapped region
(``training/stacked_pool.py``) instead of the member loop, with
``--remat`` recomputing each residual block in the backward.
``--arch swinir`` (``train``, and ``upscale`` without a checkpoint, whose
sidecar names its own) builds SwinIR with ``--embed-dim``, ``--depths``,
``--heads``, ``--window`` and ``--mlp-ratio``; it refuses ``--remat`` and
``--pool-exec vmap``, SRResNet's.
"""

from __future__ import annotations

import argparse
import sys


def _int_list(text: str) -> tuple:
    """``6,6,6`` → (6, 6, 6)."""
    try:
        return tuple(int(v) for v in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected integers joined by commas, got {text!r}") from None


def _add_arch(p, default):
    """The generator's architecture and SwinIR's widths (``ModelConfig``'s
    defaults: SwinIR-M's published ones)."""
    p.add_argument("--arch", choices=("srresnet", "swinir"), default=default,
                   help="generator architecture: srresnet (the reference's) or swinir "
                        "(SwinIR, arXiv:2108.10257; --num-features is then its "
                        "upsampler's width)")
    p.add_argument("--embed-dim", type=int, default=180, help="SwinIR token width")
    p.add_argument("--depths", type=_int_list, default=(6, 6, 6, 6, 6, 6),
                   help="SwinIR Swin layers per residual group, e.g. 6,6,6,6,6,6")
    p.add_argument("--heads", type=_int_list, default=(6, 6, 6, 6, 6, 6),
                   help="SwinIR attention heads per residual group")
    p.add_argument("--window", type=int, default=8,
                   help="SwinIR attention window side (odd layers shift by half of it)")
    p.add_argument("--mlp-ratio", type=float, default=2.0,
                   help="SwinIR MLP hidden width over the token width")


def _arch_fields(args) -> dict:
    return dict(generator=args.arch, embed_dim=args.embed_dim, depths=args.depths,
                num_heads=args.heads, window_size=args.window, mlp_ratio=args.mlp_ratio)


def _add_train(sub):
    p = sub.add_parser("train", help="train the SR generator")
    _add_arch(p, "srresnet")
    p.add_argument("--train-dir", default="data/train")
    p.add_argument("--val-dir", default="data/val")
    p.add_argument("--epochs", type=int, default=30)  # train.py:23
    p.add_argument("--batch-size", type=int, default=12)  # train.py:94
    p.add_argument("--hr-height", type=int, default=512)
    p.add_argument("--hr-width", type=int, default=1024)
    p.add_argument("--upscale", type=int, default=4)
    p.add_argument("--num-features", type=int, default=64)
    p.add_argument("--num-residuals", type=int, default=16)
    p.add_argument("--num-generators", type=int, default=1,
                   help="pool size (readme.md multi-generator competition)")
    p.add_argument("--gan", action="store_true",
                   help="adversarial training with the patch "
                        "discriminator")
    p.add_argument("--d-stages", type=int, default=4,
                   help="discriminator conv/pool stages (4 = reference "
                        "parity, needs >=428px inputs)")
    p.add_argument("--d-features", type=int, default=64,
                   help="discriminator base channel width (64 = reference "
                        "parity)")
    p.add_argument("--vgg-weights", default=None, metavar="NPZ",
                   help="pretrained VGG19 feature weights (.npz) for "
                        "--perceptual")
    p.add_argument("--perceptual", type=float, default=0.0, metavar="WEIGHT",
                   help="perceptual-loss weight (0 = off, as the reference "
                        "ships); features from --perceptual-encoder, else "
                        "VGG19 (--vgg-weights, else random with a warning)")
    p.add_argument("--perceptual-encoder", default=None, metavar="NPZ",
                   help="trained contrastive-encoder feature prior for "
                        "--perceptual (see train-encoder)")
    p.add_argument("--starting-gan-loss", type=float, default=None,
                   help="two-regime gate threshold (readme.md:10); default "
                        "auto: calibrated at the first epoch end to "
                        "gate-auto-frac x the median running loss")
    p.add_argument("--gate-auto-frac", type=float, default=0.6,
                   help="auto-calibration fraction for the gate threshold "
                        "(only read while --starting-gan-loss is unset)")
    p.add_argument("--pool-exec", choices=("scan", "vmap"), default="scan",
                   help="pool executor (pools of more than one "
                        "generator): scan, the member loop (one member's "
                        "activations alive); vmap, all members in one "
                        "region (N x activation memory: needs --remat + "
                        "smaller batch at flagship shapes)")
    p.add_argument("--no-mutual", action="store_true",
                   help="disable the epoch-end weak-learns-from-strong "
                        "interpolation (readme.md:13)")
    p.add_argument("--mutual-alpha", type=float, default=0.2,
                   help="weak<-strong interpolation strength "
                        "(utils.py:113-115's alpha)")
    p.add_argument("--pre-loss-gate", action="store_true",
                   help="modulate P(GAN) by own loss vs last epoch's "
                        "pre_loss snapshot (readme.md:5)")
    p.add_argument("--continue-training", action="store_true",
                   help="fine-tune phase: reload checkpoint, LR/5, "
                        "Post-Training prefix (train.py:51-59)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="snapshot the full state every N epochs "
                        "(preemption recovery; 0 = end-of-run only)")
    p.add_argument("--keep-best", action="store_true",
                   help="snapshot to <prefix>-best whenever val PSNR "
                        "improves")
    p.add_argument("--resume", action="store_true",
                   help="continue the same run from the last snapshot")
    p.add_argument("--validate-every", type=int, default=5,
                   help="comparison-grid cadence in epochs (train.py:114)")
    p.add_argument("--device-cache", choices=["auto", "on", "off"],
                   default="auto",
                   help="device-resident uint8 dataset cache ('off' streams "
                        "from the host)")
    p.add_argument("--noise-std-max", type=float, default=0.03,
                   help="max per-image LR noise severity (transformers.py:76)")
    p.add_argument("--salt-prob", type=float, default=0.0,
                   help="salt-spot density bound for LR corruption "
                        "(transformers.py:39-70; 0 = off)")
    p.add_argument("--pepper-prob", type=float, default=0.0,
                   help="pepper-spot density bound (see --salt-prob)")
    p.add_argument("--spot-size", type=int, default=1,
                   help="square spot side for salt & pepper corruption")
    p.add_argument("--augment", action="store_true",
                   help="random H/V flips of each HR clip before "
                        "degradation (validation never augments)")
    p.add_argument("--lr-generator", type=float, default=1e-4)
    p.add_argument("--lr-schedule", choices=("linear", "cosine"),
                   default="linear",
                   help="linear = the reference's LinearLR 1->0.01 "
                        "(train.py:70-71); cosine = its commented-out "
                        "CosineAnnealingLR variant (train.py:68-69)")
    p.add_argument("--lr-discriminator", type=float, default=5e-5)
    p.add_argument("--ema-decay", type=float, default=0.0, metavar="D",
                   help="EMA-average the generator weights with this "
                        "per-step decay (0 = off); validation and keep-best "
                        "then use the averaged weights")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--prefix", default="Training")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 conv compute (params stay float32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each residual block in backward (fits "
                        "larger batches)")
    p.add_argument("--progress", choices=["auto", "always", "off"],
                   default="auto",
                   help="in-epoch live loss line (auto = only on a TTY)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite "
                        "step loss")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of the run into "
                        "this directory (trace.json)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run: join the process group torchrun "
                        "describes (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, "
                        "RANK, LOCAL_RANK) and train data-parallel")
    p.add_argument("--reduce-metrics", action="store_true",
                   help="all-reduce the scalar epoch record across "
                        "processes (the identity on one process)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' runs on the CPU)")


_SERVE_MODES = (
    ("--ensemble", "serve the member-MEAN SR of every pool generator in the "
                   "checkpoint (the reference serves only member 0)"),
    ("--tta", "geometric self-ensemble (x8 dihedral test-time augmentation); "
              "composes with --ensemble"),
    ("--ema", "serve the EMA weights saved by an --ema-decay training run"),
)
_DP_HELP = ("shard inference batches over every visible CUDA device "
            "(data-parallel serving: one replica a device)")
_DEVICE_HELP = "torch device to run on ('cpu' runs on the CPU)"


def _add_serve_modes(p):
    for flag, help_ in _SERVE_MODES:
        p.add_argument(flag, action="store_true", help=help_)


def _add_eval(sub):
    p = sub.add_parser("eval", help="batch evaluation on a paired LR/HR set")
    p.add_argument("-D", "--data_dir", default="data")
    p.add_argument("-lr", "--lr_dir", default="LRbicx4")
    p.add_argument("-hr", "--hr_dir", default="original")
    p.add_argument("--no-extra-downscale", action="store_true")
    p.add_argument("--no-enhance", action="store_true")
    p.add_argument("--bucketed", action="store_true",
                   help="pad to the set's max size + masked metrics: one "
                        "input shape for size-diverse sets")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--prefix", default="Training")
    p.add_argument("--torch-checkpoint", default=None,
                   help="evaluate a reference PyTorch .pth generator "
                        "directly (BatchNorm folded on load)")
    _add_serve_modes(p)
    p.add_argument("--perceptual-metric", default=None, metavar="NPZ",
                   help="also report the trained encoder's perceptual "
                        "distance (the train-encoder .npz)")
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def _add_upscale(sub):
    p = sub.add_parser("upscale", help="super-resolve one image file")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--prefix", default="Training")
    p.add_argument("--enhance", action="store_true")
    _add_serve_modes(p)
    p.add_argument("--tile", type=int, default=0,
                   help="tile size (LR px) for tiled inference: one input "
                        "shape for ANY image size, device memory bounded by "
                        "--tile-batch tiles. 0 = direct whole-image path")
    p.add_argument("--tile-overlap", type=int, default=16,
                   help="feather-blended tile margin (LR px)")
    p.add_argument("--tile-batch", type=int, default=16,
                   help="tiles per device batch in tiled mode")
    p.add_argument("--dp", action="store_true", help=_DP_HELP)
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)
    _add_arch(p, None)


def _add_upscale_dir(sub):
    p = sub.add_parser(
        "upscale-dir",
        help="super-resolve every image in a folder (batch serving path)",
    )
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--prefix", default="Training")
    p.add_argument("--enhance", action="store_true")
    _add_serve_modes(p)
    p.add_argument("--batch-size", type=int, default=8,
                   help="images per device batch (same-size images batch "
                        "together; sizes are bucketed automatically)")
    p.add_argument("--dp", action="store_true", help=_DP_HELP)
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def add_train_encoder_args(p):
    """The JAX CLI's ``train-encoder`` flags and defaults."""
    p.add_argument("--data", required=True, help="image folder to train on")
    p.add_argument("--out", required=True, help="output .npz archive")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--crop", type=int, default=96)
    p.add_argument("--load-size", type=int, default=160,
                   help="images are pre-resized to this square size; "
                        "crops are cut from it on the device")
    p.add_argument("--features", type=int, nargs="+", default=[32, 64, 128])
    p.add_argument("--embed-dim", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--unif-weight", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)


def run_train_encoder(args) -> dict:
    from srgan_tpu_torch.training.encoder_train import train_contrastive_encoder

    return train_contrastive_encoder(
        args.data, args.out,
        steps=args.steps, batch=args.batch, crop=args.crop,
        load_size=args.load_size, features=args.features,
        embed_dim=args.embed_dim, lr=args.lr,
        unif_weight=args.unif_weight, seed=args.seed, device=args.device,
    )


def _add_train_encoder(sub):
    p = sub.add_parser(
        "train-encoder",
        help="train the contrastive image-encoder perceptual prior "
             "(alignment + the reference's uniformity loss, "
             "utils.py:118-137); feed the .npz to train "
             "--perceptual-encoder",
    )
    add_train_encoder_args(p)
    p.add_argument("--device", default="cuda", help=_DEVICE_HELP)


def config_from_args(args):
    """The ``Config`` the JAX CLI builds from the same flags."""
    from srgan_tpu_torch.config import (
        Config, DataConfig, DiscriminatorConfig, ModelConfig, PoolConfig,
        TrainConfig,
    )

    compute_dtype = "bfloat16" if args.bf16 else "float32"
    return Config(
        discriminator=DiscriminatorConfig(
            num_stages=args.d_stages,
            num_filters=args.d_features,
            compute_dtype=compute_dtype,
        ),
        model=ModelConfig(
            upscale_factor=args.upscale,
            num_features=args.num_features,
            num_residuals=args.num_residuals,
            remat=args.remat,
            compute_dtype=compute_dtype,
            **_arch_fields(args),
        ),
        data=DataConfig(
            train_dir=args.train_dir,
            val_dir=args.val_dir,
            hr_size=(args.hr_height, args.hr_width),
            upscale_factor=args.upscale,
            batch_size=args.batch_size,
            noise_std_max=args.noise_std_max,
            salt_prob=args.salt_prob,
            pepper_prob=args.pepper_prob,
            sp_spot_size=args.spot_size,
            augment_flips=args.augment,
            device_cache=args.device_cache,
        ),
        pool=PoolConfig(
            num_generators=args.num_generators,
            starting_gan_loss=args.starting_gan_loss,
            gate_auto_frac=args.gate_auto_frac,
            pre_loss_gate=args.pre_loss_gate,
            member_exec=args.pool_exec,
            mutual_learning=not args.no_mutual,
            mutual_alpha=args.mutual_alpha,
        ),
        train=TrainConfig(
            num_epochs=args.epochs,
            lr_generator=args.lr_generator,
            lr_schedule=args.lr_schedule,
            lr_discriminator=args.lr_discriminator,
            use_gan=args.gan,
            ema_decay=args.ema_decay,
            perceptual_weight=args.perceptual,
            vgg_weights_npz=args.vgg_weights,
            perceptual_encoder_npz=args.perceptual_encoder,
            validate_every=args.validate_every,
            results_dir=args.results_dir,
            run_prefix=args.prefix,
            seed=args.seed,
            debug_nans=args.debug_nans,
            checkpoint_every=args.checkpoint_every,
            keep_best=args.keep_best,
            reduce_metrics=args.reduce_metrics,
            progress=args.progress,
        ),
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("srgan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_train(sub)
    _add_train_encoder(sub)
    _add_eval(sub)
    _add_upscale(sub)
    _add_upscale_dir(sub)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "train":
        return _train(args)
    if args.cmd == "train-encoder":
        import json

        out = run_train_encoder(args)
        print(json.dumps(out))
        return out
    if args.cmd == "eval":
        from srgan_tpu_torch.eval.evaluation import evaluate_model

        return evaluate_model(
            dataset=args.data_dir,
            lr_path=args.lr_dir,
            hr_path=args.hr_dir,
            results_dir=args.results_dir,
            prefix=args.prefix,
            torch_checkpoint=args.torch_checkpoint,
            extra_downscale=not args.no_extra_downscale,
            apply_enhance=not args.no_enhance,
            bucketed=args.bucketed,
            ensemble=args.ensemble,
            tta=args.tta,
            ema=args.ema,
            perceptual_metric=args.perceptual_metric,
            device=args.device,
        )
    if args.cmd == "upscale":
        from srgan_tpu_torch.eval.inference import Upscaler
        from srgan_tpu_torch.training.checkpoint import latest_ckpt_dir

        devices = _dp_devices(args)
        if latest_ckpt_dir(args.results_dir, args.prefix) is not None:
            _check_arch(args)
            up = Upscaler.from_checkpoint(
                args.results_dir, args.prefix, enhance_output=args.enhance,
                ensemble=args.ensemble, tta=args.tta, ema=args.ema,
                device=args.device, devices=devices,
            )
        else:
            print("warning: no checkpoint found, using random weights",
                  file=sys.stderr)
            up = Upscaler.random_init(_upscale_model_config(args),
                                      enhance_output=args.enhance,
                                      device=args.device, devices=devices)
        if args.tile:
            from srgan_tpu_torch.utils.image_io import load_image, save_image

            sr = up.upscale_tiled(
                load_image(args.input),
                tile=args.tile,
                overlap=args.tile_overlap,
                batch_size=args.tile_batch,
            )
            save_image(sr, args.output)
        else:
            up.upscale_file(args.input, args.output)
        print(f"saved {args.output}")
        return None
    # args.cmd == "upscale-dir"
    from srgan_tpu_torch.eval.inference import upscale_directory

    n = upscale_directory(
        args.input_dir,
        args.output_dir,
        results_dir=args.results_dir,
        prefix=args.prefix,
        enhance_output=args.enhance,
        batch_size=args.batch_size,
        ensemble=args.ensemble,
        tta=args.tta,
        ema=args.ema,
        device=args.device,
        devices=_dp_devices(args),
    )
    print(f"upscaled {n} images into {args.output_dir}")
    return n


def _upscale_model_config(args):
    """``upscale``'s model without a checkpoint: the flags' architecture."""
    from srgan_tpu_torch.config import ModelConfig

    return ModelConfig(**{**_arch_fields(args), "generator": args.arch or "srresnet"})


def _check_arch(args) -> None:
    """``upscale --arch`` beside a checkpoint: its sidecar has to agree."""
    from srgan_tpu_torch.training.checkpoint import load_model_config

    saved = load_model_config(args.results_dir, args.prefix)
    if args.arch is not None and saved is not None and saved.generator != args.arch:
        raise SystemExit(f"--arch {args.arch}: the checkpoint in {args.results_dir} is "
                         f"{saved.generator!r} (its {args.prefix}_model.json)")


def _dp_devices(args):
    """``--dp``: every visible CUDA device (the one CPU with ``--device
    cpu``); None without it."""
    if not args.dp:
        return None
    import torch

    from srgan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _train(args):
    import contextlib

    import torch

    from srgan_tpu_torch.training.loop import Trainer

    cfg = config_from_args(args)
    device = args.device
    if args.multihost:
        from srgan_tpu_torch.parallel.mesh import initialize_multihost

        device = initialize_multihost(device)
    if args.profile_dir:
        from srgan_tpu_torch.utils.profiling import trace

        ctx = trace(args.profile_dir)
    else:
        ctx = contextlib.nullcontext()
    try:
        with ctx:
            return Trainer(cfg, device=device).train(
                continue_training=args.continue_training,
                resume=args.resume,
            )
    except torch.cuda.OutOfMemoryError:
        hints = [f"--batch-size lower than {cfg.data.batch_size}"]
        if cfg.data.device_cache != "off":
            hints.insert(0, "--device-cache off (the dataset cache competes "
                            "with the training step for device memory)")
        if not cfg.model.remat:
            hints.insert(0, "--remat (recompute the residual blocks in "
                            "backward)")
        print(
            "error: the training step exceeded device memory. Try: "
            + "; ".join(hints) + ".",
            file=sys.stderr,
        )
        raise
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
