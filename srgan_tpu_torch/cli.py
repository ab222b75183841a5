"""Command-line entry point of the port: ``python -m srgan_tpu_torch.cli
train ...``, the counterpart of ``srgan_tpu/cli.py``'s ``train`` with the
same flags, defaults and ``Config`` mapping, plus ``--device`` (default
``cuda``; ``cpu`` runs on the CPU), the counterpart of ``JAX_PLATFORMS``.

``--gan`` trains with the discriminator and ``--num-generators N`` trains a
pool of N generators (the stacked pool's scan executor when N > 1). Flags
whose feature is not ported reach an error that names its ROADMAP.md item:
``--perceptual`` in the ``Trainer``; ``--pool-exec vmap``,
``--profile-dir`` and ``--multihost`` here. The other
subcommands of the JAX CLI (``eval``, ``upscale``, ``upscale-dir``,
``train-encoder``) are ROADMAP.md queue 1, items 9 and 11.
"""

from __future__ import annotations

import argparse
import sys


def _add_train(sub):
    p = sub.add_parser("train", help="train the SR generator")
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
                   help="perceptual-loss weight, 0 = off (not ported yet: "
                        "ROADMAP.md queue 1, item 8)")
    p.add_argument("--perceptual-encoder", default=None, metavar="NPZ",
                   help="trained contrastive-encoder feature prior for "
                        "--perceptual")
    p.add_argument("--starting-gan-loss", type=float, default=None,
                   help="two-regime gate threshold (readme.md:10); default "
                        "auto: calibrated at the first epoch end to "
                        "gate-auto-frac x the median running loss")
    p.add_argument("--gate-auto-frac", type=float, default=0.6,
                   help="auto-calibration fraction for the gate threshold "
                        "(only read while --starting-gan-loss is unset)")
    p.add_argument("--pool-exec", choices=("scan", "vmap"), default="scan",
                   help="stacked-pool executor (pools of more than one "
                        "generator; vmap is not ported yet: ROADMAP.md "
                        "queue 1, item 7)")
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
                   help="trace the run into this directory (not ported "
                        "yet: ROADMAP.md queue 1, item 11)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process run (not ported yet: ROADMAP.md "
                        "queue 1, item 10)")
    p.add_argument("--reduce-metrics", action="store_true",
                   help="all-reduce the scalar epoch record across "
                        "processes (the identity on one process)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cpu' runs on the CPU)")


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
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    # args.cmd == "train", the one subcommand
    if args.profile_dir:
        raise NotImplementedError(
            "--profile-dir: tracing is not ported yet (ROADMAP.md, queue 1, "
            "item 11: CLI and utilities)"
        )
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-process training is not ported yet "
            "(ROADMAP.md, queue 1, item 10: parallelism)"
        )
    if args.pool_exec == "vmap":
        raise NotImplementedError(
            "--pool-exec vmap: the vmap pool executor is not ported yet "
            "(ROADMAP.md, queue 1, item 7: generator pool); scan computes "
            "the same updates"
        )
    import torch

    from srgan_tpu_torch.training.loop import Trainer

    cfg = config_from_args(args)
    try:
        return Trainer(cfg, device=args.device).train(
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


if __name__ == "__main__":
    main()
