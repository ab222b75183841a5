"""Batch evaluation over a paired LR/HR dataset, the counterpart of
``srgan_tpu/eval/evaluation.py``.

Argparse contract of the reference (``src/evaluation.py:64-79``):
``-D/--data_dir`` (default ``./data``), ``-lr/--lr_dir`` (default
``LRbicx4``), ``-hr/--hr_dir`` (default ``original``), plus ``--device``;
prints running and final average PSNR/SSIM, and with
``--perceptual-metric`` the average encoder perceptual distance.

Reference semantics kept (switchable):
  - the extra ÷factor downscale of the LR input before SR
    (``evaluation.py:45-46``), so the SR output matches the original LR
    size — ``--no-extra-downscale`` disables it;
  - the ImageEnhancer sharpening epilogue (``evaluation.py:50``) —
    ``--no-enhance`` disables it; without it the SR is scored unclamped;
  - HR resized to the SR size before scoring (``evaluation.py:52-53``).

Each image runs eagerly on the device: forward, enhance, resize and the
metrics as tensors, one fetch of the (PSNR, SSIM[, distance]) vector. JAX's
``_forward_fn`` is :meth:`Upscaler.forward` here.
"""

from __future__ import annotations

import argparse
import os
import warnings
from typing import Optional

import torch
import torch.nn.functional as F

from srgan_tpu_torch.data.dataset import PairedImageDataset
from srgan_tpu_torch.eval.inference import Upscaler, _serving_device
from srgan_tpu_torch.models.encoder import init_encoder_extractor
from srgan_tpu_torch.models.enhancer import enhance
from srgan_tpu_torch.models.vgg import perceptual_loss
from srgan_tpu_torch.ops.metrics import psnr, psnr_masked, ssim, ssim_masked
from srgan_tpu_torch.ops.resize import resize_bilinear


def evaluate_model(
    dataset: str,
    lr_path: str,
    hr_path: str,
    *,
    upscaler: Optional[Upscaler] = None,
    results_dir: str = "results",
    prefix: str = "Training",
    torch_checkpoint: Optional[str] = None,
    extra_downscale: bool = True,
    apply_enhance: bool = True,
    bucketed: bool = False,
    ensemble: bool = False,
    tta: bool = False,
    ema: bool = False,
    perceptual_metric: Optional[str] = None,
    verbose: bool = True,
    device=None,
) -> tuple:
    """Returns ``(avg_psnr, avg_ssim, avg_perceptual_dist_or_None)`` over
    the paired eval set (``evaluate_model``, ``src/evaluation.py:15-61``),
    the JAX package's fixed 3-tuple.

    ``perceptual_metric``: a trained contrastive-encoder ``.npz``; the third
    slot is then the mean encoder distance ``perceptual_loss(sr, hr)``
    (after the enhance and the HR resize), the objective that
    ``--perceptual-encoder`` trains, else None.
    ``torch_checkpoint``: evaluate a reference PyTorch ``.pth`` generator.
    ``bucketed``: edge-pad every LR input to the set's largest size and
    score with masked PSNR/SSIM, one input shape for a size-diverse set;
    on a uniform-size set it equals the per-size path."""
    if perceptual_metric is not None and bucketed:
        raise ValueError(
            "--perceptual-metric is not supported with --bucketed: the "
            "edge-padded extent flows through the encoder's feature maps "
            "and there is no masked variant of the feature distance — "
            "score perceptual distance with per-size (non-bucketed) eval"
        )
    _serving_device(device if upscaler is None else upscaler.device)
    eval_data = PairedImageDataset(dataset, lr_path, hr_path)
    if upscaler is None:
        from srgan_tpu_torch.training.checkpoint import latest_ckpt_dir

        if torch_checkpoint is not None:
            # --ensemble needs a multi-member pool checkpoint, which a
            # reference .pth never carries; TTA is weight-agnostic
            if ensemble:
                raise ValueError(
                    "--ensemble requires a pool checkpoint (multiple "
                    "generators); a reference .pth holds one generator — "
                    "drop --ensemble or evaluate an srgan_tpu pool run via "
                    "--results-dir/--prefix"
                )
            if ema:
                raise ValueError(
                    "--ema requires an srgan_tpu checkpoint trained with "
                    "--ema-decay; a reference .pth carries no EMA shadow"
                )
            upscaler = Upscaler.from_torch_checkpoint(
                torch_checkpoint, tta=tta, device=device
            )
        elif latest_ckpt_dir(results_dir, prefix) is not None:
            upscaler = Upscaler.from_checkpoint(
                results_dir, prefix, ensemble=ensemble, tta=tta, ema=ema,
                device=device,
            )
        else:
            # never score an untrained network silently
            warnings.warn(
                f"eval: no checkpoint for prefix '{prefix}' under "
                f"{results_dir} — scoring RANDOM (untrained) generator "
                "weights. Pass --results-dir/--prefix pointing at a "
                "training run, or --torch-checkpoint for a reference "
                ".pth.",
                RuntimeWarning,
                stacklevel=2,
            )
            upscaler = Upscaler.random_init(device=device)

    if bucketed:
        return _evaluate_bucketed(
            eval_data,
            upscaler,
            extra_downscale=extra_downscale,
            apply_enhance=apply_enhance,
            verbose=verbose,
        )

    dev = upscaler.device
    enc = None
    if perceptual_metric is not None:
        enc = init_encoder_extractor(perceptual_metric, device=dev)
    t_psnr, t_ssim, t_pd, n = 0.0, 0.0, 0.0, 0
    f = upscaler.model.upscale_factor
    for idx in range(len(eval_data)):
        pair = eval_data[idx]
        if pair is None:
            continue  # corrupt-file skip
        lr_img, hr_img = pair
        if _lr_too_small(
            lr_img.shape[0], lr_img.shape[1], f, extra_downscale, idx=idx
        ):
            continue  # a degenerate size would poison the running averages
        lr_b = torch.from_numpy(lr_img).to(dev)[None]
        if extra_downscale:
            # ``evaluation.py:45-46``: shrink the LR input by the model's
            # upscale factor (the reference hardcodes ÷4, its only model)
            lr_b = resize_bilinear(lr_b, (lr_img.shape[0] // f, lr_img.shape[1] // f))
        vals = _score(upscaler, lr_b, torch.from_numpy(hr_img).to(dev)[None],
                      apply_enhance, enc).tolist()
        t_psnr += vals[0]
        t_ssim += vals[1]
        if enc is not None:
            t_pd += vals[2]
        n += 1
        if verbose:
            line = (f"[{n}/{len(eval_data)}] psnr={t_psnr / n:.4f} "
                    f"ssim={t_ssim / n:.4f}")
            if enc is not None:
                line += f" enc_dist={t_pd / n:.4f}"
            print(line, end="\r")
    avg_psnr = t_psnr / max(1, n)
    avg_ssim = t_ssim / max(1, n)
    if enc is not None:
        avg_pd = t_pd / max(1, n)
        if verbose:
            print(f"\naverage psnr = {avg_psnr}, average ssim = {avg_ssim},"
                  f" average encoder perceptual distance = {avg_pd}")
        return avg_psnr, avg_ssim, avg_pd
    if verbose:
        print(f"\naverage psnr = {avg_psnr}, average ssim = {avg_ssim}")
    return avg_psnr, avg_ssim, None


@torch.no_grad()
def _score(upscaler, lr_b, hr_b, apply_enhance, enc=None) -> torch.Tensor:
    """(PSNR, SSIM) of one image on the device, and the encoder distance
    where ``enc`` is given: SR (unclamped unless enhanced), HR resized to the
    SR size."""
    sr = upscaler.forward(lr_b)
    if apply_enhance:
        sr = enhance(sr)
    hr_r = resize_bilinear(hr_b, tuple(sr.shape[1:3]))
    out = [psnr(sr[0], hr_r[0]), ssim(sr[0], hr_r[0])]
    if enc is not None:
        out.append(perceptual_loss(sr, hr_r, enc))
    return torch.stack(out)


_SSIM_WIN = 3  # skimage win_size the canonical metrics pin (ops/metrics.py)


def _lr_too_small(h, w, f, extra_downscale, idx=None) -> bool:
    """True when an LR image cannot be scored: the optional ÷factor
    downscale would collapse a side below 1px, or the SR output would be
    smaller than the SSIM window (3px). Skipped with a warning, since its
    NaN metrics would poison the averages."""
    if extra_downscale:
        h, w = h // f, w // f
    if min(h, w) >= 1 and min(h, w) * f >= _SSIM_WIN:
        return False
    warnings.warn(
        f"eval pair #{idx}: LR image {h}x{w} "
        f"{'after the ÷%d downscale quirk ' % f if extra_downscale else ''}"
        f"is too small to score (needs >=1px sides and a >={_SSIM_WIN}px SR "
        "output for the SSIM window) — skipped",
        stacklevel=2,
    )
    return True


def _edge_pad(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """HWC image edge-padded by ``ph`` rows and ``pw`` columns at the end."""
    out = F.pad(img.permute(2, 0, 1)[None], (0, pw, 0, ph), mode="replicate")
    return out[0].permute(1, 2, 0)


def _evaluate_bucketed(
    eval_data, upscaler, *, extra_downscale, apply_enhance, verbose
) -> tuple:
    """Size-bucketed scoring: every LR image edge-padded to the set's
    largest (post-downscale) size, SR'd at that shape, and scored with
    masked PSNR/SSIM over its valid extent. Returns ``(nan, nan, None)``
    when no pair can be scored (the JAX package returns a 2-tuple there,
    against its own fixed-arity rule)."""
    f = upscaler.model.upscale_factor
    dev = upscaler.device

    def load(idx):
        pair = eval_data[idx]
        if pair is None:
            return None  # corrupt-file skip
        lr_img, hr_img = pair
        lr = torch.from_numpy(lr_img).to(dev)
        if extra_downscale:
            lr = resize_bilinear(lr[None], (lr.shape[0] // f, lr.shape[1] // f))[0]
        return lr, torch.from_numpy(hr_img).to(dev)

    # Pass 1 needs only the post-downscale LR shapes, from the image
    # headers when the dataset exposes file paths (no pixel decode).
    def raw_lr_shape(idx):
        if hasattr(eval_data, "dir1") and hasattr(eval_data, "files1"):
            from PIL import Image

            try:
                path = os.path.join(eval_data.dir1, eval_data.files1[idx])
                with Image.open(path) as im:
                    w, h = im.size
                return h, w
            except Exception:
                return None  # corrupt file: pass 2's load() also skips it
        pair = eval_data[idx]
        return None if pair is None else pair[0].shape[:2]

    shapes, keep = [], []
    for idx in range(len(eval_data)):
        raw = raw_lr_shape(idx)
        if raw is None:
            continue
        if _lr_too_small(raw[0], raw[1], f, extra_downscale, idx=idx):
            continue
        shapes.append(
            (raw[0] // f, raw[1] // f) if extra_downscale else tuple(raw)
        )
        keep.append(idx)
    if not keep:
        return float("nan"), float("nan"), None

    bucket_h = max(h for h, _ in shapes)
    bucket_w = max(w for _, w in shapes)

    # GroupNorm normalises over the whole padded extent, so heavy padding
    # shifts the statistics the valid pixels were produced with
    if getattr(upscaler.model, "norm", "none") != "none":
        worst = min((h * w) / (bucket_h * bucket_w) for h, w in shapes)
        if worst < 0.75:
            warnings.warn(
                "bucketed eval with a GroupNorm model: the smallest image "
                f"fills only {worst:.0%} of the {bucket_h}x{bucket_w} "
                "bucket; edge padding shifts GroupNorm statistics, so "
                "scores can differ slightly from per-image (non-bucketed) "
                "evaluation. Use --bucketed only on size-homogeneous sets, "
                "or compare against a non-bucketed run.",
                stacklevel=2,
            )

    t_psnr, t_ssim, n = 0.0, 0.0, 0
    for idx in keep:
        item = load(idx)
        if item is None:  # file vanished between passes
            continue
        lr, hr = item
        lh, lw = lr.shape[:2]
        lr_pad = _edge_pad(lr, bucket_h - lh, bucket_w - lw)
        # HR resized to the valid SR size (``src/evaluation.py:52-53``),
        # then edge-padded to the bucket's SR shape
        hr_r = resize_bilinear(hr[None], (f * lh, f * lw))[0]
        hr_pad = _edge_pad(hr_r, f * (bucket_h - lh), f * (bucket_w - lw))
        p, s = _score_masked(upscaler, lr_pad, hr_pad, f * lh, f * lw,
                             apply_enhance).tolist()
        t_psnr += p
        t_ssim += s
        n += 1
        if verbose:
            print(
                f"[{n}/{len(eval_data)}] psnr={t_psnr / n:.4f} "
                f"ssim={t_ssim / n:.4f}",
                end="\r",
            )
    avg_psnr = t_psnr / max(1, n)
    avg_ssim = t_ssim / max(1, n)
    if verbose:
        print(f"\naverage psnr = {avg_psnr}, average ssim = {avg_ssim}")
    return avg_psnr, avg_ssim, None


@torch.no_grad()
def _score_masked(upscaler, lr_pad, hr_pad, valid_h, valid_w,
                  apply_enhance) -> torch.Tensor:
    sr = upscaler.forward(lr_pad[None])
    if apply_enhance:
        sr = enhance(sr)
    sr = sr[0]
    return torch.stack([psnr_masked(sr, hr_pad, valid_h, valid_w),
                        ssim_masked(sr, hr_pad, valid_h, valid_w)])


def main(argv=None):
    """Standalone entry point (the reference ships ``evaluation.py`` as its
    own script, ``evaluation.py:15-79``)."""
    print("evaluating!")
    parser = argparse.ArgumentParser("evaluating sr")
    parser.add_argument(
        "-D", "--data_dir",
        default=os.path.join(os.getcwd(), "data"),
        help="where the evaluation dataset stored",
    )
    parser.add_argument(
        "-lr", "--lr_dir", default="LRbicx4",
        help="where low resolution images stored under eval dataset",
    )
    parser.add_argument(
        "-hr", "--hr_dir", default="original",
        help="where high resolution images stored under eval dataset",
    )
    parser.add_argument("--no-extra-downscale", action="store_true")
    parser.add_argument("--no-enhance", action="store_true")
    parser.add_argument("--bucketed", action="store_true")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--prefix", default="Training")
    parser.add_argument("--perceptual-metric", default=None, metavar="NPZ")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on ('cpu' runs on the CPU)")
    args, _ = parser.parse_known_args(argv)
    return evaluate_model(
        dataset=args.data_dir,
        lr_path=args.lr_dir,
        hr_path=args.hr_dir,
        results_dir=args.results_dir,
        prefix=args.prefix,
        extra_downscale=not args.no_extra_downscale,
        apply_enhance=not args.no_enhance,
        bucketed=args.bucketed,
        perceptual_metric=args.perceptual_metric,
        device=args.device,
    )


if __name__ == "__main__":
    main()
