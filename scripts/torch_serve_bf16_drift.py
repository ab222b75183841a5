"""Where the bf16 forward of the flagship generator on the card parts from
the same forward on the CPU, and how that compares with bf16's own
rounding noise.

    python3 scripts/torch_serve_bf16_drift.py [--seed 0] [--lr-hw 64 96] [--batch 2]

Builds the flagship ``SRResNet`` (F=64, 16 blocks, 4x subpixel head) with
bf16 compute from ``--seed`` on the card and on the CPU (same weights),
runs one LR batch of smooth random images through both, TF32 off, and
prints:

  - for each layer, the card chain's output against the CPU chain's (the
    error carried to that depth): max|Δ|/max|y| and ||Δ||/||y||;
  - for each layer alone, the card's layer on the CPU's input of that
    layer against the CPU's output: max|Δ|/max|y| (one bf16 rounding is
    2^-8 = 3.9e-3 of a value) and the share of elements that differ, which
    shows whether one layer or the accumulation parts them;
  - the SR: the card against the CPU in bf16, and each against the fp32
    forward of the same weights on the card (bf16's own error), with the
    uint8 frames' largest difference.

It ends with the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from srgan_tpu_torch.config import ModelConfig
from srgan_tpu_torch.models.srresnet import init_generator
from srgan_tpu_torch.training.steps import quantize_u8
from srgan_tpu_torch.utils.platform import disable_tf32


def _layers(model):
    names = ["stem", *[f"blocks.{i}" for i in range(len(model.blocks))], "mid",
             *[f"upsample.{j}" for j in range(len(model.upsample))], "tail"]
    return [(n, model.get_submodule(n)) for n in names]


def _capture(model, x):
    """The SR, and each layer's (input, output) of one forward."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: seen.__setitem__(n, (inp[0].detach(), out.detach())))
        for n, m in _layers(model)]
    with torch.no_grad():
        sr = model(x)
    for h in hooks:
        h.remove()
    return sr, seen


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    d = a - b
    return float(d.abs().max() / b.abs().max()), float(d.norm() / b.norm())


def _share_differing(got, want) -> float:
    return float((got.float().cpu() != want.float().cpu()).double().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr-hw", type=int, nargs=2, default=(64, 96))
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_bf16_drift: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    dev = torch.device("cuda")
    cfg = ModelConfig(compute_dtype="bfloat16")
    card = init_generator(cfg, args.seed, dev).eval()
    cpu = init_generator(cfg, args.seed).eval()
    fp32 = init_generator(ModelConfig(), args.seed, dev).eval()
    g = torch.Generator().manual_seed(args.seed)
    h, w = args.lr_hw
    coarse = torch.rand((args.batch, 3, max(h // 16, 1), max(w // 16, 1)), generator=g)
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic")
    x = x.clamp(0, 1).permute(0, 2, 3, 1).contiguous()

    sr_card, card_io = _capture(card, x.to(dev))
    sr_cpu, cpu_io = _capture(cpu, x)
    with torch.no_grad():
        sr_fp32 = fp32(x.to(dev))
    print(f"bf16 flagship, seed {args.seed}, LR {tuple(x.shape)}; layer: carried "
          "max|d|/max|y|, ||d||/||y|| | alone: max|d|/max|y|, share differing")
    for name, layer in _layers(card):
        carried = _rel(card_io[name][1], cpu_io[name][1])
        with torch.no_grad():
            alone = layer(cpu_io[name][0].to(dev))
        one = _rel(alone, cpu_io[name][1])[0]
        share = _share_differing(alone, cpu_io[name][1])
        print(f"  {name:12s} {carried[0]:.3e} {carried[1]:.3e} | {one:.3e} {share:.4f}")
    u8 = (quantize_u8(sr_card).cpu().int() - quantize_u8(sr_cpu).int()).abs()
    for tag, a, b in (("card vs CPU, bf16", sr_card, sr_cpu),
                      ("card bf16 vs card fp32", sr_card, sr_fp32),
                      ("CPU bf16 vs card fp32", sr_cpu, sr_fp32)):
        m, f = _rel(a, b)
        print(f"SR {tag}: max|d|/max|y| {m:.3e}, ||d||/||y|| {f:.3e}")
    print(f"SR uint8 card vs CPU, bf16: max {int(u8.max())} LSB, "
          f"{float((u8 > 1).double().mean()):.2e} of values beyond 1 LSB; "
          f"99.9th percentile |d| {float(np.quantile(u8.numpy(), 0.999)):.0f} LSB")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
