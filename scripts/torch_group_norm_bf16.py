"""Which bf16 GroupNorm form the port can use on the card, and what each
costs: torch's CUDA ``group_norm`` on a bf16 input with f32 weights, the
same with bf16 weights, and the form the port ships (f32 compute, one
rounding at the output: flax's rounding points). Prints, for the flagship's
block activation at batch 12, (12, 64, 128, 256) NCHW, whether each form
runs, how many elements differ from the shipped form, and each form's ms a
call by CUDA events (median of 5 windows of 20 calls), beside the card's
name and power limit.

    python3 scripts/torch_group_norm_bf16.py

Needs one CUDA device; imports nothing of the repo.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

SHAPE = (12, 64, 128, 256)
GROUPS, EPS = 8, 1e-6


def time_ms(fn, windows: int = 5, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(SHAPE, generator=g, device="cuda") * 3 + 1).to(torch.bfloat16)
    w = torch.randn(SHAPE[1], generator=g, device="cuda") * 0.5 + 1
    b = torch.randn(SHAPE[1], generator=g, device="cuda") * 0.1

    def shipped():
        return F.group_norm(x.float(), GROUPS, w, b, EPS).to(torch.bfloat16)

    forms = {
        "f32 compute, bf16 output (shipped)": shipped,
        "bf16 input, f32 weights": lambda: F.group_norm(x, GROUPS, w, b, EPS),
        "bf16 input, bf16 weights": lambda: F.group_norm(
            x, GROUPS, w.to(torch.bfloat16), b.to(torch.bfloat16), EPS),
    }
    ref = shipped()
    for name, fn in forms.items():
        try:
            y = fn()
        except RuntimeError as e:
            print(f"{name}: refused: {e}")
            continue
        diff = int((y.to(torch.bfloat16) != ref).sum())
        print(f"{name}: output {y.dtype}, {diff} of {ref.numel()} elements differ "
              f"from the shipped form; {time_ms(fn):.4f} ms a call")
    return 0


if __name__ == "__main__":
    sys.exit(main())
