"""Time the pool's GAN step at the flagship size for the checkout in the
working directory: ``chip_smoke.py``'s ``pool gan flagship`` run (N=3 on
the stacked scan executor, bf16, batch 12, HR 512x1024, D of 4 stages at
64 filters, every member on a GAN update), one warm-up epoch and then
``--epochs`` counted epochs of 3 steps. Prints ms/step of each counted
epoch, the peak memory and the card's name and power limit, as one JSON
line. Run it from each of two checkouts in one call to compare them
(parent, change, change, parent):

    cd <checkout> && python3 <path to>/scripts/torch_pool_gan_time.py --epochs 3

Needs one CUDA device. Imports ``chip_smoke`` and ``srgan_tpu_torch`` from
the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from srgan_tpu_torch.ops.cuda.build import build
    from srgan_tpu_torch.utils.platform import disable_tf32

    build()
    disable_tf32()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clips = cs.smooth_clips(dev, cs.FLAGSHIP_STEPS * 12, 1)
    step_ms, peak = [], 0
    with tempfile.TemporaryDirectory() as results_dir:
        run = cs.Flagship(dev, "bfloat16", 12, clips, results_dir, n_gen=3, gan=True)
        try:
            for _ in range(args.epochs):
                torch.cuda.reset_peak_memory_stats()
                _, dt = run.epoch()
                step_ms.append(dt / cs.FLAGSHIP_STEPS * 1e3)
                peak = max(peak, torch.cuda.max_memory_allocated())
        finally:
            run.close()
    print(json.dumps({"checkout": os.getcwd(), "card": smi, "ms_per_step": step_ms,
                      "peak_gib": peak / 2**30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
