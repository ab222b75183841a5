"""Host cost of the loss-kernel wrappers (``srgan_tpu_torch.ops.cuda
.recon_loss_kernel``: K1 ``edge_stats``, K2 ``loss_sums``, K3 ``loss_grad``)
on one NVIDIA GPU, at the flagship loss shape (12, 512, 1024, 3) f32.

    cd <tree> && python3 <repo>/scripts/torch_loss_wrappers.py

It measures the tree it is run from (the current directory comes first on
the import path), so one call can time two checkouts in turns. For each
wrapper: host µs a call to enqueue it (perf_counter around 50 calls, no
synchronisation inside, so the card never holds the host back; the median
of 9 rounds, and the least: the host is shared, and its neighbours' noise
moves the median by up to half). Where the tree has them, the parts of K1's call alone: the
argument check, the path test, the device guard, the stream lookup, one
allocation, the block-count lookup and the bare ctypes call of
``recon_edge_stats`` (two launches). Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def host_us(fn, calls: int = 50, rounds: int = 9) -> dict:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"median": statistics.median(out), "min": min(out)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loss_wrappers: no CUDA device", file=sys.stderr)
        return 1
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
    from srgan_tpu_torch.utils.platform import disable_tf32

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    disable_tf32()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (12, 512, 1024, 3)
    hr = torch.randint(0, 256, shape, generator=g, device=dev).float() / 256.0
    sr = torch.randint(0, 256, shape, generator=g, device=dev).float() / 256.0
    st = rk.edge_stats(hr)
    one = torch.ones((), device=dev)
    rec = {
        "tree": os.getcwd(), "card": smi,
        "edge_stats_us": host_us(lambda: rk.edge_stats(hr)),
        "loss_sums_us": host_us(lambda: rk.loss_sums(hr, sr, st)),
        "loss_grad_us": host_us(lambda: rk.loss_grad(hr, sr, st, one, one)),
    }
    lib = rk._lib()

    guard = getattr(rk, "_on_device", lambda t: torch.cuda.device(t.device))

    def device_guard():
        with guard(hr):
            pass

    parts = {
        "check": lambda: rk._check(hr),
        "vector_path": lambda: rk.vector_path(hr),
        "device_guard": device_guard,
        "stream": lambda: rk._stream(hr),
        "empty": lambda: torch.empty(1054, dtype=torch.float64, device=dev),
    }
    if hasattr(rk, "_blocks"):
        parts["blocks"] = lambda: rk._blocks(lib, "recon_stats_blocks", hr.device,
                                             hr.shape)
        partials = torch.empty(rk._blocks(lib, "recon_stats_blocks", hr.device,
                                          hr.shape) * 2, dtype=torch.float64, device=dev)
        stats = torch.empty(4, device=dev)
        stream = rk._stream(hr)
        parts["ctypes_launch"] = lambda: lib.recon_edge_stats(
            hr.data_ptr(), *shape, 1, partials.data_ptr(), stats.data_ptr(), stream)
    for name, fn in parts.items():
        rec[f"part_{name}_us"] = host_us(fn)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
