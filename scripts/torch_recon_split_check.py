"""The loss kernels' split finalise against an older tree's kernels, bit for
bit, on one NVIDIA GPU at the flagship loss shape (12, 512, 1024, 3) f32.

    python3 scripts/torch_recon_split_check.py --older <tree>

``<tree>`` holds an older commit's ``srgan_tpu_torch/csrc/recon_loss.cu``
whose K1 and K2 end in a one-block finalise (``recon_edge_stats(hr, B, H,
W, C, vec, partials, stats, stream)`` and ``recon_loss_sums(..., partials,
stats, edge_loss, tv_loss, stream)``, K3 taking the count as no argument
but computing it), e.g. ``git archive <commit> srgan_tpu_torch/csrc | tar
-x -C _dev/older``. It builds that source with this tree's nvcc flags and
runs K1 → K2 → K3 of both on the same inputs (``chip_smoke.loss_inputs``):
the statistics, both losses and d/d sr must be equal bit for bit. Then it
joins a one-rank NCCL group from torchrun's variables and holds this tree's
group path (the totals all-gathered between each totals stage and its
finalise) bit for bit against its no-group path, and times a K1 → K2 → K3
triple with its synchronisation each way by CUDA events (the median of 5
windows of 10). Prints the card's name and power limit and one JSON line;
exits 1 if a comparison fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def _older_lib(tree: str, out_dir: str) -> ctypes.CDLL:
    from srgan_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc

    src = os.path.join(tree, "srgan_tpu_torch", "csrc", "recon_loss.cu")
    out = os.path.join(out_dir, "librecon_older.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn in ("recon_stats_blocks", "recon_sums_blocks"):
        getattr(lib, fn).argtypes = [I, I, I, I]
        getattr(lib, fn).restype = I
    lib.recon_edge_stats.argtypes = [P, I, I, I, I, I, P, P, P]
    lib.recon_loss_sums.argtypes = [P, P, I, I, I, I, I, P, P, P, P, P]
    lib.recon_loss_grad.argtypes = [P, P, I, I, I, I, I, P, P, P, P, P]
    for fn in ("recon_edge_stats", "recon_loss_sums", "recon_loss_grad"):
        getattr(lib, fn).restype = I
    return lib


def _run_older(lib, hr, sr, g):
    b, h, w, c = hr.shape
    dev, st = hr.device, torch.cuda.current_stream().cuda_stream
    n1 = lib.recon_stats_blocks(b, h, w, c) * 2
    buf1 = torch.empty(n1 + 2, dtype=torch.float64, device=dev)
    stats = buf1[n1:].view(torch.float32)
    n2 = lib.recon_sums_blocks(b, h, w, c) * 3
    buf2 = torch.empty(n2 + 1, dtype=torch.float64, device=dev)
    edge_loss, tv_loss = buf2[n2:].view(torch.float32)
    dsr = torch.empty_like(sr)
    rcs = [
        lib.recon_edge_stats(hr.data_ptr(), b, h, w, c, 1, buf1.data_ptr(),
                             stats.data_ptr(), st),
        lib.recon_loss_sums(hr.data_ptr(), sr.data_ptr(), b, h, w, c, 1, buf2.data_ptr(),
                            stats.data_ptr(), edge_loss.data_ptr(), tv_loss.data_ptr(), st),
        lib.recon_loss_grad(hr.data_ptr(), sr.data_ptr(), b, h, w, c, 1, stats.data_ptr(),
                            g[0].data_ptr(), g[1].data_ptr(), dsr.data_ptr(), st),
    ]
    if any(rcs):
        raise RuntimeError(f"older kernels: CUDA errors {rcs}")
    torch.cuda.synchronize()
    return stats.clone(), edge_loss.clone(), tv_loss.clone(), dsr


def _run(rk, hr, sr, g, group=None):
    stats = rk.edge_stats(hr, group)
    edge_loss, tv_loss = rk.loss_sums(hr, sr, stats, group)
    dsr = rk.loss_grad(hr, sr, stats, *g)
    torch.cuda.synchronize()
    return stats.clone(), edge_loss.clone(), tv_loss.clone(), dsr


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--older", required=True, help="a tree of the older commit")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk
    from srgan_tpu_torch.parallel import mesh
    from srgan_tpu_torch.utils.platform import disable_tf32

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    disable_tf32()
    dev = torch.device("cuda")
    hr, sr = cs.loss_inputs(dev)
    g = (torch.tensor(1.0, device=dev), torch.tensor(0.7, device=dev))
    names = ("stats", "edge_loss", "tv_loss", "dsr")
    with tempfile.TemporaryDirectory() as tmp:
        older = _run_older(_older_lib(args.older, tmp), hr, sr, g)
    alone = _run(rk, hr, sr, g)
    out = {"against_older": {n: torch.equal(a[:4] if n == "stats" else a, b)
                             for n, a, b in zip(names, alone, older)}}

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    mesh.initialize_multihost()
    try:
        group = mesh.default_group()
        grouped = _run(rk, hr, sr, g, group)
        out["group_vs_alone"] = {n: torch.equal(a, b)
                                 for n, a, b in zip(names, grouped, alone)}
        out["ms_triple"] = {
            tag: statistics.median(cs.time_ms(lambda grp=grp: _run(rk, hr, sr, g, grp),
                                              windows=5, reps=10))
            for tag, grp in (("no group", None), ("one-rank group", group))}
    finally:
        torch.distributed.destroy_process_group()
    out["shape"] = list(hr.shape)
    print(json.dumps(out))
    ok = all(out["against_older"].values()) and all(out["group_vs_alone"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
