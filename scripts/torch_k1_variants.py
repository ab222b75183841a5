"""Time variants of the edge-statistics kernel K1 (``edge_stats_kernel`` +
``edge_stats_finalize`` in ``srgan_tpu_torch/csrc/recon_loss.cu``) side by
side on one NVIDIA GPU.

    python3 scripts/torch_k1_variants.py [--variants 6x4,8x4,...] [--rounds 2]
                                         [--batch 12]

A variant ``SxB`` is the source built with ``-DK1_SLOTS=S
-DK1_BLOCKS_PER_SM=B``: a ring of S register rows (S - 3 rows in flight
past the 3-row window) and B blocks of 4 warps an SM. All builds run in
parallel. At the flagship loss shape (12, 512, 1024, 3) f32 (``--batch``
sets its first dimension, to tell a fixed cost a launch from a rate), on
the vector path, each variant's stats are held against the plain version (rel 1e-4)
and two calls bit for bit; then the variants are timed in turns, forward
then backward order each round: device ms a launch of kernel and finalise
by the profiler (20 calls) and ms a call by CUDA events (5 windows of 20
calls), the medians over the rounds. Prints the card's name and power
limit and one JSON line a variant, with its ``ptxas`` registers and
spills and the bytes it keeps in flight an SM.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from srgan_tpu_torch.ops.cuda import build as bd  # noqa: E402
from srgan_tpu_torch.ops.cuda import recon_loss_kernel as rk  # noqa: E402
from srgan_tpu_torch.utils.platform import disable_tf32  # noqa: E402

K1_RE = re.compile(r"\d+edge_stats_kernelILi3ELb([01])E")


def build_variants(variants) -> dict:
    """{(S, B): (bound library, {path: ptxas resources})}, one nvcc each,
    all started together."""
    bd.BUILD_DIR.mkdir(exist_ok=True)
    nvcc = bd._nvcc()
    running = {}
    for s, b in variants:
        out = bd.BUILD_DIR / f"librecon_loss-k1-{s}x{b}.so"
        cmd = [nvcc, *bd.NVCC_FLAGS, f"-DK1_SLOTS={s}", f"-DK1_BLOCKS_PER_SM={b}",
               "-o", str(out), str(bd.CSRC / "recon_loss.cu")]
        running[(s, b)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True), out)
    outputs = {v: proc.communicate() for v, (proc, _) in running.items()}
    libs = {}
    for v, (proc, out) in running.items():
        stdout, stderr = outputs[v]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{stdout}{stderr}")
        res = {}
        for name, r in cs.ptxas_resources(stderr).items():
            if m := K1_RE.search(name):
                res["vec" if m.group(1) == "1" else "scalar"] = r
        libs[v] = (rk._bind(ctypes.CDLL(str(out))), res)
    return libs


def device_ms(fn, reps: int = 20) -> tuple:
    """(kernel, finalise) device ms a launch over ``reps`` calls, averaged
    over the launches the profiler recorded (it may drop one)."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {"edge_stats_kernel": [], "edge_stats_finalize": []}
    for e in cs._device_events(prof):
        for sym, vals in us.items():
            if re.search(rf"\b{sym}\b", e.name):
                vals.append(e.time_range.elapsed_us())
    for sym, vals in us.items():
        cs.check(len(vals) >= reps // 2, f"profiler saw {len(vals)} launches of {sym}")
    return tuple(sum(v) / len(v) / 1e3 for v in us.values())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="6x4,8x4,10x4,12x4,6x6,8x6,6x8,8x8")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=cs.LOSS_SHAPE[0])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_variants: no CUDA device", file=sys.stderr)
        return 1
    variants = [tuple(int(x) for x in v.split("x")) for v in args.variants.split(",")]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_variants(variants)

    dev = torch.device("cuda")
    disable_tf32()
    cs.LOSS_SHAPE = (args.batch, *cs.LOSS_SHAPE[1:])
    hr, _ = cs.loss_inputs(dev)
    cs.check(rk.vector_path(hr), "the flagship shape must take the vector path")
    want = rk.edge_stats_plain(hr)
    stream = torch.cuda.current_stream().cuda_stream
    fns = {v: (lambda lib=lib: rk._launch_edge_stats(lib, hr, True, stream))
           for v, (lib, _) in libs.items()}
    err = {}
    for v, fn in fns.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        cs.check(torch.equal(a, b), f"variant {v}: two calls differ")
        err[v] = max(cs.rel_err(a[i], want[i]) for i in range(2))
        cs.check(err[v] <= 1e-4, f"variant {v}: stats rel err {err[v]} > 1e-4")

    times = {v: {"kernel": [], "finalize": [], "events": []} for v in variants}
    for r in range(args.rounds):
        for v in (variants if r % 2 == 0 else variants[::-1]):
            kern, fin = device_ms(fns[v])
            times[v]["kernel"].append(kern)
            times[v]["finalize"].append(fin)
            times[v]["events"] += cs.time_ms(fns[v])
    bound_ms = hr.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (s, b), t in times.items():
        lib, res = libs[(s, b)]
        kern, fin = (statistics.median(t[k]) for k in ("kernel", "finalize"))
        ms = statistics.median(t["events"])
        print(json.dumps({
            "variant": f"{s}x{b}", "slots": s, "blocks_per_sm": b,
            "shape": list(hr.shape),
            "in_flight_kb_per_sm": (s - 3) * 16 * 32 * 4 * b / 1024,
            "blocks": lib.recon_stats_blocks(*hr.shape), "sms": sms,
            "kernel_device_ms": kern, "finalize_device_ms": fin,
            "device_ms": kern + fin, "bound_ms": bound_ms,
            "bound_share": bound_ms / (kern + fin), "ms": ms,
            "host_gap_ms": ms - (kern + fin), "max_rel_err": err[(s, b)],
            "kernel_device_ms_rounds": t["kernel"],
            "ptxas_vec": res.get("vec"), "ptxas_scalar": res.get("scalar"),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
