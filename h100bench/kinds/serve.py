"""Serving cells: ``Upscaler.upscale_u8`` of the port, one request at a
time, in a closed loop with one client.

Each request is a host uint8 LR image; its latency runs on the host clock
from the call to the returned uint8 array. The sizes come from the
traffic file's shares: every seed serves the same cycle of sizes in the
same order (shuffled once by the traffic's ``order_seed``: a seeded order
moved the p95 by 6 % from seed to seed, as the last partial cycle and each
4K request's predecessor changed), and the same number of images of each
size, their pixels made from the seed. Set-up warms each size once.

Once the window has closed, the requests of a sample drawn from the seed
(with the first of each size in it, so the largest too) are served again
by the plain fp32 reference from the same weights and compared pixel by
pixel.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import arch, compare, inputs, work


def size_cycle(traffic: dict) -> list:
    """The cycle of request sizes: ``cycle`` requests in the traffic's
    shares, in the order its ``order_seed`` draws."""
    cyc = []
    for h, w, share in traffic["lr_sizes"]:
        cyc += [(h, w)] * round(share * traffic["cycle"] / 100)
    order = np.random.default_rng(traffic["order_seed"]).permutation(len(cyc))
    return [cyc[i] for i in order]


def sample(cycle: list, traffic: dict, seed: int) -> set:
    """Request indices whose answers are kept and compared: the first two
    of each size and ``sample_extra`` drawn from the first ``sample_from``."""
    keep = {i for s in set(cycle) for i in [j for j, c in enumerate(cycle) if c == s][:2]}
    rng = np.random.default_rng(inputs.seed_for(seed, 21))
    keep |= set(rng.choice(traffic["sample_from"], traffic["sample_extra"], replace=False).tolist())
    return keep


def p95_ms(latencies_s) -> float:
    """The 95th percentile, in ms, of every request's latency (numpy's
    linear interpolation between order statistics)."""
    return float(np.percentile(np.asarray(latencies_s) * 1e3, 95))


def quantize(sr: torch.Tensor) -> torch.Tensor:
    return torch.floor(sr.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def serve_work(m_cfg: dict, sizes) -> work.Work:
    """The work of serving one request of each LR size in ``sizes``."""
    gen = arch.load(m_cfg)
    wk = work.Work(m_cfg["compute_dtype"])
    for size in set(sizes):
        wk.add(gen.forward_ops(m_cfg, size), 1, sizes.count(size))
    return wk


def run(ctx) -> dict:
    config, traffic, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    from srgan_tpu_torch.eval.inference import Upscaler
    from h100bench.kinds.train import _load, port_config

    m_cfg = config["model"]
    gen = arch.load(m_cfg)
    cuda = dev.type == "cuda"
    t_start = time.perf_counter()
    cfg = port_config(config, seed, "unused")
    model = gen.port_model(cfg.model).to(dev)
    w = inputs.weights(gen.param_shapes(m_cfg), inputs.seed_for(seed, 2, 0), dev,
                       gen.param_scale)
    _load(model, w)
    up = Upscaler(model, device=dev)
    for hook in ctx.faults:
        hook(up)
    cycle = size_cycle(traffic)
    images = {}
    for j, (h, wd) in enumerate(sorted(set(cycle))):
        imgs = inputs.clips_u8(traffic["images_per_size"], (h, wd), inputs.seed_for(seed, 22, j),
                               dev, cells=tuple(traffic["cells"]))
        images[(h, wd)] = list(imgs.cpu().numpy())
    keep = sample(cycle, traffic, seed)
    t_inputs = time.perf_counter()
    for size in sorted(images):  # every shape once, before the window
        up.upscale_u8(images[size][0])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    compare.NOTES.append(f"set-up: model and inputs {t_inputs - t_start:.3f} s, "
                         f"warm {time.perf_counter() - t_inputs:.3f} s")
    tracer = ctx.new_tracer()
    if tracer is not None:
        tracer.start()
    window = ctx.region("window")
    window.__enter__()
    lat, sizes, kept, failed = [], [], {}, 0
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    i = 0
    while time.perf_counter() < end:
        h, wd = cycle[i % len(cycle)]
        img = images[(h, wd)][(i // len(cycle)) % traffic["images_per_size"]]
        with ctx.region("request"):
            t = time.perf_counter()
            out = up.upscale_u8(img)
            lat.append(time.perf_counter() - t)
        f = m_cfg["upscale_factor"]
        if out.shape != (h * f, wd * f, 3) or out.dtype != np.uint8:
            failed += 1
        sizes.append((h, wd))
        if i in keep:
            kept[i] = (img, out)
        i += 1
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    window.__exit__(None, None, None)
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_s = t1 - t0
    f = m_cfg["upscale_factor"]
    mpix = sum(h * wd * f * f for h, wd in sizes) / 1e6
    wk = serve_work(m_cfg, sizes)
    result = {
        "attempted": len(lat), "failed": failed, "peak_bytes": peak, "t_window": t0,
        "e2e": {"serve_mpix_s": mpix / window_s,
                "serve_ms_p95": p95_ms(lat),
                "peak_mem_gib": peak / 2**30},
        "run": dict(kind="serve", window_s=window_s, requests=len(lat), work=wk.as_dict(),
                    idle_label="between_requests", dtype=m_cfg["compute_dtype"]),
        "tracer": tracer,
    }
    del up, model
    torch.cuda.empty_cache()
    result["checks"] = check_answers(m_cfg, w, kept, dev)
    result["checks"]["sizes_unchecked"] = float(len(set(cycle) - {img.shape[:2] for img, _ in kept.values()}))
    return result


@torch.no_grad()
def check_answers(m_cfg: dict, w: dict, kept: dict, dev, quant=None) -> dict:
    """The widest and the mean gap in uint8 levels between each kept answer
    and the reference's, over the sample."""
    forward = arch.load(m_cfg).forward
    worst_max, worst_mean = 0.0, 0.0
    for i, (img, out) in sorted(kept.items()):
        x = torch.from_numpy(img).to(dev).float()[None] / 255.0
        ref = quantize(forward(w, x, m_cfg, quant)[0]).cpu().numpy()
        g = compare.u8_gaps(out, ref)
        worst_max, worst_mean = max(worst_max, g["max"]), max(worst_mean, g["mean"])
        d = np.abs(out.astype(np.int16) - ref.astype(np.int16))
        compare.NOTES.append(
            f"request {i} {img.shape[:2]}: max {g['max']:.0f} mean {g['mean']:.4f} "
            f"p99 {np.percentile(d, 99):.0f} p99.9 {np.percentile(d, 99.9):.0f} "
            f">4 {float((d > 4).mean()):.5f} >16 {float((d > 16).mean()):.6f}")
    return {"u8_max_gap": worst_max, "u8_mean_gap": worst_mean}
