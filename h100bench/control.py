"""The controls of ``correct``: what the comparison reads where the
program is replaced by the reference in a lower precision, or broken.

    python3 h100bench/control.py --workload <cell> --seed <n> --variant <v> [--seconds s]

Variants:
- ``fp8``: the reference with every conv's input, kernel and output, their
  gradients, the discriminator's output and the LR batch rounded to float8
  e4m3 (per-tensor scale), the step below the configuration's bfloat16; in
  training cells from the same weights, rows and draws as a run, in
  serving cells in the ``Upscaler``'s place through a short window.
- ``bf16``: the same rounded to bfloat16, the configuration's own
  precision: what rounding alone does to each number (not a control).
- ``half_batch`` (training): the reference trained on the first half of
  every batch (of each rank's rows on several cards), the mean taken over
  it.
- ``unchanged`` (training): steps that leave every parameter as it was.
- ``no_mutual`` (the pool): the program with its epoch end's mutual
  learning switched off, through a short run.
- ``no_adversarial`` (the pool): the program with its GAN updates handed
  no adversarial term, the draws made and reported as usual, through a
  short run.
- ``altered`` (serving): the program, with one answer's centre patch
  inverted where it is produced.
- ``skip_average`` (several cards): the program, its last rank stepping
  on its own gradient, un-averaged (it still joins every all-reduce),
  through a short run.
- ``local_totals`` (several cards): the program with each rank's loss
  over its own rows, K1's and K2's totals not summed over the ranks and
  the gradient not scaled for the average, through a short run.

Prints the numbers compared with the cell's limits, and the verdict; a
variant that runs the program on several cards starts one process a card,
as the benchmark does (``ranks.py``), and rank 0 prints. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "bf16":
        return t.to(torch.bfloat16).to(t.dtype)
    s = 448.0 / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s


class _Rounded(torch.autograd.Function):
    """A value rounded to ``fmt`` where it is made, and its gradient rounded
    where that is made, as a program computing in ``fmt`` rounds both."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return _round(t, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt), None


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 at a per-tensor scale, forward and backward."""
    return _Rounded.apply(t, "fp8")


def bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, forward and backward: the configuration's own
    precision, for a look at which gaps rounding alone makes."""
    return _Rounded.apply(t, "bf16")


def _skip_average(trainer):
    """The last rank applies its own gradient: the all-reduce runs on a
    copy, so the other ranks still meet it."""
    import torch.distributed as dist
    from srgan_tpu_torch.training import train_state

    if dist.get_rank() != dist.get_world_size() - 1:
        return
    average = train_state.average_grads

    def skipped(grads, group=None):
        grads = list(grads)
        average([g.clone() for g in grads], group)
        return grads

    train_state.average_grads = skipped


def _local_totals(trainer):
    """The loss of this rank's rows alone, as a port that leaves out the
    exchange has it: K1 and K2 without the process group, so their totals
    are this rank's and the backward is not scaled by the world size; the
    ranks' gradients are still averaged."""
    from srgan_tpu_torch.ops.cuda.recon_loss_kernel import ReconstructionLoss
    from srgan_tpu_torch.training import steps

    steps.reconstruction_loss = lambda hr, sr, group=None: ReconstructionLoss.apply(
        hr, sr, None)[:2]


PROGRAM_FAULTS = {"skip_average": _skip_average, "local_totals": _local_totals}


def train_readings(spec, seed: int, variant: str, device) -> dict:
    """A training cell's numbers with ``variant`` in the program's place,
    over the steps a run compares (``reference.train.enough``)."""
    from h100bench import arch, inputs
    from h100bench.kinds.train import CHECKED_STEPS, check_steps, first_epoch_batches
    from h100bench.reference import loss as ref_loss
    from h100bench.reference import model as ref_model
    from h100bench.reference import train as ref_train

    config, traffic = spec.config, spec.traffic
    m_cfg, d_cfg = config["model"], config.get("discriminator")
    gen = arch.load(m_cfg)
    hr_hw, batch = tuple(config["data"]["hr_size"]), config["data"]["batch_size"]
    n_gen = config.get("pool", {}).get("num_generators", 1)
    use_gan = bool(config["train"].get("use_gan"))
    world = spec.cell["chips"]
    n_train = traffic["train_images"]
    clips = inputs.clips_u8(n_train + traffic["val_images"], hr_hw, inputs.seed_for(seed, 1),
                            device)[:n_train].cpu().numpy()
    w0 = [inputs.weights(gen.param_shapes(m_cfg), inputs.seed_for(seed, 2, i), device,
                         gen.param_scale) for i in range(n_gen)]
    d0 = (inputs.weights(ref_model.discriminator_param_shapes(d_cfg), inputs.seed_for(seed, 3),
                         device) if use_gan else None)
    # the pool's first GAN updates may come late in the epoch; pixel steps stop at the last compared
    n_steps = (int(config["data"]["split_ratio"] * n_train) // world // batch if use_gan
               else CHECKED_STEPS)
    epoch = first_epoch_batches(config, clips, seed, device, set(range(n_steps)), world)
    quant = {"fp8": fp8, "bf16": bf16}.get(variant)
    if quant is not None:
        fed = [(h, quant(l)) for h, l in epoch.values()]
    elif variant == "half_batch":  # the first half of each rank's rows
        half = lambda t: torch.cat([r[: batch // 2] for r in t.split(batch)])  # noqa: E731
        fed = [(half(h), half(l)) for h, l in epoch.values()]
    else:
        fed = list(epoch.values())
    nets0 = list(w0) + ([d0] if use_gan else [])
    members, d, rec = ref_train.run_steps(
        config, [ref_train.trainable(w) for w in w0],
        ref_train.trainable(d0) if use_gan else None, fed, seed, quant, least=CHECKED_STEPS,
        shards=world)
    lists = lambda ds: [[v for v in p.values()] for p in ds]  # noqa: E731
    gan = [dict(g, params=list(g["params"].values()), d_params=list(g["d_params"].values()),
                grad=list(g["grad"].values())) for g in rec.gan]
    if variant == "half_batch":  # the LR the program was handed, whole
        for g in gan:
            g["lr"] = epoch[g["step"]][1]
    if variant == "unchanged":
        params = lists(nets0)
        grads = [[[torch.zeros_like(v) for v in w.values()] for w in nets0]
                 for _ in range(CHECKED_STEPS)]
        for g in gan:
            g["grad"] = [torch.zeros_like(v) for v in g["grad"]]
    else:
        params = lists(rec.after_least)
        grads = [lists(step) for step in rec.grads[:CHECKED_STEPS]]
    totals = [ref_loss.edge_totals(h) for h, _ in fed[:CHECKED_STEPS]] if world > 1 else []
    cap = types.SimpleNamespace(
        totals=totals,
        losses=[torch.tensor(step) for step in rec.losses[:CHECKED_STEPS]],
        lr=[l for _, l in fed[:CHECKED_STEPS]] if variant != "half_batch"
        else [l for _, l in list(epoch.values())[:CHECKED_STEPS]],
        masks=rec.masks, grads=grads, params=params, gan=gan)
    del members, d
    steps = set(range(CHECKED_STEPS)) | {g["step"] for g in gan}
    return check_steps(config, cap, w0, d0, {k: epoch[k] for k in steps}, seed, world)


def serve_readings(spec, seed: int, variant: str, seconds: float, device) -> dict:
    """A serving cell's numbers with ``variant`` in the program's place,
    through a short window at the cell's load."""
    from h100bench import arch, run
    from h100bench.kinds.serve import quantize

    m_cfg = spec.config["model"]
    forward = arch.load(m_cfg).forward

    def hook(up):
        serve = up.upscale_u8
        if variant == "fp8":
            w = {k: p.detach().float() for k, p in up.model.named_parameters()}

            @torch.no_grad()
            def replaced(img):
                x = torch.from_numpy(img).to(device).float()[None] / 255.0
                return quantize(forward(w, x, m_cfg, fp8)[0]).cpu().numpy()

            up.upscale_u8 = replaced
        else:
            def altered(img):
                out = serve(img).copy()
                h, w = out.shape[0] // 2, out.shape[1] // 2
                out[h - 16:h + 16, w - 16:w + 16] = 255 - out[h - 16:h + 16, w - 16:w + 16]
                return out

            up.upscale_u8 = altered

    args = types.SimpleNamespace(workload=spec.cell["name"], seed=seed, seconds=seconds, trace=0)
    return run.execute(args, device=device, faults=[hook], overrides=spec.overrides)["checks"]


def program_fault_readings(spec, seed: int, variant: str, seconds: float, device) -> dict:
    """A training cell's numbers, judged, from a short run of the program
    with ``PROGRAM_FAULTS[variant]`` planted (one rank's share on several
    cards)."""
    from h100bench import run

    args = types.SimpleNamespace(workload=spec.cell["name"], seed=seed, seconds=seconds, trace=0)
    return run.execute(args, device=device, faults=[PROGRAM_FAULTS[variant]],
                       overrides=spec.overrides)["checks"]


def no_mutual_readings(spec, seed: int, seconds: float, device) -> dict:
    """The pool's numbers from a short run whose epoch end keeps every
    member as it was (mutual learning switched off in the program)."""
    import dataclasses

    from h100bench import run

    def hook(trainer):
        spool = trainer.spool
        spool.cfg = dataclasses.replace(spool.cfg, mutual_learning=False)

    args = types.SimpleNamespace(workload=spec.cell["name"], seed=seed, seconds=seconds, trace=0)
    return run.execute(args, device=device, faults=[hook], overrides=spec.overrides)["checks"]


def no_adversarial_readings(spec, seed: int, seconds: float, device) -> dict:
    """The pool's numbers from a short run whose GAN updates lose their
    adversarial term: the draws are made and reported, and the step is
    handed none."""
    import numpy as np

    from h100bench import run

    def hook(trainer):
        step, gan_step = trainer.pool_steps
        trainer.pool_steps = (step, lambda states, d, hr, lr_imgs, mask, *a, **k: gan_step(
            states, d, hr, lr_imgs, np.zeros_like(mask), *a, **k))

    args = types.SimpleNamespace(workload=spec.cell["name"], seed=seed, seconds=seconds, trace=0)
    return run.execute(args, device=device, faults=[hook], overrides=spec.overrides)["checks"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--variant", required=True,
                   choices=("fp8", "bf16", "half_batch", "unchanged", "altered", "no_mutual",
                            "no_adversarial", *PROGRAM_FAULTS))
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from h100bench import compare, ranks, run

    run._cache_env()
    spec = run.load_cell(a.workload)
    spec.overrides = None
    chips = spec.cell["chips"]
    if a.variant in PROGRAM_FAULTS and chips > 1 and not ranks.is_rank():
        worst = 0
        for seed in a.seed:  # one set of ranks a seed
            worst = worst or ranks.launch(
                [str(Path(__file__).resolve()), "--workload", a.workload, "--seed", str(seed),
                 "--variant", a.variant, "--seconds", str(a.seconds)],
                chips, time.perf_counter(), run.LAUNCH_TIMEOUT_S)
        return worst
    device = torch.device("cuda")
    for seed in a.seed:
        if a.variant in PROGRAM_FAULTS:
            judged = program_fault_readings(spec, seed, a.variant, a.seconds, device)
            ok = all(v is not None and lim is not None and v <= lim for v, lim in judged.values())
            if ranks.rank() != 0:
                continue
        elif a.variant in ("no_mutual", "no_adversarial"):
            readings = no_mutual_readings if a.variant == "no_mutual" else no_adversarial_readings
            judged = readings(spec, seed, a.seconds, device)
            ok = all(v is not None and lim is not None and v <= lim for v, lim in judged.values())
        elif spec.traffic["kind"] == "train":
            checks = train_readings(spec, seed, a.variant, device)
            ok, judged = compare.judge(checks, spec.limits)
        else:
            judged = serve_readings(spec, seed, a.variant, a.seconds, device)
            ok = all(v is not None and lim is not None and v <= lim for v, lim in judged.values())
        noted = [n for n in compare.NOTES if n.startswith("not compared")]
        compare.NOTES.clear()
        print(json.dumps({"workload": a.workload, "variant": a.variant, "seed": seed,
                          "correct": ok, "checks": judged, "noted": noted}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
