"""Training cells: ``Trainer.train`` of the port, as ``cli train`` runs it,
on clips made from the seed and held in the port's device cache.

Set-up builds one ``Trainer`` from the configuration's CLI flags, hands it
the benchmark's weights, and lets ``train`` run its first
``warm_epochs`` epochs (every step shape, the epoch end and the
validation cache warm). The window opens when epoch ``warm_epochs``
starts, or with the traffic's ``window_opens_at_batch`` k before that
epoch's batch k, and closes when ``train`` returns: a timer sends the
process SIGTERM after ``--seconds``, and the program's own preemption
path stops at the next batch boundary and writes its snapshot, which
counts. A window that opens mid-epoch also ends mid-epoch, away from an
epoch end, so that where the stop lands does not decide whether the
window holds one epoch end more.

The run's first steps (in set-up, through the same ``train`` call and
feed) are recorded: three, and in a pool with a discriminator each
member's first GAN update within the first epoch. Once the window has
closed and the program's state is freed, the plain fp32 reference follows
the first three from the same weights and rows, and works each GAN update
out again from the program's params before it (following twenty steps
from the seed would take longer than the window); in a pool the first
epoch end's mutual learning is checked from the program's state before
it. ``train_img_s`` counts the batches that ``train_epoch``
reports for the window's epochs.

On several cards (``ctx.group``) the run is ``cli train --multihost``:
every rank makes the whole set and the same weights from the seed, and
trains on its shard. ``train_img_s`` counts the global batch, and
``peak_mem_gib`` is the fullest card's. Rank 0 gathers every rank's LR
batches and params after the compared steps, and alone runs the
reference, a rank's rows at a time. The statistics that K1 and K2 hand
rank 0's loss in those steps (edge mean and std, the normalised map's sum,
the element count) are compared with the global batch's.
"""

from __future__ import annotations

import itertools
import os
import shutil
import signal
import tempfile
import threading
import time
from contextlib import ExitStack

import numpy as np
import torch

from h100bench import arch, compare, inputs, work
from h100bench.reference import data as ref_data
from h100bench.reference import loss as L
from h100bench.reference import model as ref_model
from h100bench.reference import train as ref_train

CHECKED_STEPS = 3


def port_config(config: dict, seed: int, results_dir: str, multihost: bool = False):
    """The port's ``Config`` as ``cli train`` builds it from the
    configuration's flags (with ``--multihost`` over several cards),
    checked against the configuration's numbers."""
    from srgan_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["train", *config["train_flags"], *(["--multihost"] if multihost else []),
         "--seed", str(seed), "--results-dir", results_dir, "--progress", "off"])
    cfg = cli.config_from_args(args)
    for section in ("model", "data", "train", "pool", "discriminator"):
        want = config.get(section, {})
        have = getattr(cfg, section)
        for key, val in want.items():
            if hasattr(have, key) and not _same(getattr(have, key), val):
                raise ValueError(f"{section}.{key}: the flags give {getattr(have, key)!r}, "
                                 f"the configuration states {val!r}")
    return cfg


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return list(a) == list(b)
    return a == b


def _load(model: torch.nn.Module, w: dict) -> None:
    names = dict(model.named_parameters())
    if list(names) != list(w):
        raise ValueError(f"parameter names or order differ: {list(names)[:4]} against {list(w)[:4]}")
    with torch.no_grad():
        for k, p in names.items():
            p.copy_(w[k])


class Capture:
    """What the program's first steps did, read around each step call: the
    GAN draws of every step; for the first ``least`` steps the losses, the
    LR batch and every network's gradient as Adam took it, (m_k −
    b1·m_{k−1}) / (1 − b1), and the params after them; and for each
    member's first GAN update, its params and the discriminator's before
    the step, the LR batch and its gradient (``gan``). It ends once
    ``reference.train.enough`` holds, and at the first epoch's end at the
    latest; then it moves what it holds to the host and ``undo`` takes the
    observer off the program."""

    def __init__(self, least: int, b1: float, gan: bool):
        self.least, self.b1, self.gan_draws = least, b1, gan
        self.losses, self.lr, self.masks, self.grads, self.gan = [], [], [], [], []
        self.totals = []  # (edge mean, std, Σe, count) of each compared step's loss
        self.params = None
        self.done = False
        self.undo = lambda: None
        self._mu = self._before = None

    def _grad(self, mu_after, mu_before):
        return [(m - self.b1 * q) / (1 - self.b1) for m, q in zip(mu_after, mu_before)]

    def before(self, nets, mask):
        """Before a step with GAN draws ``mask``: hold the state of each
        member that draws its first GAN update, and the discriminator's."""
        if self.done:
            return
        seen = np.sum(self.masks, axis=0) if self.masks else np.zeros(len(mask))
        first = [int(i) for i in np.flatnonzero(mask) if not seen[i]]
        if first:
            clone = lambda ts: [t.detach().clone() for t in ts]  # noqa: E731
            self._before = ([(i, clone(nets[i].params), clone(nets[i].mu)) for i in first],
                            clone(nets[-1].params))

    def on_step(self, nets, lr_imgs, mask, packed, n_members):
        if self.done:
            return
        k = len(self.masks)
        self.masks.append(np.asarray(mask, np.float32).copy())
        if k < self.least:
            flat = packed.reshape(-1)
            self.losses.append(flat[:n_members] if len(nets) == n_members
                               else torch.cat([flat[:n_members], flat[-1:]]))
            self.lr.append(lr_imgs.detach().clone())
            mu = [[m.detach().clone() for m in st.mu] for st in nets]
            prev = self._mu or [[torch.zeros_like(m) for m in ms] for ms in mu]
            self.grads.append([self._grad(ms, qs) for ms, qs in zip(mu, prev)])
            self._mu = mu
            if k == self.least - 1:
                self.params = [[p.detach().clone() for p in st.params] for st in nets]
                self._mu = None
        if self._before is not None:
            members, d_params = self._before
            for i, params, mu_before in members:
                self.gan.append(dict(step=k, member=i, params=params, d_params=d_params,
                                     lr=lr_imgs.detach().clone(),
                                     grad=self._grad(nets[i].mu, mu_before)))
            self._before = None
        if ref_train.enough(self.masks, self.least, self.gan_draws):
            self.close()

    def close(self):
        if self.done:
            return
        host = lambda ts: [t.cpu() for t in ts]  # noqa: E731
        self.losses, self.lr = host(self.losses), host(self.lr)
        self.grads = [[host(g) for g in step] for step in self.grads]
        self.params = [host(ps) for ps in self.params]
        self.totals = host(self.totals)
        for g in self.gan:
            g.update(params=host(g["params"]), d_params=host(g["d_params"]), lr=g["lr"].cpu(),
                     grad=host(g["grad"]))
        self._mu = self._before = None
        self.done = True
        self.undo()


def _wrap_steps(trainer, cap: Capture, n: int) -> None:
    """Observe the step calls of the trainer's executor until ``cap`` has
    closed; sets ``cap.undo``."""
    from srgan_tpu_torch.training import loop

    if trainer.spool is None:
        orig = loop.generator_pixel_step

        def pixel(g_state, hr, lr_imgs, lr, *a, **k):
            out = orig(g_state, hr, lr_imgs, lr, *a, **k)
            cap.on_step([out[0]], lr_imgs, np.zeros(1), out[1]["packed"], 1)
            return out

        loop.generator_pixel_step = pixel
        cap.undo = lambda: setattr(loop, "generator_pixel_step", orig)
        return
    orig_steps = trainer.pool_steps
    step, gan_step = orig_steps

    def pool(states, hr, lr_imgs, lr, *a, **k):
        out = step(states, hr, lr_imgs, lr, *a, **k)
        cap.on_step(out[0], lr_imgs, np.zeros(n), out[1]["packed"], n)
        return out

    def pool_gan(states, d_state, hr, lr_imgs, gan_mask, *a, **k):
        cap.before([*states, d_state], gan_mask)
        out = gan_step(states, d_state, hr, lr_imgs, gan_mask, *a, **k)
        cap.on_step([*out[0], out[1]], lr_imgs, gan_mask, out[2]["packed"], n)
        return out

    trainer.pool_steps = (pool, pool_gan)
    cap.undo = lambda: setattr(trainer, "pool_steps", orig_steps)


def _watch_totals(cap: Capture) -> None:
    """Record the statistics K1 and K2 hand the loss of each of the first
    ``cap.least`` steps (``recon_loss_kernel``'s stats vector: edge mean,
    std, Σe, TV mean, count; the TV mean is left out, it is the step's
    own); chains onto ``cap.undo``."""
    from srgan_tpu_torch.ops.cuda import recon_loss_kernel

    orig = recon_loss_kernel.loss_sums

    def loss_sums(hr, sr, stats, group=None):
        out = orig(hr, sr, stats, group)
        if len(cap.totals) < cap.least:
            cap.totals.append(stats.detach()[[0, 1, 2, 4]].clone())
        return out

    recon_loss_kernel.loss_sums = loss_sums
    undo = cap.undo

    def undo_both():
        undo()
        recon_loss_kernel.loss_sums = orig

    cap.undo = undo_both


class _OpensAt:
    """A training pipeline whose epoch ``epoch`` calls ``open`` just before
    it hands out batch ``k``."""

    def __init__(self, pipeline, epoch: int, k: int, open_):
        self._pipeline, self._epoch, self._k, self._open = pipeline, epoch, k, open_

    def __getattr__(self, name):
        return getattr(self._pipeline, name)

    def epoch(self, epoch, gen):
        for i, pair in enumerate(self._pipeline.epoch(epoch, gen)):
            if epoch == self._epoch and i == self._k:
                self._open()
            yield pair


class Window:
    def __init__(self, seconds: float, tracer, device, region):
        self.seconds, self.tracer = seconds, tracer
        self.region = region("window")
        self.cuda = device.type == "cuda"
        self.t0 = self.t1 = None
        self.epoch_s = 0.0
        self.steps = self.scores = self.gan0 = 0
        self.timer = None

    def open(self):
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if self.tracer is not None:
            self.tracer.start()
        self.region.__enter__()
        self.t0 = time.perf_counter()
        pid = os.getpid()
        self.timer = threading.Timer(self.seconds, lambda: os.kill(pid, signal.SIGTERM))
        self.timer.start()

    def close(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.region.__exit__(None, None, None)
        if self.timer is not None:
            self.timer.cancel()
            self.timer.join()
        if self.tracer is not None:
            self.tracer.stop()


def train_work(config: dict, steps: int, score_batches: int, window_gan: int) -> work.Work:
    """The work of a rank's window: ``steps`` training steps of its batch,
    ``score_batches`` scoring forwards, and in a pool with a discriminator
    its passes, ``window_gan`` GAN updates among them."""
    m_cfg, d_cfg = config["model"], config.get("discriminator")
    hr_hw = tuple(config["data"]["hr_size"])
    batch = config["data"]["batch_size"]
    factor = m_cfg["upscale_factor"]
    n_gen = config.get("pool", {}).get("num_generators", 1)
    gen = arch.load(m_cfg)
    w = work.Work(m_cfg["compute_dtype"])
    lr_hw = (hr_hw[0] // factor, hr_hw[1] // factor)
    w.add(gen.train_ops(m_cfg, lr_hw), batch, steps * n_gen)
    w.add(gen.forward_ops(m_cfg, lr_hw), batch, score_batches)
    if config["train"].get("use_gan"):
        # D(hr) and D(sr) of every member and of the D step's input
        w.add(work.discriminator_passes(d_cfg, hr_hw, ("fwd",)), batch, steps * (n_gen + 2))
        w.add(work.discriminator_passes(d_cfg, hr_hw, ("dgrad",), False), batch, window_gan)
        w.add(work.discriminator_passes(d_cfg, hr_hw, ("wgrad", "dgrad")), batch, 2 * steps)
    return w


def _gathered(group, cap) -> float:
    """Over the ranks: each compared step's LR batch joined in rank order
    into ``cap.lr``; returns ``ranks_gap``, the largest |gap| between rank
    0's params after the compared steps and any other rank's."""
    cap.lr = [torch.cat(group.gather(lr)) for lr in cap.lr]
    flat = torch.cat([p.reshape(-1) for net in cap.params for p in net])
    each = group.gather(flat)
    return max(float((p - each[0]).abs().max()) for p in each[1:])


def run(ctx) -> dict:
    config, traffic, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    group = ctx.group
    world = 1 if group is None else group.world
    m_cfg, d_cfg = config["model"], config.get("discriminator")
    gen = arch.load(m_cfg)
    hr_hw = tuple(config["data"]["hr_size"])
    batch = config["data"]["batch_size"]
    n_gen = config.get("pool", {}).get("num_generators", 1)
    use_gan = bool(config["train"].get("use_gan"))
    results = tempfile.mkdtemp(prefix="h100bench-")
    marks = [("start", time.perf_counter())]
    try:
        from srgan_tpu_torch.data.dataset import ArrayDataset
        from srgan_tpu_torch.training.loop import Trainer

        cfg = port_config(config, seed, results, multihost=group is not None)
        n_train, n_val = traffic["train_images"], traffic["val_images"]
        clips = inputs.clips_u8(n_train + n_val, hr_hw, inputs.seed_for(seed, 1), dev)
        clips_host = clips.cpu().numpy()
        del clips
        marks.append(("clips", time.perf_counter()))
        train_ds = ArrayDataset(clips_host[:n_train])
        val_ds = ArrayDataset(clips_host[n_train:])

        trainer = Trainer(cfg, device=dev)
        marks.append(("Trainer()", time.perf_counter()))
        g_shapes = gen.param_shapes(m_cfg)
        w0 = [inputs.weights(g_shapes, inputs.seed_for(seed, 2, i), dev, gen.param_scale)
              for i in range(n_gen)]
        for member, w in zip(trainer.pool.members, w0):
            _load(member.state.model, w)
        d0 = None
        if use_gan:
            d0 = inputs.weights(ref_model.discriminator_param_shapes(d_cfg),
                                inputs.seed_for(seed, 3), dev)
            _load(trainer.d_state.model, d0)
        for hook in ctx.faults:
            hook(trainer)

        marks.append(("weights", time.perf_counter()))
        cap = Capture(CHECKED_STEPS, config["train"]["adam_b1"], use_gan)
        _wrap_steps(trainer, cap, n_gen)
        if group is not None:
            _watch_totals(cap)
        mutual = {}
        if trainer.spool is not None:
            end_epoch = trainer.spool.end_epoch

            def observed_end_epoch():
                first = not mutual
                if first:
                    mutual["pre"] = [[p.detach().clone() for p in st.params]
                                     for st in trainer.spool.state]
                    mutual["loss"] = trainer.spool.running_loss.copy()
                end_epoch()
                if first:
                    mutual["post"] = [[p.detach().clone() for p in st.params]
                                      for st in trainer.spool.state]

            trainer.spool.end_epoch = observed_end_epoch

        tracer = ctx.new_tracer()
        win = Window(ctx.seconds, tracer, dev, ctx.region)
        warm = traffic["warm_epochs"]
        opens_at = traffic.get("window_opens_at_batch", 0)
        train_epoch, compute_score = trainer.train_epoch, trainer.compute_score

        def gan_updates():
            return 0 if trainer.spool is None else int(np.sum(trainer.spool.gan_updates))

        def open_window():
            win.open()
            win.gan0 = gan_updates()

        def timed_epoch(pipeline, epoch):
            first = epoch == warm and win.t0 is None
            regions = ExitStack()
            if first and opens_at:
                def open_in_epoch():
                    open_window()
                    regions.enter_context(ctx.region("train_epoch"))

                pipeline = _OpensAt(pipeline, epoch, opens_at, open_in_epoch)
            elif first:
                open_window()
            if win.t0 is not None:
                regions.enter_context(ctx.region("train_epoch"))
            t = time.perf_counter()
            with regions:
                out = train_epoch(pipeline, epoch)
            if win.t0 is not None:
                win.epoch_s += time.perf_counter() - max(t, win.t0)
                win.steps += out["n_batches"] - (opens_at if first else 0)
            if epoch == 0:
                cap.close()
            return out

        def counted_score(val_pipeline, epoch):
            if win.t0 is not None:
                win.scores += 1
            return compute_score(val_pipeline, epoch)

        trainer.train_epoch, trainer.compute_score = timed_epoch, counted_score
        trainer.train(train_ds, val_ds)
        win.close()
        if win.t0 is None:
            raise RuntimeError(f"train ended before epoch {warm}: no window")
        marks.append(("warm epochs", win.t0))
        compare.NOTES.append("set-up: " + ", ".join(
            f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in enumerate(marks[1:])))
        peak = torch.cuda.max_memory_allocated() if win.cuda else 0
        if group is not None:
            peak = int(max(group.gather(torch.tensor([peak], dtype=torch.float64))))
        window_s = win.t1 - win.t0
        steps, window_gan = win.steps, gan_updates() - win.gan0
        score_batches = min(n_val // world // batch, cfg.train.score_max_batches) * win.scores
        w = train_work(config, steps, score_batches, window_gan)
        result = {
            "attempted": steps, "failed": 0, "peak_bytes": peak,
            "t_window": win.t0,
            "e2e": {"train_img_s": steps * batch * world / window_s,
                    "peak_mem_gib": peak / 2**30},
            "run": dict(kind="train", window_s=window_s, steps=steps,
                        train_epoch_s=win.epoch_s, work=w.as_dict(),
                        loss_shape=(batch, *hr_hw, m_cfg["in_channels"]),
                        idle_label="epoch_end", dtype=m_cfg["compute_dtype"]),
            "tracer": tracer,
        }
        del trainer
        torch.cuda.empty_cache()
        ranks_gap = None if group is None else _gathered(group, cap)
        if group is not None and group.rank != 0:
            result["checks"] = {}
            return result

        # the reference, from the same weights, rows and draws
        t_ref = time.perf_counter()
        steps = set(range(len(cap.losses))) | {g["step"] for g in cap.gan}
        batches = first_epoch_batches(config, clips_host[:n_train], seed, dev, steps, world)
        result["checks"] = check_steps(config, cap, w0, d0, batches, seed, world)
        if ranks_gap is not None:
            result["checks"]["ranks_gap"] = ranks_gap
        if mutual:
            result["checks"]["mutual_gap"] = compare.mutual_gap(
                mutual, config["pool"]["mutual_alpha"])
        compare.NOTES.append(f"reference: {time.perf_counter() - t_ref:.3f} s")
        return result
    finally:
        shutil.rmtree(results, ignore_errors=True)


def first_epoch_batches(config, clips, seed, device, steps, world: int = 1) -> dict:
    """{k: (HR, LR)} of the first epoch's global batches ``steps`` over
    ``world`` ranks, worked out from the clips and the seed
    (``reference.data``)."""
    batch = config["data"]["batch_size"]
    rows = ref_data.train_rows(len(clips), config["data"]["split_ratio"],
                               config["data"]["split_seed"], seed, 0)
    degr = ref_data.Degrader(device, seed, 0, config["model"]["upscale_factor"],
                             config["data"]["noise_std_max"])
    out = {}
    for k in range(max(steps) + 1):
        pair = degr(torch.from_numpy(clips[ref_data.batch_rows(rows, batch, k, world)]))
        if k in steps:
            out[k] = pair
    return out


def check_steps(config, cap, w0, d0, batches, seed, world: int = 1) -> dict:
    """The numbers compared: the program's first steps against the
    reference's from the same weights, and each member's first GAN update
    against the reference's from the program's params before it.
    ``batches``: {step: (HR, LR)}, global batches of ``world`` ranks. The
    program's gradients are its Adam state's (``Capture``); its params are
    in the order of the port's ``named_parameters``, which ``_load`` held
    to the same names."""
    n_gen, n_steps = len(w0), len(cap.losses)
    members = [ref_train.trainable(w) for w in w0]
    d = ref_train.trainable(d0) if d0 is not None else None
    members, d, rec = ref_train.run_steps(config, members, d,
                                          [batches[k] for k in range(n_steps)], seed,
                                          shards=world)
    ref_nets = members + ([d] if d is not None else [])
    init_nets = list(w0) + ([d0] if d0 is not None else [])
    names = [list(w.keys()) for w in init_nets]
    prog_grads = [[dict(zip(nm, gs)) for nm, gs in zip(names, step)] for step in cap.grads]
    prog_delta = [dict(zip(nm, (p.to(init[k].device) - init[k] for k, p in zip(nm, ps))))
                  for nm, ps, init in zip(names, cap.params, init_nets)]
    ref_delta = [{k: net[k].detach() - init[k] for k in nm}
                 for nm, net, init in zip(names, ref_nets, init_nets)]
    prog_loss = [l.tolist() for l in cap.losses]
    first, ref_first = prog_grads[0], rec.first_grads
    lr_pairs = list(zip(cap.lr, rec.lr_batches, strict=True))

    def pixel(k):
        return [i for i in range(n_gen) if not cap.masks[k][i]]

    lr_pairs += [(g["lr"], batches[g["step"]][1]) for g in cap.gan]
    out = {
        "lr_gap": max(float((a.to(b.device) - b).abs().max()) for a, b in lr_pairs),
        "loss_gap": compare.loss_gap([p[:n_gen] for p in prog_loss],
                                     [r[:n_gen] for r in rec.losses]),
        "grad_gap": compare.worst_leaf(first[:n_gen], ref_first[:n_gen], ref_first[:n_gen],
                                       "grad"),
        # the pixel updates' gradients; a GAN update's goes to gan_grad_dist
        "grad_dist": max(compare.worst_leaf(*([net[i] for i in pixel(k)] for net in (p, r, r)),
                                            f"step {k} grad", dist=True)
                         for k, (p, r) in enumerate(zip(prog_grads, rec.grads, strict=True))),
        "update_gap": compare.worst_leaf(prog_delta, ref_delta, ref_first, "update"),
    }
    compare.NOTES.append(f"losses: program {prog_loss} reference {rec.losses}")
    if world > 1:
        # K1/K2's statistics of rank 0's loss against the global batch's
        gaps = [float(((p.double().to(r.device) - r).abs() / r.abs()).max())
                for p, r in zip(cap.totals, (L.edge_totals(batches[k][0])
                                              for k in range(len(cap.totals))))]
        out["totals_gap"] = max(gaps, default=None)
    if config["train"].get("use_gan"):
        out["d_grad_gap"] = compare.worst_leaf(first[n_gen:], ref_first[n_gen:],
                                               ref_first[n_gen:], "D grad")
        out["d_grad_dist"] = compare.worst_leaf(first[n_gen:], ref_first[n_gen:],
                                                ref_first[n_gen:], "D grad", dist=True)
        dev = w0[0][names[0][0]].device
        gan_dists = []
        for g in cap.gan:
            hr, lr = batches[g["step"]]
            params = ref_train.trainable({k: v.to(dev) for k, v in zip(names[0], g["params"])})
            d_params = ref_train.trainable({k: v.to(dev) for k, v in zip(names[-1], g["d_params"])})
            ref = ref_train.gan_grad(config, params, d_params, hr, lr)
            gan_dists.append(compare.worst_leaf(
                [dict(zip(names[0], g["grad"]))], [ref], [ref],
                f"GAN update, step {g['step']} member {g['member']}, grad", dist=True))
        out["gan_grad_dist"] = max(gan_dists, default=0.0)
        want = list(itertools.islice(ref_train.gan_draws(config, n_gen, seed), len(cap.masks)))
        compare.NOTES.append(f"masks: program {[m.tolist() for m in cap.masks]}")
        out["mask_diff"] = float(sum(int((a != b).sum())
                                     for a, b in zip(cap.masks, want, strict=True)))
        out["gan_unchecked"] = float(n_gen - len({g["member"] for g in cap.gan}))
    return out
