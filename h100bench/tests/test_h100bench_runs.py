"""Whole runs of each cell at small sizes on the CPU (``small.py``): the
port against the plain reference, and the runs and controls that have to
come out not correct.

The look for a card is skipped (the CPU is passed in); the limits are the
cells' own. ``cuda``-marked tests run the same on the card.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench import arch, control, ranks, run
from h100bench.tests import small

CPU = torch.device("cpu")
CELLS = ("sr4-train-pixel", "sr4pool3-train-gan", "sr4-serve-photos")
DDP = "sr4-train-pixel-ddp4"
HERE = Path(__file__).resolve().parent


def _run(cell, faults=(), seed=11, device=CPU):
    return run.execute(small.args(cell, seed=seed, seconds=0.5), device=device,
                       faults=faults, overrides=small.overrides(cell))


def _spec(cell):
    spec = run.load_cell(cell)
    ov = small.overrides(cell)
    run._merge(spec.config, ov["config"])
    run._merge(spec.traffic, ov["traffic"])
    spec.overrides = ov
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference(cell):
    out = _run(cell, seed=2**31 + 3)
    assert out["correct"], out["checks"]
    for name, (val, lim) in out["checks"].items():
        assert val <= lim, name


def _unchanged(trainer):
    states = [m.state for m in trainer.pool.members]
    if trainer.d_state is not None:
        states.append(trainer.d_state)
    for st in states:
        st.apply_gradients = lambda grads, lr: None


def _ascent(trainer):
    """Every step climbs its gradient: the norms of a sound step, the
    opposite direction."""
    states = [m.state for m in trainer.pool.members]
    if trainer.d_state is not None:
        states.append(trainer.d_state)
    for st in states:
        st.apply_gradients = lambda grads, lr, step=st.apply_gradients: step(
            [-g for g in grads], lr)


def _half_batch(trainer):
    """The step sees the first half of every batch, its mean over that."""
    from srgan_tpu_torch.training import loop

    if trainer.spool is None:
        orig = loop.generator_pixel_step
        loop.generator_pixel_step = lambda s, hr, lr_imgs, *a, **k: orig(
            s, hr[: len(hr) // 2], lr_imgs[: len(hr) // 2], *a, **k)
        trainer._undo = lambda: setattr(loop, "generator_pixel_step", orig)
        return
    step, gan_step = trainer.pool_steps
    trainer.pool_steps = (
        lambda s, hr, lr_imgs, *a, **k: step(s, hr[: len(hr) // 2], lr_imgs[: len(hr) // 2], *a, **k),
        lambda s, d, hr, lr_imgs, *a, **k: gan_step(s, d, hr[: len(hr) // 2],
                                                    lr_imgs[: len(hr) // 2], *a, **k))
    trainer._undo = lambda: None


def _altered(up):
    serve = up.upscale_u8

    def altered(img):
        out = serve(img).copy()
        out[:8, :8] = 255 - out[:8, :8]
        return out

    up.upscale_u8 = altered


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "ascent"])
def test_broken_training_step_is_not_correct(cell, fault):
    from srgan_tpu_torch.training import loop

    orig = loop.generator_pixel_step
    hook = {"unchanged": _unchanged, "half_batch": _half_batch, "ascent": _ascent}[fault]
    try:
        out = _run(cell, faults=[hook])
    finally:
        loop.generator_pixel_step = orig
    assert not out["correct"], out["checks"]
    if fault == "ascent":  # only the distance sees direction
        val, lim = out["checks"]["grad_dist"]
        assert val > lim


def test_pool_checks_each_members_first_gan_update():
    from h100bench import compare

    compare.NOTES.clear()
    out = _run("sr4pool3-train-gan", seed=2**31 + 9)
    assert out["correct"], out["checks"]
    masks = json.loads(next(n for n in compare.NOTES if n.startswith("masks"))[len("masks: program "):])
    checked = [n for n in compare.NOTES if n.startswith("GAN update")]
    drew = np.flatnonzero(np.sum(masks, axis=0))
    per_epoch = int(small.overrides("sr4pool3-train-gan")["traffic"]["train_images"] * 0.7) // 4
    assert len(drew) >= 1 and len(checked) == len(drew)
    assert len(masks) == per_epoch or (len(drew) == 3 and len(masks) >= 3
                                       and not (np.sum(masks[:-1], axis=0) > 0).all())


def _noted(name):
    from h100bench import compare

    note = next(n for n in compare.NOTES if n.startswith(f"not compared {name}:"))
    return float(note.split(":")[1])


def test_dropped_adversarial_term_shows_in_fp32():
    """gan_grad_dist sees a GAN update handed no adversarial term where
    the program computes in fp32; in bf16 on the card rounding alone moves
    that gradient as far, so the number is noted and not compared."""
    from h100bench import compare

    spec = _spec("sr4pool3-train-gan")
    compare.NOTES.clear()
    _run("sr4pool3-train-gan", seed=2**31 + 9)
    sound = _noted("gan_grad_dist")
    compare.NOTES.clear()
    control.no_adversarial_readings(spec, 2**31 + 9, 0.5, CPU)
    assert _noted("gan_grad_dist") > 100 * sound


def test_altered_answer_is_not_correct():
    out = _run("sr4-serve-photos", faults=[_altered])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,variant", [
    *((c, v) for v in ("fp8", "half_batch", "unchanged") for c in CELLS[:2]), (DDP, "fp8"),
    (DDP, "half_batch")])
def test_training_controls_are_not_correct(cell, variant):
    spec = _spec(cell)
    checks = control.train_readings(spec, 5, variant, CPU)
    from h100bench import compare

    ok, judged = compare.judge(checks, spec.limits)
    assert not ok, judged


@pytest.mark.parametrize("variant", ["fp8", "altered"])
def test_serving_controls_are_not_correct(variant):
    spec = _spec("sr4-serve-photos")
    judged = control.serve_readings(spec, 5, variant, 0.5, CPU)
    assert any(v > lim for v, lim in judged.values()), judged


def test_control_rounds_to_float8():
    x = torch.linspace(-3, 3, 1001)
    q = control.fp8(x)
    assert q.abs().max() == pytest.approx(3.0)
    assert 0 < float((q - x).abs().max()) <= 3.0 * 2.0 ** -4
    assert len(np.unique(q.numpy())) < 256


def _left(argv: list) -> list:
    """The processes whose command line holds ``argv``."""
    want, found = "\0".join(argv), []
    for proc in Path("/proc").iterdir():
        try:
            if proc.name.isdigit() and want in (proc / "cmdline").read_text():
                found.append(proc.name)
        except OSError:  # ended while read
            pass
    return found


def _four_ranks(seed, fault=None, trace=0):
    argv = [str(HERE / "rank_worker.py"), DDP, str(seed), str(trace), *([fault] if fault else [])]
    with tempfile.TemporaryFile("w+") as out, tempfile.TemporaryFile("w+") as err:
        rc = ranks.launch(argv, 4, time.perf_counter(), 80.0, stdout=out, stderr=err)
        out.seek(0)
        err.seek(0)
        assert rc == 0, err.read()[-4000:]
        assert _left(argv) == [], "a rank outlived the launcher"
        return json.loads(out.read().strip().splitlines()[-1])


def test_four_ranks_match_the_sharded_reference():
    """``cli train --multihost`` on 4 gloo ranks against the reference that
    follows the global batch a rank's rows at a time: every rank ends the
    compared steps with the same params, and rank 0's loss used the global
    batch's statistics."""
    out = _four_ranks(2**31 + 3)
    assert out["correct"], out["checks"]
    assert out["checks"]["ranks_gap"] == [0.0, 0]
    assert out["checks"]["totals_gap"][0] < 1e-6
    assert out["metrics"]["train_img_s"]["value"] > 0


def test_four_ranks_traced_read_the_loop():
    """A traced run on 4 ranks: the loop's readers find rank 0's spans."""
    out = _four_ranks(2**31 + 5, trace=1)
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    # a drain a step; a window that opens mid-epoch also holds the lagged
    # drain of the batch before it (one more in the few steps here)
    assert 1.0 <= metrics["step.host_syncs"]["value"] <= 1.25
    assert metrics["loop.snapshot_share"]["value"] > 0.0
    ends = metrics["loop.score_share"]["value"] + metrics["loop.snapshot_share"]["value"]
    assert ends <= metrics["loop.epoch_end_share"]["value"]
    assert metrics["mfu.train"]["value"] > 0.0


@pytest.mark.parametrize("fault,check", [("skip_average", "ranks_gap"),
                                         ("local_totals", "totals_gap")])
def test_broken_ranks_are_not_correct(fault, check):
    out = _four_ranks(11, fault)
    assert not out["correct"], out["checks"]
    val, lim = out["checks"][check]
    assert val > lim


@pytest.fixture
def planted(monkeypatch):
    """The test-only architecture (``planted_arch.py``), loaded through
    ``arch.load``; the port's ``Trainer`` builds it in place of SRResNet."""
    from srgan_tpu_torch.training import loop

    monkeypatch.setattr(arch, "DIR", HERE)
    mod = arch.load({"arch": "planted_arch"})
    mod.CALLS.clear()
    monkeypatch.setattr(loop, "init_generator",
                        lambda cfg, seed=0, device=None: mod.port_model(cfg).to(device))
    yield mod
    mod.CALLS.clear()


def _planted_run(cell, out_scale=0.25):
    ov = small.overrides(cell)
    ov["config"]["model"].update(arch="planted_arch", planted_out_scale=out_scale)
    return run.execute(small.args(cell, seed=2**31 + 7, seconds=0.5),
                       device=CPU, overrides=ov)


@pytest.mark.parametrize("cell,calls", [
    ("sr4-train-pixel", {"param_shapes", "param_scale", "forward", "train_ops", "forward_ops"}),
    ("sr4-serve-photos", {"port_model", "param_shapes", "param_scale", "forward", "forward_ops"}),
])
def test_planted_architecture_runs_through_the_kinds(planted, cell, calls):
    out = _planted_run(cell)
    assert out["correct"], out["checks"]
    assert calls <= set(planted.CALLS), planted.CALLS


@pytest.mark.parametrize("cell", ["sr4-train-pixel", "sr4-serve-photos"])
def test_planted_reference_that_differs_is_not_correct(planted, cell):
    out = _planted_run(cell, out_scale=0.5)
    assert not out["correct"], out["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference_on_the_card(cell, card):
    out = _run(cell, device=card)
    assert out["correct"], out["checks"]
