"""Whole runs of each cell at small sizes on the CPU (``small.py``): the
port against the plain reference, and the runs and controls that have to
come out not correct.

The look for a card is skipped (the CPU is passed in); the limits are the
cells' own. ``cuda``-marked tests run the same on the card.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from h100bench import control, run
from h100bench.tests import small

CPU = torch.device("cpu")
CELLS = ("sr4-train-pixel", "sr4pool3-train-gan", "sr4-serve-photos")


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


@pytest.mark.parametrize("cell", CELLS[:2])
@pytest.mark.parametrize("variant", ["fp8", "half_batch", "unchanged"])
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
