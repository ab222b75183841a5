"""SwinIR on the port (``models/swinir.py``) against the plain fp32 reference
(``tests/swinir_reference.py``) on the CPU, on seeded random weights, at a
small size with the full structure: embed 36, 2 residual groups of 2 Swin
layers (plain, then shifted), 3 heads of 12 (no multiple of 8), window 4
with shift 2, x4, LR 12x20 (reflect-padded to 12x20's windows: 12x20 is
tiled, 13x21 is not) and 16x16.

Bars, each with its reason:
  - the fp32 output: rel 1e-5 of max|y|: the same operations in another
    order (a Linear on the tokens, not on the windows; the windows cut by
    views), fp32 rounding alone;
  - every parameter's gradient through the reconstruction loss: rel 1e-4
    of the leaf's norm: summed over 4 layers' backward in another order;
  - the bf16 forward: within 4x the error of the fp32 model whose every
    weight and input is rounded to bf16 once (what rounding the operands
    alone costs); the bf16 model rounds at every Linear, conv, LayerNorm
    and attention output besides, a few roundings in series a layer.

Also the normal path (``cli train --arch swinir`` → snapshot →
``Upscaler.from_checkpoint(...).upscale_u8``), the options refused by
name, a pool of 2 with GAN through the scan executor, planted faults (no
shift, no bias, no mask, the wrong scale) that the comparison must catch,
and SRResNet built bit for bit as before when ``generator`` is left out.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import swinir_reference as ref
from srgan_tpu_torch import cli
from srgan_tpu_torch.config import (
    Config,
    DataConfig,
    DiscriminatorConfig,
    ModelConfig,
    PoolConfig,
    TrainConfig,
)
from srgan_tpu_torch.models import init_generator, swinir
from srgan_tpu_torch.models.srresnet import SRResNet
from srgan_tpu_torch.models.srresnet import init_generator as init_srresnet
from srgan_tpu_torch.ops import window_attention as wa
from srgan_tpu_torch.ops.recon_loss import reconstruction_loss

torch.set_num_threads(1)

SMALL = dict(generator="swinir", embed_dim=36, depths=(2, 2), num_heads=(3, 3), window_size=4,
             num_features=16)
SIZES = [(12, 20), (16, 16), (13, 21)]


def _model(dtype="float32", seed=0):
    """The small SwinIR with every parameter drawn at a live scale: Linear
    and conv weights N(0, 1/fan_in), the bias tables N(0, 0.5²) (the
    official init's 0.02 would leave the bias, the mask's effect and the
    shift nearly invisible), norms N(1, 0.05²) and N(0, 0.05²)."""
    model = init_generator(ModelConfig(**SMALL, compute_dtype=dtype), seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if name.endswith("relative_position_bias_table"):
                p.copy_(0.5 * noise)
            elif "norm" in name.split(".")[-2]:
                p.copy_((1.0 if name.endswith("weight") else 0.0) + 0.05 * noise)
            elif p.dim() > 1:
                p.copy_(noise / p[0].numel() ** 0.5)
            else:
                p.copy_(0.01 * noise)
    return model


def _params(model):
    return {k: v.detach().clone().float().requires_grad_() for k, v in model.named_parameters()}


def _lr(hw, seed=0, n=2):
    return torch.rand(n, *hw, 3, generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


M = dataclasses.asdict(ModelConfig(**SMALL))


@pytest.mark.parametrize("hw", SIZES, ids=["x".join(map(str, s)) for s in SIZES])
def test_fp32_forward_matches_reference(hw):
    model = _model()
    x = _lr(hw)
    with torch.no_grad():
        got = model(x)
        want = ref.forward(_params(model), x, M)
    assert got.shape == want.shape == (2, hw[0] * 4, hw[1] * 4, 3)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("hw", SIZES[:2], ids=["x".join(map(str, s)) for s in SIZES[:2]])
def test_fp32_gradients_through_the_loss_match_reference(hw):
    model = _model()
    x = _lr(hw)
    hr = torch.rand(2, hw[0] * 4, hw[1] * 4, 3, generator=torch.Generator().manual_seed(9))
    sum(reconstruction_loss(hr, model(x))).backward()
    p = _params(model)
    sum(reconstruction_loss(hr, ref.forward(p, x, M))).backward()
    for name, param in model.named_parameters():
        want = p[name].grad
        assert float((param.grad - want).norm()) <= 1e-4 * float(want.norm()), name


def test_bf16_forward_within_bf16s_own_error():
    model32, model16 = _model(), _model("bfloat16")
    x = _lr((16, 16))
    with torch.no_grad():
        want = model32(x)
        got = model16(x)
        rounded = {k: v.to(torch.bfloat16).float() for k, v in _params(model32).items()}
        own = _rel(ref.forward(rounded, x.to(torch.bfloat16).float(), M), want)
    assert got.dtype == torch.float32
    assert 0 < _rel(got, want) <= 4 * own, (_rel(got, want), own)


def test_window_attention_plain_route_is_the_reference_attention():
    """The op's plain route (rolled, partitioned and masked by views and the
    shift mask, on the qkv Linear's output in token order) equals the
    reference's official-order attention (rolled, partitioned, the Linear
    on the windows), output and gradients."""
    g = torch.Generator().manual_seed(3)
    b, h, w, heads, hd, ws, shift = 2, 8, 12, 3, 12, 4, 2
    c = heads * hd
    x = torch.randn(b, h * w, c, generator=g, requires_grad=True)
    table = torch.randn((2 * ws - 1) ** 2, heads, generator=g, requires_grad=True)
    p = {"q.qkv.weight": torch.randn(3 * c, c, generator=g) / c ** 0.5,
         "q.qkv.bias": torch.randn(3 * c, generator=g) * 0.1,
         "q.proj.weight": torch.eye(c), "q.proj.bias": torch.zeros(c),
         "q.relative_position_bias_table": table}
    bias = table[ref.relative_position_index(ws).view(-1)].view(ws * ws, ws * ws, heads)
    qkv = torch.nn.functional.linear(x, p["q.qkv.weight"], p["q.qkv.bias"])
    wa.reset_paths()
    got = wa.window_attention(qkv, bias.permute(2, 0, 1).contiguous(), heads, ws, shift,
                              (b, h, w))
    assert wa.paths == {"cuda": 0, "cpu": 1}
    rolled = torch.roll(x.view(b, h, w, c), (-shift, -shift), (1, 2))
    win = ref.window_partition(rolled, ws).view(-1, ws * ws, c)
    out = ref.attention(p, "q", win, heads, ws, ref.calculate_mask(h, w, ws, shift))
    want = torch.roll(ref.window_reverse(out.view(-1, ws, ws, c), ws, h, w), (shift, shift),
                      (1, 2)).reshape(b, h * w, c)
    assert _rel(got, want) <= 1e-6
    g1 = torch.autograd.grad(got.square().sum(), [x, table])
    g2 = torch.autograd.grad(want.square().sum(), [x, table])
    for a, e in zip(g1, g2):
        assert _rel(a, e) <= 1e-5


FAULTS = ["no_shift", "no_bias", "no_mask", "wrong_scale"]


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_comparison(fault, monkeypatch):
    """Each fault, planted in the port's attention, moves the output far
    beyond the comparison's 1e-5."""
    orig = swinir.window_attention

    def planted(qkv, bias, heads, window, shift, grid):
        if fault == "no_shift":
            shift = 0
        elif fault == "no_bias":
            bias = torch.zeros_like(bias)
        elif fault == "wrong_scale":  # q scaled twice: the scale squared
            c = qkv.shape[-1] // 3
            qkv = torch.cat([qkv[..., :c] * (c // heads) ** -0.5, qkv[..., c:]], -1)
        return orig(qkv, bias, heads, window, shift, grid)

    monkeypatch.setattr(swinir, "window_attention", planted)
    if fault == "no_mask":
        monkeypatch.setattr(wa, "shift_mask", lambda h, w, ws, s: torch.zeros(
            (h // ws) * (w // ws), ws * ws, ws * ws))
    model = _model()
    x = _lr((16, 16))
    with torch.no_grad():
        gap = _rel(model(x), ref.forward(_params(model), x, M))
    assert gap > 1e-3, gap


def test_srresnet_unchanged_without_arch():
    """``ModelConfig()`` builds the SRResNet it built before, weights bit
    for bit, through the architecture's dispatch."""
    cfg = ModelConfig(num_features=8, num_residuals=2)
    a, b = init_generator(cfg, seed=3), init_srresnet(cfg, seed=3)
    assert type(a) is SRResNet and cfg.generator == "srresnet"
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)


REFUSALS = {
    "remat": lambda tmp: swinir.SwinIR.from_config(ModelConfig(**SMALL, remat=True)),
    "head": lambda tmp: swinir.SwinIR.from_config(ModelConfig(**SMALL, head="reference")),
    "norm": lambda tmp: swinir.SwinIR.from_config(ModelConfig(**SMALL, norm="none")),
    "pool_exec_vmap": lambda tmp: _trainer(tmp, n=2, member_exec="vmap"),
    "w_sharded": lambda tmp: __import__(
        "srgan_tpu_torch.parallel.spatial", fromlist=["x"]).upscale_spatially_sharded(
            _model(), np.zeros((8, 8, 3), np.float32), device="cpu"),
    "s2d_trunk": lambda tmp: __import__(
        "srgan_tpu_torch.models.s2d_trunk", fromlist=["x"]).s2d_trunk(
            _model(), torch.zeros(1, 8, 8, 36)),
}
REFUSED_BY = {"remat": "remat", "head": "head=", "norm": "norm=",
              "pool_exec_vmap": "member_exec 'vmap'", "w_sharded": "W-sharded",
              "s2d_trunk": "s2d trunk"}


@pytest.mark.parametrize("option", list(REFUSALS))
def test_srresnet_options_are_refused_by_name(option, tmp_path):
    with pytest.raises((ValueError, TypeError), match=REFUSED_BY[option]):
        REFUSALS[option](tmp_path)


def _trainer(results, n=1, gan=False, **pool):
    from srgan_tpu_torch.training.loop import Trainer

    cfg = Config(
        model=ModelConfig(**SMALL),
        discriminator=DiscriminatorConfig(num_filters=8, num_stages=2),
        data=DataConfig(hr_size=(32, 64), upscale_factor=4, batch_size=2, noise_std_max=0.0,
                        num_workers=1),
        pool=PoolConfig(num_generators=n, **pool),
        train=TrainConfig(num_epochs=1, score_max_batches=1, progress="off", use_gan=gan,
                          results_dir=str(results), validate_every=0),
    )
    return Trainer(cfg, device="cpu")


def _folder(path, n, seed, hw=(32, 64)):
    os.makedirs(path)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
            os.path.join(path, f"img_{i:02d}.png"))
    return str(path)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return _folder(root / "train", 10, 0), _folder(root / "val", 4, 1)


def test_pool_of_two_with_gan_runs_on_the_scan_executor(tmp_path, folders):
    """The scan executor's member loop calls each member's module as it
    is: two SwinIRs and the patch discriminator train, GAN updates among
    their steps (``p_gan_above=1``: every draw after the gate's first two
    batches)."""
    trainer = _trainer(tmp_path, n=2, gan=True, p_gan_above=1.0)
    before = [p.detach().clone() for p in trainer.pool.members[1].state.params]
    trainer.train(*folders)
    assert trainer.spool is not None and trainer.d_state is not None
    assert all(isinstance(st.model, swinir.SwinIR) for st in trainer.spool.state)
    assert int(np.sum(trainer.spool.gan_updates)) >= 2
    assert np.isfinite(trainer.history["psnr"][-1])
    after = [p.detach() for p in trainer.pool.members[1].state.params]
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_cli_train_snapshot_then_upscale_u8_equals_reference(tmp_path, folders):
    """The normal path: ``cli train --arch swinir`` for 2 epochs writes a
    snapshot whose sidecar names the architecture; ``Upscaler``
    rebuilds SwinIR from it, and ``upscale_u8`` of a 13x21 image (no
    multiple of the window) equals the reference's output quantised the
    same way, pixel for pixel up to one level where the fp32 values sit
    on a rounding edge."""
    from srgan_tpu_torch.eval.inference import Upscaler
    from srgan_tpu_torch.training import checkpoint as ckpt

    results = tmp_path / "results"
    cli.main(["train", "--arch", "swinir", "--embed-dim", "36", "--depths", "2,2",
              "--heads", "3,3", "--window", "4", "--num-features", "16",
              "--train-dir", folders[0], "--val-dir", folders[1], "--epochs", "2",
              "--batch-size", "2", "--hr-height", "32", "--hr-width", "64",
              "--validate-every", "0", "--results-dir", str(results), "--progress", "off",
              "--device", "cpu"])
    saved = ckpt.load_model_config(str(results), "Training")
    assert saved == ModelConfig(**SMALL)
    assert json.loads((results / "Training_model.json").read_text())["generator"] == "swinir"
    up = Upscaler.from_checkpoint(str(results), "Training", device="cpu")
    assert isinstance(up.model, swinir.SwinIR)
    img = np.random.default_rng(5).integers(0, 256, (13, 21, 3), dtype=np.uint8)
    got = up.upscale_u8(img)
    x = torch.from_numpy(img).float()[None] / 255.0
    with torch.no_grad():
        want = ref.forward(_params(up.model), x, M)[0]
    want = (want.clamp(0, 1) * 255).round().to(torch.uint8).numpy()
    assert got.shape == (52, 84, 3)
    assert int(np.abs(got.astype(int) - want).max()) <= 1
    assert float(np.mean(got != want)) < 1e-3


def test_upscale_cli_builds_swinir_without_a_checkpoint(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (9, 10, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "in.png")
    cli.main(["upscale", str(tmp_path / "in.png"), str(tmp_path / "out.png"),
              "--results-dir", str(tmp_path / "none"), "--device", "cpu",
              "--arch", "swinir", "--embed-dim", "12", "--depths", "2", "--heads", "2",
              "--window", "4"])
    assert Image.open(tmp_path / "out.png").size == (40, 36)


def test_swin_group_spans_and_pad_px(tmp_path):
    """``model.swin_group`` covers each residual group with its index,
    tokens, windows and shifted layers; ``serve.forward`` carries the
    reflect-padded pixels of the request."""
    from srgan_tpu_torch.eval.inference import Upscaler
    from srgan_tpu_torch.utils import profiling

    up = Upscaler(_model(), device="cpu")
    img = np.zeros((13, 21, 3), np.uint8)
    with profiling.trace(str(tmp_path)):
        up.upscale_u8(img)
    spans = profiling.spans()
    groups = [s for s in spans if s.name == "model.swin_group"]
    assert [s.attrs["group"] for s in groups] == [0, 1]
    assert all(s.attrs["tokens"] == 16 * 24 and s.attrs["windows"] == 24
               and s.attrs["shifted"] == [1] for s in groups)
    (fwd,) = [s for s in spans if s.name == "serve.forward"]
    assert fwd.attrs["pad_px"] == 16 * 24 - 13 * 21
