"""CPU tests of the benchmark's yardstick: the work counts, the kernel
groups, the idle share, the p95, BENCHMARK.json's names and files, the
no-JAX check and the refusal to run without a card.

    python -m pytest h100bench/tests -q
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import arch, groups, inputs, run, work
from h100bench.kinds import serve, train
from h100bench.reference import model as ref_model
from h100bench.reference import train as ref_train
from h100bench.tests import small

ROOT = Path(__file__).resolve().parents[2]
PARENT = json.loads((Path(__file__).parent / "parent_values.json").read_text())
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

M_SMALL = {"in_channels": 3, "num_features": 8, "num_residuals": 2, "upscale_factor": 4,
           "group_norm_groups": 4, "group_norm_eps": 1e-6}
D_SMALL = {"in_channels": 3, "num_filters": 4, "num_stages": 2, "instance_norm_eps": 1e-6}


def _trainable(shapes, seed=0):
    return {k: v.requires_grad_() for k, v in inputs.weights(shapes, seed, "cpu").items()}


def test_generator_flops_match_counter():
    p = _trainable(ref_model.generator_param_shapes(M_SMALL))
    x = torch.rand(2, 6, 10, 3)
    with FlopCounterMode(display=False) as fc:
        ref_model.srresnet(p, x, M_SMALL).sum().backward()
    want = fc.get_flop_counts()["Global"]
    conv = want[torch.ops.aten.convolution] + want[torch.ops.aten.convolution_backward]
    w = work.Work("float32")
    w.add(work.generator_train(M_SMALL, (6, 10)), 2)
    assert w.flops == conv
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            ref_model.srresnet(p, x, M_SMALL)
    w = work.Work("float32")
    w.add(work.generator_forward(M_SMALL, (6, 10)), 2)
    assert w.flops == fc.get_total_flops()


@pytest.mark.parametrize("kinds,first", [(("fwd",), True), (("wgrad", "dgrad"), True),
                                         (("dgrad",), False)])
def test_discriminator_flops_match_counter(kinds, first):
    p = _trainable(ref_model.discriminator_param_shapes(D_SMALL))
    x = torch.rand(2, 40, 44, 3, requires_grad=not first)
    with FlopCounterMode(display=False) as fc:
        y = ref_model.discriminator(p, x, D_SMALL)
    fwd = fc.get_total_flops()
    w = work.Work("float32")
    w.add(work.discriminator_passes(D_SMALL, (40, 44), kinds, first), 2)
    if kinds == ("fwd",):
        assert w.flops == fwd
        return
    wanted = [x] if kinds == ("dgrad",) else list(p.values())
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(y.sum(), wanted)
    assert w.flops == fc.get_total_flops()


def test_conv_min_time_takes_the_larger_bound():
    c = work.Conv(64, 64, 3, 128, 256, 128, 256)
    w = work.Work("bfloat16")
    w.add([c], 24)
    flops_s = work.conv_flops(c, 24) / work.PEAK_FLOPS["bfloat16"]
    bytes_s = work.conv_bytes(c, 24, 2) / work.PEAK_BYTES_S
    assert w.as_dict()["conv_min_s"] == pytest.approx(max(flops_s, bytes_s))
    assert work.recon_loss_bytes(12, 512, 1024, 3)["K3"] / work.PEAK_BYTES_S * 1e3 == \
        pytest.approx(0.0676, abs=1e-4)  # PERF.md's K3 bound at (12, 512, 1024, 3)


@pytest.mark.parametrize("name,group", [
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true>", "copy"),
    ("void cudnn::ops::nhwcToNchwKernel<float, float, float, true, false>", "copy"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>", "groupnorm"),
    ("void grad_kernel<3>(float const*, float const*, float*)", "loss"),
    ("void partials_totals<2>(double const*, double*, int)", "loss"),
    ("void at::native::multi_tensor_apply_kernel<...>", "adam"),
    ("Memcpy DtoH (Device -> Pageable)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::Te", "copy"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIt", "copy"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
     "(anonymous namespace)::GroupNorm1dForward<float>", "groupnorm"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::"
     "CUDAFunctor_add<c10::BFloat16>>", "elementwise"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
])
def test_groups(name, group):
    assert groups.group_of(name) == group


def test_idle_share_never_negative_with_overlaps():
    rng = np.random.default_rng(0)
    for _ in range(50):
        starts = rng.uniform(0, 1, 40)
        ev = [("k", a, a + d) for a, d in zip(starts, rng.uniform(0, 0.3, 40))]
        busy = groups.busy_seconds(ev, 0.0, 1.0)
        assert 0.0 <= busy <= 1.0
        gaps = groups.idle_gaps(ev, 0.0, 1.0)
        assert sum(b - a for a, b in gaps) == pytest.approx(1.0 - busy)
    # two kernels over the same 0.5 s: busy 0.5, not 1.0 (the old 1 - sum/wall read 0)
    assert groups.busy_seconds([("a", 0.0, 0.5), ("b", 0.0, 0.5)], 0.0, 1.0) == 0.5


def test_p95_over_every_request():
    lat = [0.001 * (i + 1) for i in range(100)]
    assert serve.p95_ms(lat) == pytest.approx(float(np.percentile(np.arange(1, 101), 95)))
    # one slow request among many fast ones is in the tail of all requests
    lat = [0.01] * 94 + [1.0] * 6
    assert serve.p95_ms(lat) == pytest.approx(1000.0)


def test_benchmark_names_units_and_files():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "h100bench" / "metrics" / f"{m['name']}.py").exists() or \
            m in BENCH["end_to_end"]
    assert len({e["name"] for e in named}) == len(named)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        spec = run.load_cell(w["name"])
        assert (ROOT / "h100bench" / "kinds" / f"{spec.traffic['kind']}.py").exists()
        assert spec.e2e and spec.per_layer
        assert "setup_s" in [m["name"] for m in spec.e2e]
    for m in BENCH["per_layer"]:
        run.reader(m["name"])  # loads
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["srgan_tpu_torch", "srgan_tpu_torch.cli", "jaxtyping",
                                  "flaxen"]) == []
    assert run.forbidden_modules(["srgan_tpu.config", "jax._src", "torch"]) == ["jax", "srgan_tpu"]


def test_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import h100bench.run as r, h100bench.control, h100bench.kinds.train, "
            "h100bench.kinds.serve\n"
            "from srgan_tpu_torch.training import loop; from srgan_tpu_torch.eval import inference\n"
            "from srgan_tpu_torch import cli\n"
            "print(r.forbidden_modules())" % str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", ["sr4-train-pixel", "sr4-train-pixel-ddp4"])
def test_run_without_a_card_fails_and_prints_no_result(cell):
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload", cell,
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "memory_peak_bytes" not in out.stdout and "correct" not in out.stdout


def test_clips_same_cells_every_seed():
    a = inputs.clips_u8(8, (32, 64), 1, "cpu")
    b = inputs.clips_u8(8, (32, 64), 2, "cpu")
    assert a.shape == b.shape == (8, 32, 64, 3) and a.dtype == torch.uint8
    assert not torch.equal(a, b)
    assert torch.equal(a, inputs.clips_u8(8, (32, 64), 1, "cpu"))
    w = inputs.weights(ref_model.generator_param_shapes(M_SMALL), 3, "cpu")
    assert math.isclose(float(w["stem.weight"].std()), 1 / math.sqrt(3 * 81), rel_tol=0.2)


@pytest.mark.parametrize("masks,gan,want", [
    ([[0, 0, 0], [1, 1, 1]], True, False),  # fewer than three steps
    ([[0, 0, 0], [0, 1, 0], [1, 0, 0]], True, False),  # member 2 has drawn no GAN update
    ([[0, 0, 0], [0, 1, 0], [1, 0, 1]], True, True),
    ([[0], [0], [0]], False, True),
])
def test_enough_steps_compared(masks, gan, want):
    assert ref_train.enough([np.asarray(m, np.float32) for m in masks], 3, gan) is want


def _sha256(w) -> str:
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("key", sorted(PARENT))
def test_seam_gives_the_parents_numbers(key):
    """Through ``arch.load``, each cell's parameter shapes, weights and work
    equal what the harness gave before the seam (``parent_values.json``,
    recorded from the parent commit): at the tests' small sizes and at the
    cells' own."""
    cell, size = key.split("/")
    spec = run.load_cell(cell)
    if size == "small":
        ov = small.overrides(cell)
        run._merge(spec.config, ov["config"])
        run._merge(spec.traffic, ov["traffic"])
    config, want = spec.config, PARENT[key]
    m = config["model"]
    gen = arch.load(m)
    shapes = gen.param_shapes(m)
    assert [[k, list(s)] for k, s in shapes] == want["param_shapes"]
    w = inputs.weights(shapes, inputs.seed_for(11, 2, 0), "cpu", gen.param_scale)
    assert _sha256(w) == want["weights_sha256"]
    if "d_weights_sha256" in want:
        d = inputs.weights(ref_model.discriminator_param_shapes(config["discriminator"]),
                           inputs.seed_for(11, 3), "cpu")
        assert _sha256(d) == want["d_weights_sha256"]
    if spec.traffic["kind"] == "train":
        got = train.train_work(config, 7, 2, 3).as_dict()
    else:
        sizes = [(16, 32)] * 5 + [(24, 40)] * 3 + [(32, 64)] * 2 if size == "small" \
            else [(540, 960)] * 9
        got = serve.serve_work(m, sizes).as_dict()
    assert got == want["work"]  # to the bit


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="no architecture file .*swinir_m.py"):
        arch.load({"arch": "swinir_m"})
    with pytest.raises(ValueError, match="no architecture file"):
        arch.load({"arch": "../run"})


def test_work_keeps_op_classes_apart(monkeypatch):
    monkeypatch.setattr(arch, "DIR", Path(__file__).parent)
    planted = arch.load({"arch": "planted_arch"})
    c = work.Conv(64, 64, 3, 128, 256, 128, 256)
    mm = planted.Matmul(128 * 256, 3, 48)
    alone = work.Work("bfloat16")
    alone.add([c], 24, 3)
    both = work.Work("bfloat16")
    both.add([c, mm], 24, 3)
    assert both.as_dict()["conv_min_s"] == alone.as_dict()["conv_min_s"]
    assert both.flops == alone.flops + 3 * mm.flops(24)
    assert both.as_dict()["matmul_min_s"] == pytest.approx(
        3 * max(mm.flops(24) / work.PEAK_FLOPS["bfloat16"], mm.bytes(24, 2) / work.PEAK_BYTES_S))
    assert list(both.as_dict()) == ["flops", "conv_min_s", "matmul_min_s"]


def test_four_card_cells_within_the_share():
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
