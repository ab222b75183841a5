"""The CUDA source of the residual tower (``csrc/residual_tower.cu``, K4 and
K5) compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/``) and run on the CPU, against the plain version and
its autograd. This checks the kernels' arithmetic, indexing, ragged tiles
and reductions here; whether nvcc accepts the source, and the kernels'
behaviour on the card, only a chip run shows (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Shapes: H and W not multiples of the conv tile, F in {16, 32}. Bars as
on the card (``tests/test_torch_cuda.py``): max|Δ| ≤ 1e-3·max (f32),
2e-2·max (bf16) for y, and for the gradients where the ReLU never clips
(``margin``); where it clips, a value within rounding of a kink may fall
on either side, so the gradients are held to ||Δ||/||g|| ≤ 1e-2 there.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from srgan_tpu_torch.ops.cuda import residual_tower_kernel as tk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    src = (REPO / "srgan_tpu_torch" / "csrc" / "residual_tower.cu").read_text()
    # kernel<<<grid, block, smem, stream>>>(args) → emu_launch(kernel, ..., args)
    src = re.sub(r"([A-Za-z_][\w:<>, ]*?)<<<(.*?)>>>\(",
                 lambda m: f"emu_launch({m.group(1).strip()}, {m.group(2)}, ",
                 src, flags=re.S)
    out = tmp_path_factory.mktemp("tower_emu")
    (out / "tower.cpp").write_text(src)
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{REPO / 'tests' / 'cuda_emu'}", "-o", str(out / "libtower.so"),
         str(out / "tower.cpp")],
        check=True, capture_output=True,
    )
    return tk._bind(ctypes.CDLL(str(out / "libtower.so")))


def _inputs(shape, n, margin=False, seed=0):
    """``margin``: GN1 scale 0.1, bias 1.0, so the ReLU never clips."""
    rng = np.random.default_rng(seed)
    f = shape[-1]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    w = lambda: t(rng.standard_normal((n, 3, 3, f, f)) / np.sqrt(9 * f))
    g = lambda v: t(v + 0.05 * rng.standard_normal((n, f)))
    params = tk.TowerParams(w(), g(0.1 if margin else 1.1), g(1.0 if margin else 0.05),
                            w(), g(0.9), g(-0.02))
    return t(rng.standard_normal(shape)), t(rng.standard_normal(shape)), params


@pytest.mark.parametrize("shape,n,dtype,margin", [
    ((2, 9, 21, 16), 2, "float32", True),
    ((2, 9, 21, 16), 2, "float32", False),
    ((2, 9, 21, 16), 2, "bfloat16", True),
    ((1, 7, 19, 32), 2, "float32", False),
])
def test_tower_source_matches_plain(emulated_lib, shape, n, dtype, margin):
    cd = getattr(torch, dtype)
    x, dy, params = _inputs(shape, n, margin)
    y = tk._launch_fwd(emulated_lib, x, params, cd, 0).float()
    dx, grads = tk._launch_bwd(emulated_lib, dy, x, params, cd, 0)

    xr = x.clone().requires_grad_(True)
    pr = [p.clone().requires_grad_(True) for p in params]
    y_p = tk.residual_tower_plain(xr, tk.TowerParams(*pr), cd)
    want = [y_p.detach(), *torch.autograd.grad(y_p, [xr, *pr], dy)]
    tol = 1e-3 if cd == torch.float32 else 2e-2
    for name, a, b in zip(["y", "dx", *tk.TowerParams._fields], [y, dx, *grads], want):
        if margin or name == "y":
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= tol, f"{name}: max|Δ| {err:.2e}·max > {tol}"
        else:
            err = float((a - b).norm() / b.norm())
            assert err <= 1e-2, f"{name}: ||Δ||/||g|| {err:.2e} > 1e-2"


def test_unsupported_features_refused(emulated_lib):
    """An F the source does not instantiate: the size query says -1, the C
    entry point returns an error code without launching, and the wrapper's
    check turns that code into an exception."""
    assert emulated_lib.tower_partials_doubles(1, 4, 4, 24) == -1
    rc = emulated_lib.tower_forward(*[None] * 8, 1, 1, 4, 4, 24, 0,
                                    *[None] * 5, None)
    assert rc != 0
    with pytest.raises(RuntimeError, match="tower_forward"):
        tk._raise_if_failed(emulated_lib, rc, "tower_forward")
