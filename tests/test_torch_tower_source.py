"""The CUDA source of the residual tower (``csrc/residual_tower.cu``, K4 and
K5) compiled with g++ against a CPU stand-in for the CUDA runtime
(``tests/cuda_emu/``) and run on the CPU, against the plain version and
its autograd. This checks the kernels' arithmetic, indexing, ragged tiles
and reductions here; whether nvcc accepts the source, and the kernels'
behaviour on the card, only a chip run shows (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The bf16 mode runs the tensor-core tiles (``conv_tc_kernel``,
``wgrad_tc_kernel``): their PTX primitives (``csrc/tower_mma.cuh``) are
replaced by the warp-cooperative stand-ins of ``tests/cuda_emu/
tower_mma.cuh``, which ``test_mma_stand_in_matches_matmul`` holds against
a matrix product, so the kernels' fragment indexing is checked here.

Shapes: H and W not multiples of the conv tile, F in {16, 32, 64, 128}.
Bars as on the card (``tests/test_torch_cuda.py``): max|Δ| ≤ 1e-3·max
(f32), 2e-2·max (bf16) for y, and for the gradients where the ReLU never
clips (``margin``); where it clips, a value within rounding of a kink may
fall on either side, so the gradients are held to ||Δ||/||g|| ≤ 1e-2
(f32) / 1e-1 (bf16) there.
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
EMU = REPO / "tests" / "cuda_emu"


def _compile(src: Path, out: Path) -> ctypes.CDLL:
    """g++ against the stand-ins; the source's own directory comes first on
    the include path, so it must not hold the real ``tower_mma.cuh``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
         "-o", str(out), str(src)],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    src = (REPO / "srgan_tpu_torch" / "csrc" / "residual_tower.cu").read_text()
    # kernel<<<grid, block, smem, stream>>>(args) → emu_launch(kernel, ..., args)
    src = re.sub(r"([A-Za-z_][\w:<>, ]*?)<<<(.*?)>>>\(",
                 lambda m: f"emu_launch({m.group(1).strip()}, {m.group(2)}, ",
                 src, flags=re.S)
    out = tmp_path_factory.mktemp("tower_emu")
    (out / "tower.cpp").write_text(src)
    return tk._bind(_compile(out / "tower.cpp", out / "libtower.so"))


@pytest.fixture(scope="module")
def mma_lib(tmp_path_factory):
    lib = _compile(EMU / "mma_check.cpp", tmp_path_factory.mktemp("mma_emu") / "libmma.so")
    lib.mma_check.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.mma_check.restype = ctypes.c_int
    return lib


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
    ((1, 7, 19, 32), 2, "bfloat16", False),
    ((1, 6, 18, 64), 1, "bfloat16", True),
    ((1, 5, 9, 128), 1, "bfloat16", True),
    # the f32 tiles at their flagship width and at F=128: H and W ragged
    # for the conv tile (16 x 16 at F=64, 8 x 16 at F=128) and the wgrad's
    # 8 x 16 tiles, B*H*W not a multiple of a tile
    ((1, 18, 19, 64), 2, "float32", True),
    ((1, 18, 19, 64), 1, "float32", False),
    ((1, 10, 21, 128), 1, "float32", True),
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
    norm_tol = 1e-2 if cd == torch.float32 else 1e-1
    for name, a, b in zip(["y", "dx", *tk.TowerParams._fields], [y, dx, *grads], want):
        if margin or name == "y":
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= tol, f"{name}: max|Δ| {err:.2e}·max > {tol}"
        else:
            err = float((a - b).norm() / b.norm())
            assert err <= norm_tol, f"{name}: ||Δ||/||g|| {err:.2e} > {norm_tol}"


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


@pytest.mark.parametrize("mode", [0, 1, 2], ids=["fragments", "ldmatrix", "ldmatrix_trans_a"])
def test_mma_stand_in_matches_matmul(mma_lib, mode):
    """The stand-ins of ``mma_bf16_16816`` and ``ldmatrix_x4[_trans]`` on
    seeded bf16 values against A @ B in float64. The operands reach the
    fragments by the PTX ISA's layouts as ``tests/cuda_emu/mma_check.cpp``
    writes them out (mode 0 register by register, modes 1 and 2 through
    ldmatrix as the conv and wgrad tiles load), independently of the tower
    source: a layout slip in a stand-in cannot hide a matching slip in the
    kernels. The products are exact, so only the f32 accumulator rounds."""
    rng = np.random.default_rng(mode)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()
    a = np.ascontiguousarray(bf(rng.standard_normal((16, 16))))
    b = np.ascontiguousarray(bf(rng.standard_normal((16, 16))))
    d = np.full((16, 16), np.nan, np.float32)
    assert mma_lib.mma_check(a.ctypes.data, b.ctypes.data, d.ctypes.data, mode) == 0
    want = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-6 * np.abs(want).max())
