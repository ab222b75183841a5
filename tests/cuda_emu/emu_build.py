"""Compile a CUDA source of ``srgan_tpu_torch/csrc/`` with g++ against the
CPU stand-ins beside this file, for the ``tests/test_torch_*_source.py``
tests."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest

EMU = Path(__file__).resolve().parent


def rewrite_launches(src: str) -> str:
    """``kernel<<<grid, block, smem, stream>>>(args`` → ``emu_launch(kernel,
    grid, block, smem, stream, args``."""
    return re.sub(r"([A-Za-z_][\w:<>, ]*?)<<<(.*?)>>>\(",
                  lambda m: f"emu_launch({m.group(1).strip()}, {m.group(2)}, ",
                  src, flags=re.S)


def compile_lib(src: Path, out: Path, *flags: str) -> ctypes.CDLL:
    """g++ against the stand-ins; the source's own directory comes first on
    the include path, so it must not hold the real ``tower_mma.cuh``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    done = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", f"-I{EMU}",
         *flags, "-o", str(out), str(src)],
        capture_output=True, text=True,
    )
    if done.returncode:
        raise RuntimeError(f"g++ failed for {src.name}:\n{done.stderr}")
    return ctypes.CDLL(str(out))


def compile_source(name: str, tmp: Path, *flags: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` with its launches rewritten, built in ``tmp``."""
    src = EMU.parents[1] / "srgan_tpu_torch" / "csrc" / f"{name}.cu"
    cpp = tmp / f"{name}.cpp"
    cpp.write_text(rewrite_launches(src.read_text()))
    return compile_lib(cpp, tmp / f"lib{name}.so", *flags)
