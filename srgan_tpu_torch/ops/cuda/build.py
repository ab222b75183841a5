"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with ``nvcc``
into ``_build/lib<name>-<hash>.so`` (the hash covers the source, every
``csrc/*.cuh`` header and the flags, so an edit to any of them rebuilds),
then loaded with ``ctypes``. Nothing is built
when a module is imported: the first call that needs a library builds it.
``build()`` compiles several sources at once, one ``nvcc`` each, all started
together. ``current_stream`` and ``on_device`` serve the wrappers' launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("recon_loss", "residual_tower", "group_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        home and os.path.join(home, "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile each named source that is not built yet, all in parallel.
    Returns ``ptxas`` resource reports (registers, shared memory, spills)
    by source name; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running[name] = (proc, tmp, out)
    # wait for every compiler before raising, so none outlives the call
    outputs = {name: proc.communicate() for name, (proc, _, _) in running.items()}
    reports = {}
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = outputs[name]
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for csrc/{name}.cu:\n{stdout}{stderr}"
            )
        out.with_suffix(".ptxas").write_text(stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        reports[name] = stderr
    return reports


def ptxas_report(name: str) -> str:
    """The ``ptxas`` resource report of the built ``csrc/<name>.cu``."""
    build((name,))
    return library_path(name).with_suffix(".ptxas").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


# A wrapper's host cost a call sits beside a kernel of ~0.03 ms on the card,
# so the two helpers below take the cheap routes: the raw handle of the
# current stream, as PyTorch's generated code reads it (a Stream object
# costs ~5 µs more), and the device guard only where another device is
# current (~3 µs).


def current_stream(t: torch.Tensor) -> int:
    """The raw handle of ``t``'s device's current stream."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor):
    """A guard that makes ``t``'s device current, where it is not already."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
