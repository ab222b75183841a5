"""ctypes binding of the native C++ image codec (``loader.cpp``), the
counterpart of ``srgan_tpu/native``.

``load_batch_u8`` decodes and resizes a whole batch on C++ threads with the
GIL released (ctypes releases it for the call), ``save_batch_u8`` encodes
one; the single-image and float32 forms are here too. The library is built
with ``g++`` (``-ljpeg -lpng``) at first use into ``srgan_tpu_torch/_build/``,
named by a hash of the source and flags, so an edit rebuilds. Where it
cannot be built (no compiler, no libjpeg or libpng), :func:`available` is
False and callers take their PIL path, as the JAX package's do;
:func:`build_error` keeps the compiler's first error line for a caller to
report which codec served and why.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")
VERSION = 4  # the source's srgan_loader_version(): the encoder API exists


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libsrgan_loader-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature."""
    P, I = ctypes.POINTER, ctypes.c_int
    names = ctypes.POINTER(ctypes.c_char_p)
    f32, u8 = P(ctypes.c_float), P(ctypes.c_uint8)
    for fn, px in (("srgan_load_image", f32), ("srgan_load_image_u8", u8),
                   ("srgan_save_image", f32), ("srgan_save_image_u8", u8)):
        getattr(lib, fn).argtypes = [ctypes.c_char_p, I, I, px]
        getattr(lib, fn).restype = I
    for fn, px in (("srgan_load_batch", f32), ("srgan_load_batch_u8", u8),
                   ("srgan_save_batch", f32), ("srgan_save_batch_u8", u8)):
        getattr(lib, fn).argtypes = [names, I, I, I, px, P(I), I]
        getattr(lib, fn).restype = I
    lib.srgan_loader_version.argtypes = []
    lib.srgan_loader_version.restype = I
    return lib


class _Build:
    """The one build attempt of this process and its outcome."""
    tried = False
    error: Optional[str] = None


def build() -> bool:
    """Compile the library (g++) unless it is built. True on success; on
    failure :func:`build_error` holds the compiler's first error line."""
    out = library_path()
    if out.exists():
        return True
    BUILD_DIR.mkdir(exist_ok=True)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        _Build.error = "no C++ compiler (g++ or c++) on PATH"
        return False
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), *LIBS, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        lines = (proc.stderr or proc.stdout).splitlines()
        marks = ("error", "cannot find", "No such file")
        _Build.error = next((ln for ln in lines if any(m in ln for m in marks)),
                            lines[0] if lines else f"exit {proc.returncode}")
        tmp.unlink(missing_ok=True)
        return False
    # atomic, and a new inode: a process holding an older build keeps it
    os.replace(tmp, out)
    return True


def build_error() -> Optional[str]:
    """The compiler's first error line of this process's failed build, or
    None."""
    return _Build.error


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    return _bind(ctypes.CDLL(str(library_path())))


def available() -> bool:
    """True when the library is built and loads; builds it once a process
    (~2 s) if it is missing. False where it cannot be built: the callers
    then decode and encode with PIL."""
    if not library_path().exists():
        if _Build.tried:
            return False
        _Build.tried = True
        if not build():
            return False
    try:
        _load()
    except OSError as e:  # built, but a library it links does not load
        _Build.error = f"built, but it does not load: {e}"
        return False
    return True


def encoder_available() -> bool:
    """True when the library exposes the encoder API (version >= 4)."""
    return available() and _load().srgan_loader_version() >= VERSION


def _names(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_image(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """Decode + PIL-parity bicubic resize one image to (out_h, out_w, 3)
    float32 [0, 1]; None for corrupt or unreadable files."""
    out = np.empty((out_h, out_w, 3), np.float32)
    rc = _load().srgan_load_image(path.encode(), out_h, out_w, _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def load_image_u8(path: str, out_h: int, out_w: int) -> Optional[np.ndarray]:
    """uint8 form of :func:`load_image`."""
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = _load().srgan_load_image_u8(path.encode(), out_h, out_w, _ptr(out, ctypes.c_uint8))
    return out if rc == 0 else None


def _load_batch(fn: str, dtype, ctype, paths, out_h, out_w, num_threads):
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), dtype)
    status = np.empty(n, np.int32)
    getattr(_load(), fn)(_names(paths), n, out_h, out_w, _ptr(out, ctype),
                         _ptr(status, ctypes.c_int), num_threads)
    return out, status == 0


def load_batch(paths: List[str], out_h: int, out_w: int,
               num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a batch on C++ threads: ((n, out_h, out_w, 3) float32, (n,)
    ok mask). A False entry is a corrupt file, its row undefined."""
    return _load_batch("srgan_load_batch", np.float32, ctypes.c_float,
                       paths, out_h, out_w, num_threads)


def load_batch_u8(paths: List[str], out_h: int, out_w: int,
                  num_threads: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 form of :func:`load_batch` (lossless: the resampler quantises
    to the uint8 grid each pass); a quarter of the host→device bytes."""
    return _load_batch("srgan_load_batch_u8", np.uint8, ctypes.c_uint8,
                       paths, out_h, out_w, num_threads)


def save_image(path: str, img: np.ndarray) -> bool:
    """Encode one HWC float32 [0, 1] image (PNG, or JPEG for .jpg/.jpeg),
    quantised as ``utils.image_io.array_to_image`` does."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    h, w, _ = img.shape
    return _load().srgan_save_image(path.encode(), h, w, _ptr(img, ctypes.c_float)) == 0


def _save_batch(fn: str, dtype, ctype, paths, imgs, num_threads):
    imgs = np.ascontiguousarray(imgs, dtype=dtype)
    n, h, w, _ = imgs.shape
    status = np.empty(n, np.int32)
    getattr(_load(), fn)(_names(paths), n, h, w, _ptr(imgs, ctype),
                         _ptr(status, ctypes.c_int), num_threads)
    return status == 0


def save_batch(paths: List[str], imgs: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """Encode an (n, h, w, 3) float32 batch on C++ threads; an ok mask."""
    return _save_batch("srgan_save_batch", np.float32, ctypes.c_float,
                       paths, imgs, num_threads)


def save_batch_u8(paths: List[str], imgs: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """Encode a uint8 (n, h, w, 3) batch on C++ threads (the sink of the
    device-quantised SR frames, ``steps.infer_step_u8``); an ok mask."""
    return _save_batch("srgan_save_batch_u8", np.uint8, ctypes.c_uint8,
                       paths, imgs, num_threads)
