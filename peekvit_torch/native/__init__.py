"""Native (C++) host-side image decoder: built at first use, bound with
ctypes (counterpart of peekvit_tpu/native).

``load_library()`` compiles ``image_pipeline.cpp`` with ``g++`` into
``build/peekvit_torch/image_pipeline-<hash>.so``, the hash taken over the
source, so an edited source is rebuilt and a finished build is reused. The
library is written under a name of its own process and put in place with
``os.replace``, so processes that build at once do not race; the port's
own builds of other source revisions are removed.

Where the build or the load fails (no ``g++``, no ``jpeglib.h`` /
``png.h``), ``available()`` is False and ``build_error()`` says why; every
caller (``data/datasets.ImageFolder``, ``data/loader.DataLoader``) then
decodes with PIL. This is a host library: the decision is the host's
toolchain's, never a device's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "image_pipeline.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "peekvit_torch")
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_build_error: Optional[str] = None


def _so_path() -> Optional[str]:
    """The library's path, keyed on the source's hash; None without a source."""
    if not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"image_pipeline-{digest}.so")


def _build(so: str) -> Optional[str]:
    """Compile into ``so``; the error (the compiler's, or the file
    system's), or None. Nothing is left under the temporary name."""
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [COMPILER, *FLAGS, "-o", tmp, SOURCE, *LIBS]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
        if proc.returncode != 0:
            return f"{' '.join(cmd)}: {proc.stderr[-2000:]}"
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError) as e:  # no compiler, unwritable, timed out
        return f"{' '.join(cmd)}: {e}"
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    for name in os.listdir(BUILD_DIR):  # the port's builds of other revisions
        path = os.path.join(BUILD_DIR, name)
        if name.startswith("image_pipeline-") and name.endswith(".so") and path != so:
            try:
                os.remove(path)
            except OSError:
                pass
    return None


def _bind(lib) -> None:
    lib.pv_decode_transform.restype = ctypes.c_int
    lib.pv_decode_transform.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    lib.pv_load_batch.restype = ctypes.c_int
    lib.pv_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.pv_decode.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.pv_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.pv_free.argtypes = [ctypes.c_void_p]


def load_library():
    """The bound library, built at the first call; None where the build or
    the load failed (``build_error()`` says why)."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        return None
    so = _so_path()
    if so is None:
        _build_error = f"native source not found: {SOURCE}"
        return None
    if not os.path.exists(so):
        _build_error = _build(so)
        if _build_error is not None:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        # another source revision's build removed ours between the check
        # and the load: build once more
        _build_error = _build(so)
        if _build_error is not None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _build_error = str(e)
            return None
    _bind(lib)
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    load_library()
    return _build_error


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_transform(data: bytes, resize: int, size: int, mean, std) -> Optional[np.ndarray]:
    """One in-memory JPEG or PNG as a normalized float32 (size, size, 3)
    array: resize the short side to ``resize``, center-crop ``size``; None
    where the library is missing or the image is rejected."""
    lib = load_library()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    ok = lib.pv_decode_transform(data, len(data), resize, size, _fptr(mean), _fptr(std),
                                 _fptr(out))
    return out if ok else None


def decode(data: bytes) -> Optional[np.ndarray]:
    """The raw decode as uint8 HWC RGB at full resolution (the scaled DCT
    applies to the transform paths only)."""
    lib = load_library()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    ptr = lib.pv_decode(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if not ptr:
        return None
    arr = np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    lib.pv_free(ptr)
    return arr


def load_batch(paths, resize: int, size: int, mean, std, num_threads: int = 8):
    """Decode and transform a batch of image files in ``num_threads``
    native threads. Returns (batch (n, size, size, 3) float32, ok flags
    (n,) bool), or (None, None) without the library."""
    lib = load_library()
    if lib is None:
        return None, None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.zeros((n,), np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.pv_load_batch(c_paths, n, resize, size, _fptr(mean), _fptr(std), _fptr(out),
                      ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    return out, ok.astype(bool)
