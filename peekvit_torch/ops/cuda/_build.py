"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under ``peekvit_torch/csrc/`` is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/peekvit_torch/<name>-<hash>.so <name>.cu

The library name carries a hash of the source and flags, so an edited
source is rebuilt and a finished build is reused. Importing this module
builds nothing and needs no ``nvcc``; :func:`library` builds on the first
launch. A failed build raises: nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "peekvit_torch")
SOURCES = ("norm_rows", "gemm_bias_epilogue", "attn_scores_pv", "attn_softmax_fwd",
           "attn_softmax_bwd", "ln_bwd_rows")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' entry points (see each .cu file).
_SIGNATURES = {
    "norm_rows": ("peekvit_norm_rows",
                  [_P, _I, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I, _P]),
    "gemm_bias_epilogue": ("peekvit_gemm_bias_epilogue",
                           [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "attn_scores_pv": ("peekvit_attn_scores_pv",
                       [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    "attn_softmax_fwd": ("peekvit_attn_softmax_fwd",
                         [_P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    "attn_softmax_bwd": ("peekvit_attn_softmax_bwd",
                         [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    "ln_bwd_rows": ("peekvit_ln_bwd_rows",
                    [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "ptxas": [lines], "cached": bool}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from peekvit_torch/csrc at first use")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so")


def build_all() -> dict[str, dict]:
    """Compiles every missing library, one nvcc per source, in parallel.
    Returns BUILD_INFO. Raises RuntimeError with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    start = time.perf_counter()
    for name in SOURCES:
        target = _target(name)
        if os.path.exists(target):
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": [], "cached": True})
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{output}")
            continue
        os.replace(tmp, target)
        BUILD_INFO[name] = {
            "seconds": time.perf_counter() - start,
            "ptxas": [ln.strip() for ln in output.splitlines()
                      if "registers" in ln or "Compiling entry" in ln
                      or "spill" in ln],
            "cached": False,
        }
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return BUILD_INFO


def library(name: str):
    """The loaded entry point of kernel ``name`` (building all on first use)."""
    fn = _libs.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _libs:
            build_all()
            for src in SOURCES:
                symbol, argtypes = _SIGNATURES[src]
                entry = getattr(ctypes.CDLL(_target(src)), symbol)
                entry.argtypes = argtypes
                entry.restype = ctypes.c_int
                _libs[src] = entry
    return _libs[name]
