"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each source under ``peekvit_torch/csrc/`` is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/peekvit_torch/<name>-<hash>.so <name>.cu

The library name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and a finished build is reused. Importing this module
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
           "attn_softmax_bwd", "ln_bwd_rows", "quant_rows", "gemm_s8_epilogue", "arpe_tokens",
           "gemm_wgrad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' entry points (see each .cu file).
_SIGNATURES = {
    "norm_rows": ("peekvit_norm_rows",
                  [_P, _I, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I, _P]),
    "gemm_bias_epilogue": ("peekvit_gemm_bias_epilogue",
                           [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "attn_scores_pv": ("peekvit_attn_scores_pv",
                       [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, ctypes.c_float,
                        _P]),
    "attn_softmax_fwd": ("peekvit_attn_softmax_fwd",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]),
    "attn_softmax_bwd": ("peekvit_attn_softmax_bwd",
                         [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]),
    "ln_bwd_rows": ("peekvit_ln_bwd_rows",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float,
                     _I, _P, _P, _P, _I, _P, _P]),
    "quant_rows": ("peekvit_quant_rows",
                   [_P, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float,
                    ctypes.c_float, _I, _P]),
    "gemm_s8_epilogue": ("peekvit_gemm_s8_epilogue",
                         [_P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P]),
    "arpe_tokens": ("peekvit_arpe_tokens",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]),
    "gemm_wgrad": ("peekvit_gemm_wgrad",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, ctypes.c_longlong, _I, _I,
                    _I, _P]),
}

# Further entry points, loaded beside a kernel's own: the schedule a
# kernel takes for a shape (chosen by shape alone inside its C entry
# point), and the attention's exhaustive check of its exp2 terms.
_EXTRA = {
    "gemm_bias_epilogue": [("peekvit_gemm_bias_epilogue_plan", [_I, _I, _I, _P])],
    "attn_softmax_fwd": [("peekvit_attn_softmax_fwd_route", [_I, _I])],
    "attn_softmax_bwd": [("peekvit_attn_softmax_bwd_route", [_I, _I])],
    "attn_scores_pv": [("peekvit_attn_scores_pv_plan", [_I, _I, _I, _I, _P]),
                       ("peekvit_attn_scores_pv_ex2_check", [_P, _P])],
    "gemm_s8_epilogue": [("peekvit_gemm_s8_epilogue_plan", [_I, _I, _P])],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_extra: dict = {}  # symbol -> entry point
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and the shared headers (csrc/*.cuh) it may include
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
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
                lib = ctypes.CDLL(_target(src))
                entries = [(src, _SIGNATURES[src], _libs)] + [
                    (sig[0], sig, _extra) for sig in _EXTRA.get(src, [])]
                for key, (symbol, argtypes), store in entries:
                    entry = getattr(lib, symbol)
                    entry.argtypes = argtypes
                    entry.restype = ctypes.c_int
                    store[key] = entry
    return _libs[name]


def extra(name: str, symbol: str | None = None):
    """A loaded further entry point of kernel ``name`` (``_EXTRA``): its
    first, or the one called ``symbol``."""
    library(name)
    return _extra[symbol or _EXTRA[name][0][0]]
