"""Quantization-aware training: straight-through fake quantization
(counterpart of peekvit_tpu/ops/fake_quant.py).

The int8 engines (``InferenceEngine(quantized=True)``) round weights to
per-output-column int8 (``ops/cuda/quant_blocks.quantize_linear``) and
activations to per-row int8 (``quant_rows``: dynamic absmax, or a static
scale cap/127 with saturation under ``calib_static_caps=True``). Under
:func:`fake_quant` every matmul the engine quantizes sees
``dequant(quant(.))`` of both operands on exactly that grid, with a
straight-through gradient, so that fine-tuning learns weights that
tolerate the rounding the engine later commits.

The sites are JAX's: the qkv and out-proj matmuls of
``ops/attention.multi_head_attention`` (both branches of the attention
switch) and fc1 / fc2 of ``ops/mlp.mlp_forward``, named ``"qkv"``,
``"out"``, ``"fc1"`` and ``"fc2"``.

- **dynamic** (``fake_quant(True)``): per-row absmax scales.
- **static caps** (``fake_quant(True, caps=...)``): one
  ``((attn_ln, attn_out), (mlp_ln, mlp_h))`` tuple per encoder layer
  (``inference.collect_activation_caps`` and the residual collector); the
  scale is cap/127 with saturation, and the gradient is zero where the
  engine saturates (clipped straight-through).
- **smoothing** (``fake_quant(True, smoothing=...)``): per layer the
  SmoothQuant vectors ``(s1, s2)``; at the two LN-output sites (qkv, fc1)
  the hook quantizes ``x / s`` against ``w * s[:, None]``, the grid the
  engine bakes in at calibration (``inference.smooth_vit_params``).

JAX's switch acts while a forward is traced; here it acts while a forward
runs, so the ``Trainer`` wraps every forward (train and eval) in the
context. Per-site counters assign the layer index under caps or
smoothing, in the order the layers run; at exit each site must have
consumed every calibrated layer exactly, else ``ValueError``. A backward
that reruns the forward (``torch.utils.checkpoint``) would run it outside
the context, unquantized: the ``Trainer`` refuses ``remat`` under QAT.

The divisions are true fp32 divisions on every device
(``quant_blocks._div``), as the engine's own, and rounding is half to even
(``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from peekvit_torch.ops.cuda.quant_blocks import _div, static_scale

_ENABLED = False
_CAPS = None
_SMOOTH = None
_SITE_IDX = None

# site name -> index into the per-layer ((a1, a2), (m1, m2)) caps tuple
_SITE_SLOT = {"qkv": (0, 0), "out": (0, 1), "fc1": (1, 0), "fc2": (1, 1)}
# SmoothQuant applies only at the two LN-output sites (the engine bakes s
# into the LN affine and the next weight's rows)
_SITE_SMOOTH = {"qkv": 0, "fc1": 1}


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def fake_quant(on: bool = True, caps=None, smoothing=None):
    """Fake-quantize the hooked matmuls of every forward run in this block:
    on the dynamic grid, or on the static grid of ``caps`` (one
    ``((attn_ln, attn_out), (mlp_ln, mlp_h))`` per encoder layer), with
    the SmoothQuant vectors ``smoothing`` (one ``(s1, s2)`` per layer)
    applied at the LN-output sites. Raises ``ValueError`` when caps and
    smoothing cover different numbers of layers, and at exit when the
    forward did not consume every calibrated layer exactly once a site."""
    global _ENABLED, _CAPS, _SMOOTH, _SITE_IDX
    prev = (_ENABLED, _CAPS, _SMOOTH, _SITE_IDX)
    _ENABLED = bool(on)
    _CAPS = tuple(caps) if (on and caps is not None) else None
    _SMOOTH = tuple(smoothing) if (on and smoothing is not None) else None
    if _CAPS is not None and _SMOOTH is not None and len(_CAPS) != len(_SMOOTH):
        _ENABLED, _CAPS, _SMOOTH, _SITE_IDX = prev
        raise ValueError(
            f"fake_quant: caps cover {len(caps)} layers but smoothing covers "
            f"{len(smoothing)}: calibrate both on the same model "
            "(inference.collect_qat_calibration returns a matched pair)")
    _SITE_IDX = ({s: 0 for s in _SITE_SLOT}
                 if (_CAPS is not None or _SMOOTH is not None) else None)
    try:
        yield
        if _SITE_IDX is not None:
            n = len(_CAPS) if _CAPS is not None else len(_SMOOTH)
            if set(_SITE_IDX.values()) != {n}:
                # zero consumption means the forward never reached the
                # hooks and would train unquantized
                raise ValueError(
                    "static-caps/smoothed QAT consumed caps unevenly "
                    f"(per-site counts {_SITE_IDX}, {n} layer entries): the model's "
                    "quantized matmuls are not exactly the four encoder-layer sites the "
                    "calibration covers (supported: plain/Rank/Residual ViT encoders)")
    finally:
        _ENABLED, _CAPS, _SMOOTH, _SITE_IDX = prev


def site_counts():
    """A copy of the per-site layer counters (None without caps or
    smoothing), for :func:`rewind_sites`."""
    return None if _SITE_IDX is None else dict(_SITE_IDX)


def rewind_sites(counts) -> None:
    """Set the per-site counters back to ``counts``. A stack of E experts
    run one after the other here is one vmapped call in JAX, traced once:
    each expert rewinds to the stack's first counts, so that the stack
    consumes one layer a site, as there."""
    if _SITE_IDX is not None and counts is not None:
        _SITE_IDX.update(counts)


def _ste(x32: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward q, gradient identity."""
    return x32 + (q - x32).detach()


def fq_weight(w: torch.Tensor) -> torch.Tensor:
    """dequant(quant(w)) on the engine's weight grid: symmetric int8 per
    output column (``quantize_linear``), straight-through gradient."""
    wf = w.float()
    s = torch.clamp(_div(wf.abs().amax(0, keepdim=True), 127.0), min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127) * s
    return _ste(wf, q).to(w.dtype)


def fq_act(x: torch.Tensor, cap=None) -> torch.Tensor:
    """dequant(quant(x)) on the engine's activation grid: per-row dynamic
    absmax (``quant_rows``) with an identity straight-through gradient, or,
    with ``cap``, the static scale cap/127 with saturation and a clipped
    gradient (zero where the engine saturates)."""
    xf = x.float()
    if cap is not None:
        s = static_scale(cap)
        q = torch.clamp(torch.round(_div(xf, s)), -127, 127) * s
        bound = float(np.float32(s) * np.float32(127.0))
        inside = xf * (xf.abs() <= bound).float()
        return (inside + (q - inside).detach()).to(x.dtype)
    s = torch.clamp(_div(xf.abs().amax(-1, keepdim=True), 127.0), min=1e-12)
    q = torch.clamp(torch.round(xf / s), -127, 127) * s
    return _ste(xf, q).to(x.dtype)


def maybe_fq(x: torch.Tensor, w: torch.Tensor, site: str | None = None):
    """(x, w) fake-quantized when QAT is on, unchanged otherwise. Under caps
    or smoothing the site's counter assigns the layer index; with
    smoothing the LN-output sites quantize ``(x / s, w * s[:, None])``."""
    if not _ENABLED:
        return x, w
    cap = None
    if _SITE_IDX is not None and site is not None:
        n = len(_CAPS) if _CAPS is not None else len(_SMOOTH)
        i = _SITE_IDX[site]
        if i >= n:
            raise ValueError(
                f"static-caps/smoothed QAT: site '{site}' ran more than the {n} calibrated "
                "encoder layers: the model has quantized matmuls outside the encoder stack "
                "(supported: plain/Rank/Residual ViT encoders)")
        _SITE_IDX[site] = i + 1
        if _CAPS is not None:
            a, b = _SITE_SLOT[site]
            cap = _CAPS[i][a][b]
        if _SMOOTH is not None and site in _SITE_SMOOTH:
            s = torch.as_tensor(_SMOOTH[i][_SITE_SMOOTH[site]], dtype=torch.float32,
                                device=x.device)
            x = (x.float() / s).to(x.dtype)
            w = (w.float() * s[:, None]).to(w.dtype)
    return fq_act(x, cap), fq_weight(w)
