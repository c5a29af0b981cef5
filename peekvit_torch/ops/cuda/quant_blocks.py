"""The int8 (w8a8) layer's kernels: wrappers, plain versions and the layer
compositions (counterpart of peekvit_tpu/ops/pallas/quant_blocks.py).

The Pallas int8 layer (``_q_layer_kernel``) keeps a layer's int8 weights
resident in TPU VMEM and quantizes its activations inside the kernel. On
Hopper its contract becomes nine launches per layer over two hand-written
CUDA kernels (``peekvit_torch/csrc``) and the ported attention::

    quant_rows(LN1) -> gemm_s8(+bias -> bf16 qkv) -> attn_scores_pv
    -> quant_rows -> gemm_s8(+bias+x -> fp32 y) -> quant_rows(LN2)
    -> gemm_s8(+bias, tanh-gelu -> fp32 h) -> quant_rows
    -> gemm_s8(+bias+y -> x.dtype)

``quant_rows`` is ``_quant_rows`` (per-row dynamic absmax / 127 with a
1e-12 floor, or a static calibrated cap with saturation; codes
clip(round(v / s), -127, 127), true division, round half to even),
optionally after the one-pass LN with its affine applied (``_ln_f32``).
``gemm_s8_epilogue`` is ``_qmatmul``: s8 x s8 summed exactly in s32,
dequantized as float(acc) * s_row * s_col, then + bias and the epilogue.
The rounding points are the Pallas bodies': qkv and the attention output
are bf16 even under an fp32 compute dtype, the merged layer's mid
residual y and the gelu output h stay fp32, the output is in x's dtype.

The GEMM kernel reads W as (out, in) (8-bit wgmma takes both operands
K-major: K-contiguous per output column). The public functions keep
JAX's (in, out) weights; on the card each int8 weight must be the (in,
out) view of an (out, in) copy, which :func:`kernel_layout` makes once
at engine build (``prepare_engine_params``), so no forward transposes a
weight.

Each kernel has a plain PyTorch version here (``*_ref``). The plain GEMM
multiplies the codes in float64, exact below 2^53 (an fp32 product is
not: 127^2 * 3072 > 2^24), on the CPU and on the card alike.

The ResidualViT int8 layer (``_q_layer_kernel`` mode ``masked``, and the
split ``quant_masked_attention_block`` / ``quant_masked_mlp_block``) runs
the same launches with a per-row mask: ``quant_rows`` multiplies the LN
output by the mask before the scale and the codes (mask * LN on both
sublayers), and the out-projection's epilogue masks its output before
the residual add (``masked_residual_f32`` in the merged layer,
``masked_residual`` in the split sublayer); the MLP's residual stays
unmasked.

The int8 MoE engine's expert sublayers are XLA in JAX (``_quant_linear_xla``,
no Pallas kernel); here :func:`quant_experts` runs them on the same two
kernels: ``quant_rows`` once per input, then one GEMM s8 ``bias_f32`` per
expert.

Dispatch is by device only, as in ``fused_attention.py``: a wrapper uses
the plain version for CPU tensors; for CUDA tensors it launches its
kernel or raises. Launches are counted in ``fused_attention.LAUNCHES``
by kernel and variant (``quant_rows[.ln].{bf16,f32}[.static][.masked]``,
``gemm_s8_epilogue.<epilogue>``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from peekvit_torch.ops.cuda import _build
from peekvit_torch.ops.cuda.fused_attention import (
    _check_bf16,
    _launched,
    _on_cpu,
    _require,
    _rows_mask,
    _stream,
    attn_scores_pv,
    attn_scores_pv_ref,
)

_EPILOGUES = {"bias": 0, "gelu_f32": 1, "residual_f32": 2, "residual": 3,
              "masked_residual_f32": 4, "masked_residual": 5, "bias_f32": 6}
MAX_ROW_WIDTH = 3072  # quant_rows keeps a row in one warp's registers


def _div(t: torch.Tensor, c) -> torch.Tensor:
    """t / c in true fp32 division on every device (torch divides a CUDA
    tensor by a Python scalar through the scalar's reciprocal)."""
    return t / torch.tensor(c, dtype=torch.float32, device=t.device)


def quantize_linear(w: torch.Tensor):
    """(in, out) weights -> (int8 weights (in, out), (1, out) fp32 scales):
    symmetric per output column, absmax / 127 with a 1e-12 floor, codes
    rounded half to even (``quantize_linear``, quant_blocks.py:33). Done
    once at engine build, not a kernel."""
    w = w.float()
    scale = torch.clamp(_div(w.abs().amax(0, keepdim=True), 127.0), min=1e-12)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def kernel_layout(wq: torch.Tensor) -> torch.Tensor:
    """The same (in, out) int8 weight as a view of an (out, in) contiguous
    copy: the layout :func:`gemm_s8_epilogue` reads on the card. A stack
    (E, in, out) of expert weights becomes the view of an (E, out, in)
    copy, so that each expert's slice is in that layout."""
    return wq.transpose(-1, -2).contiguous().transpose(-1, -2)


def static_scale(cap: float) -> float:
    """The static activation scale max(cap, 1e-12) / 127 in fp32 (Pallas
    ``_quant_rows`` with a cap)."""
    return float(np.maximum(np.float32(cap), np.float32(1e-12)) / np.float32(127.0))


# ----------------------------------------------------------------- quant_rows


def _check_ln(ln_scale, ln_bias, mask=None):
    _require((ln_scale is None) == (ln_bias is None), "quant_rows: the LN scale and bias "
             "come together")
    _require(mask is None or ln_scale is not None, "quant_rows: the row mask multiplies the "
             "LN output and needs the LN")


def ln_f32_ref(x, ln_scale, ln_bias, eps):
    """One-pass LN in fp32 with the affine applied (Pallas ``_ln_f32``):
    var = max(E[x^2] - mu^2, 0), the means as sums over the row width."""
    xf = x.float()
    d = xf.shape[-1]
    mu = _div(xf.sum(-1, keepdim=True), d)
    ms = _div((xf * xf).sum(-1, keepdim=True), d)
    var = torch.clamp(ms - mu * mu, min=0.0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out * ln_scale.float().reshape(-1) + ln_bias.float().reshape(-1)


def quant_rows_ref(x: torch.Tensor, cap=None, ln_scale=None, ln_bias=None, eps: float = 1e-5,
                   mask=None):
    """Plain version of :func:`quant_rows`."""
    _check_ln(ln_scale, ln_bias, mask)
    v = x.float() if ln_scale is None else ln_f32_ref(x, ln_scale, ln_bias, eps)
    if mask is not None:
        v = v * mask.float().reshape(-1, 1)
    if cap is not None:
        s = static_scale(cap)
        q = _div(v, s)
    else:
        s = torch.clamp(_div(v.abs().amax(-1, keepdim=True), 127.0), min=1e-12)
        q = v / s
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8), s


def quant_rows(x: torch.Tensor, cap=None, ln_scale=None, ln_bias=None, eps: float = 1e-5,
               mask=None):
    """Per-row symmetric int8 quantization of x (R, D), bf16 or fp32, after
    the one-pass LN with affine when ``ln_scale``/``ln_bias`` (D,) are
    given, and after the LN output times the row ``mask`` (one value per
    row, the ResidualViT int8 layer's mask * LN) when it is given.
    Returns (codes (R, D) int8, scale): with ``cap=None`` the scale is per
    row, (R, 1) fp32 (absmax / 127, floor 1e-12: a masked row of zeros
    gets the floor and zero codes); with a static ``cap`` it is the Python
    float max(cap, 1e-12) / 127 and values beyond the cap saturate at +-127
    (Pallas ``_quant_rows``, after ``_ln_f32`` and the mask). On CUDA the
    LN affine and the mask are bf16, D a multiple of 8 up to 3072."""
    _check_ln(ln_scale, ln_bias, mask)
    if _on_cpu(x, ln_scale, ln_bias, mask):
        return quant_rows_ref(x, cap, ln_scale, ln_bias, eps, mask)
    ln = ln_scale is not None
    key = ("quant_rows.ln" if ln else "quant_rows") + (
        ".f32" if x.dtype == torch.float32 else ".bf16") + (
        ".static" if cap is not None else "") + (".masked" if mask is not None else "")
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"{key}: input must be bf16 or fp32, got {x.dtype}")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             f"{key}: input must be contiguous and 16-byte aligned")
    d = x.shape[-1]
    rows = x.numel() // d
    _require(d % 8 == 0 and d <= MAX_ROW_WIDTH,
             f"{key}: row width {d} must be a multiple of 8 up to {MAX_ROW_WIDTH}")
    if ln:
        ln_scale, ln_bias = ln_scale.reshape(-1), ln_bias.reshape(-1)
        _check_bf16(f"{key} ln_scale", ln_scale)
        _check_bf16(f"{key} ln_bias", ln_bias)
        _require(ln_scale.numel() == d and ln_bias.numel() == d,
                 f"{key}: LN affine must have {d} values")
    if mask is not None:
        mask = _rows_mask(key, mask, rows)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if cap is None:
        scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
        s_static, scale_ptr = 0.0, scale.data_ptr()
    else:
        scale = s_static = static_scale(cap)
        scale_ptr = None
    err = _build.library("quant_rows")(
        x.data_ptr(), int(x.dtype == torch.float32),
        ln_scale.data_ptr() if ln else None, ln_bias.data_ptr() if ln else None,
        None if mask is None else mask.data_ptr(), codes.data_ptr(), scale_ptr, rows, d,
        float(eps), s_static, int(cap is not None), _stream())
    _launched(key, err)
    return codes, scale


# ------------------------------------------------------------ gemm_s8_epilogue


def _check_epilogue(epilogue, residual, mask):
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    needs_res = "residual" in epilogue
    needs_mask = epilogue.startswith("masked")
    _require((residual is not None) == needs_res,
             f"epilogue {epilogue!r} {'needs' if needs_res else 'takes no'} residual")
    _require((mask is not None) == needs_mask,
             f"epilogue {epilogue!r} {'needs' if needs_mask else 'takes no'} mask")
    return needs_res, needs_mask


def _out_dtype(epilogue, out_dtype):
    if epilogue == "bias":
        return torch.bfloat16
    if epilogue.endswith("_f32"):
        return torch.float32
    return out_dtype


def gemm_s8_plan(m: int, n: int) -> dict:
    """The schedule :func:`gemm_s8_epilogue` takes on the card for an (m, n)
    output, chosen by shape inside its C entry point: the C tile width
    (128 or 192) and the number of persistent CTAs. For the record; needs
    the built library."""
    out = (ctypes.c_int * 2)()
    _build.extra("gemm_s8_epilogue")(m, n, out)
    return {"bn": out[0], "grid": out[1]}


def gemm_s8_epilogue_ref(a, s_a, w, s_w, bias, epilogue: str, residual=None,
                         out_dtype=torch.bfloat16, mask=None):
    """Plain version of :func:`gemm_s8_epilogue`: the codes multiplied in
    float64 (exact), rounded once to fp32, then the Pallas dequant order."""
    _check_epilogue(epilogue, residual, mask)
    acc = torch.matmul(a.double(), w.double()).float()
    if isinstance(s_a, torch.Tensor):
        s_a = s_a.float().reshape(-1, 1)
    v = acc * s_a * s_w.float().reshape(1, -1) + bias.float().reshape(-1)
    if epilogue == "gelu_f32":
        v = F.gelu(v, approximate="tanh")
    if mask is not None:
        v = v * mask.float().reshape(-1, 1)
    if residual is not None:
        v = v + residual.float()
    return v.to(_out_dtype(epilogue, out_dtype))


def gemm_s8_epilogue(a: torch.Tensor, s_a, w: torch.Tensor, s_w: torch.Tensor,
                     bias: torch.Tensor, epilogue: str, residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.bfloat16,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """C = dequant(a @ w) with a fused epilogue (Pallas ``_qmatmul`` and
    the steps after it). a: (R, K) int8 codes with ``s_a`` their scale,
    (R, 1) fp32 or one Python float (a static cap's scale); w: (K, N) int8,
    the (in, out) layout, with ``s_w`` (1, N) fp32; bias (N,). The value
    is float(a @ w) * s_a * s_w + bias, then per ``epilogue``:

    - ``"bias"``: -> bf16 (qkv, bf16 under any compute dtype);
    - ``"gelu_f32"``: tanh-gelu -> fp32 (fc1: h is never rounded);
    - ``"residual_f32"``: + residual -> fp32 (the merged out-proj: y);
    - ``"residual"``: + residual -> ``out_dtype`` (fc2, the split
      out-proj);
    - ``"masked_residual_f32"``: (.) * mask + residual -> fp32 (the
      ResidualViT int8 layer's out-proj: y);
    - ``"masked_residual"``: (.) * mask + residual -> ``out_dtype`` (the
      split masked attention sublayer's out-proj);
    - ``"bias_f32"``: -> fp32, unrounded (the MoE experts' int8 linear,
      JAX ``_quant_linear_xla``).

    The residual is (R, N), fp32 or bf16; the mask has one value per row
    (R values). On CUDA: bias and mask bf16, out_dtype bf16, and w the
    (in, out) view of an (out, in) contiguous tensor
    (:func:`kernel_layout`); K a multiple of 16, N of 8."""
    needs_res, needs_mask = _check_epilogue(epilogue, residual, mask)
    scale_t = s_a if isinstance(s_a, torch.Tensor) else None
    if _on_cpu(a, scale_t, w, s_w, bias, residual, mask):
        return gemm_s8_epilogue_ref(a, s_a, w, s_w, bias, epilogue, residual, out_dtype, mask)
    key = f"gemm_s8_epilogue.{epilogue}"
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0],
             f"{key}: shapes {tuple(a.shape)} @ {tuple(w.shape)} do not chain")
    m, k = a.shape
    n = w.shape[1]
    _require(k % 16 == 0, f"{key}: K={k} must be a multiple of 16")
    _require(n % 8 == 0, f"{key}: N={n} must be a multiple of 8")
    _require(a.dtype == torch.int8 and w.dtype == torch.int8, f"{key}: a and w must be int8")
    _require(a.is_contiguous() and a.data_ptr() % 16 == 0,
             f"{key}: a must be contiguous and 16-byte aligned")
    wt = w.t()
    _require(wt.is_contiguous() and wt.data_ptr() % 16 == 0,
             f"{key}: w must be the (in, out) view of an (out, in) contiguous tensor "
             f"(kernel_layout, made once at engine build)")
    _require(epilogue not in ("residual", "masked_residual") or out_dtype == torch.bfloat16,
             f"{key}: the kernel writes bf16 for this epilogue")
    s_w = s_w.reshape(-1)
    _require(s_w.dtype == torch.float32 and s_w.is_contiguous() and s_w.numel() == n,
             f"{key}: s_w must be {n} contiguous fp32 values")
    bias = bias.reshape(-1)
    _require(bias.numel() == n, f"{key}: bias has {bias.numel()} values, want {n}")
    _check_bf16(f"{key} bias", bias)
    if scale_t is not None:
        _require(scale_t.dtype == torch.float32 and scale_t.is_contiguous()
                 and scale_t.numel() == m, f"{key}: s_a must be {m} contiguous fp32 values")
    res_f32 = 0
    if needs_res:
        _require(residual.shape == (m, n), f"{key}: residual must be {(m, n)}")
        _require(residual.dtype in (torch.float32, torch.bfloat16),
                 f"{key}: residual must be fp32 or bf16")
        _require(residual.is_contiguous() and residual.data_ptr() % 16 == 0,
                 f"{key}: residual must be contiguous and 16-byte aligned")
        res_f32 = int(residual.dtype == torch.float32)
    if needs_mask:
        mask = _rows_mask(key, mask, m)
    out = torch.empty((m, n), dtype=_out_dtype(epilogue, out_dtype), device=a.device)
    err = _build.library("gemm_s8_epilogue")(
        a.data_ptr(), wt.data_ptr(), None if scale_t is None else scale_t.data_ptr(),
        0.0 if scale_t is not None else float(s_a), s_w.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if needs_res else None, mask.data_ptr() if needs_mask else None,
        out.data_ptr(), m, n, k,
        _EPILOGUES[epilogue], res_f32, _stream())
    _launched(key, err)
    return out


# ------------------------------------------------------------ layer compositions
#
# One composition of each Pallas body, bound twice: to the wrappers (the
# engine's path) and to the plain versions alone (``*_ref``, the reference
# a check holds the kernels against on the card).


def _attention_half(ops, x2, b, n, ln_s, ln_b, wqkv_q, sqkv, b_qkv, num_heads, eps, caps, kmask,
                    mask=None):
    """LN1 (times the row mask) -> quant -> qkv (bf16) -> attention (bf16)
    -> quant: the out-projection's input codes and scale."""
    qrows, gemm, attn_fn = ops
    d = x2.shape[-1]
    lq, ls = qrows(x2, caps[0] if caps else None, ln_s, ln_b, eps, mask=mask)
    qkv = gemm(lq, ls, wqkv_q, sqkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads, kmask=kmask).reshape(b * n, d)
    return qrows(attn, caps[1] if caps else None)


def _mlp_half(ops, y, ln_s, ln_b, w1_q, s1, b1, eps, caps, mask=None):
    """LN2 (times the row mask) -> quant -> fc1 + gelu (fp32 h) -> quant:
    fc2's input."""
    qrows, gemm, _ = ops
    lq, ls = qrows(y, caps[0] if caps else None, ln_s, ln_b, eps, mask=mask)
    h = gemm(lq, ls, w1_q, s1, b1, "gelu_f32")
    return qrows(h, caps[1] if caps else None)


def _q_layer(ops, x, kmask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s, ln2b,
             w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps, mask=None):
    _, gemm, _ = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    m = None if mask is None else mask.reshape(b * n)
    acaps, mcaps = caps if caps else (None, None)
    aq, as_ = _attention_half(ops, x2, b, n, ln1s, ln1b, wqkv_q, sqkv, b_qkv, num_heads, eps,
                              acaps, kmask, m)
    # the fp32 mid residual y, the projection masked before the add
    y = gemm(aq, as_, wo_q, so, b_out, "residual_f32" if m is None else "masked_residual_f32",
             residual=x2, mask=m)
    hq, hs = _mlp_half(ops, y, ln2s, ln2b, w1_q, s1, b1, eps, mcaps, m)
    return gemm(hq, hs, w2_q, s2, b2, "residual", residual=y, out_dtype=x.dtype).reshape(b, n, d)


def _q_attention(ops, x, ln_s, ln_b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, num_heads, eps, caps,
                 mask=None):
    _, gemm, _ = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    m = None if mask is None else mask.reshape(b * n)
    aq, as_ = _attention_half(ops, x2, b, n, ln_s, ln_b, wqkv_q, sqkv, b_qkv, num_heads, eps,
                              caps, None, m)
    return gemm(aq, as_, wo_q, so, b_out, "residual" if m is None else "masked_residual",
                residual=x2, out_dtype=x.dtype, mask=m).reshape(b, n, d)


def _q_mlp(ops, x, ln_s, ln_b, w1_q, s1, b1, w2_q, s2, b2, eps, caps, mask=None):
    _, gemm, _ = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    hq, hs = _mlp_half(ops, x2, ln_s, ln_b, w1_q, s1, b1, eps, caps,
                       None if mask is None else mask.reshape(b * n))
    # the residual stays unmasked (Pallas _q_masked_mlp_kernel)
    return gemm(hq, hs, w2_q, s2, b2, "residual", residual=x2, out_dtype=x.dtype).reshape(b, n, d)


_KERNELS = (quant_rows, gemm_s8_epilogue, attn_scores_pv)
_PLAIN = (quant_rows_ref, gemm_s8_epilogue_ref, attn_scores_pv_ref)


def _quant_experts(ops, x, wq, sw, b) -> list:
    qrows, gemm, _ = ops
    lead, k = x.shape[:-1], x.shape[-1]
    codes, scale = qrows(x.reshape(-1, k).contiguous())
    return [gemm(codes, scale, wq[e], sw[e], b[e], "bias_f32").reshape(*lead, -1)
            for e in range(wq.shape[0])]


def quant_experts(x, wq, sw, b) -> list:
    """The int8 (w8a8) linear of each expert of an MoE sublayer on the same
    input (JAX ``_quant_linear_xla``, quant_blocks.py:89-102, per expert,
    with dynamic scales): x (..., K) bf16 or fp32 is quantized per row
    once (``quant_rows``: the codes JAX's per-expert re-quantization
    gives), then each expert e returns float(q8(x) @ wq[e]) * s_x *
    sw[e] + b[e] in fp32, unrounded (GEMM s8 ``bias_f32``). wq: (E, K, N)
    int8 (``quantize_linear`` per expert), sw (E, 1, N) fp32, b (E, N).
    Returns the E outputs (..., N) as a list. 1 + E launches on CUDA."""
    return _quant_experts(_KERNELS, x, wq, sw, b)


def quant_experts_ref(x, wq, sw, b) -> list:
    """Plain version of :func:`quant_experts`."""
    return _quant_experts(_PLAIN, x, wq, sw, b)


def quant_layer_block(x, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s, ln2b, w1_q, s1,
                      b1, w2_q, s2, b2, num_heads: int, eps: float = 1e-5,
                      caps=None) -> torch.Tensor:
    """The merged int8 layer (Pallas ``quant_layer_block``, :465:
    ``_q_layer_kernel`` mode ``plain``). x: (B, N, D); int8 weights (in,
    out) from :func:`quantize_linear` with their (1, out) fp32 scales; LN
    affines and biases in x's dtype. ``caps``: None (dynamic scales) or
    ((attn_ln, attn_out), (mlp_ln, mlp_h)) static caps. Nine launches on
    CUDA: 4 ``quant_rows``, GEMMs ``bias``, ``residual_f32``,
    ``gelu_f32``, ``residual``, and ``attn_scores_pv``."""
    return _q_layer(_KERNELS, x, None, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s,
                    ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps)


def quant_layer_block_ref(x, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s, ln2b, w1_q,
                          s1, b1, w2_q, s2, b2, num_heads: int, eps: float = 1e-5,
                          caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_layer_block`."""
    return _q_layer(_PLAIN, x, None, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s,
                    ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps)


def quant_keymasked_layer_block(x, key_mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                                ln2s, ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads: int,
                                eps: float = 1e-5, caps=None) -> torch.Tensor:
    """:func:`quant_layer_block` with key exclusion (Pallas
    ``quant_keymasked_layer_block``, :496: mode ``keymasked``). key_mask:
    (B, 1, N) in x's dtype, 1 = attend, 0 = exclude; the attention's
    ``kmask`` selects an excluded key's term to 0 and scrubs non-finite
    values of v, so garbage in excluded rows stays inert. Nine launches on
    CUDA, the attention's ``attn_scores_pv.kmask``."""
    return _q_layer(_KERNELS, x, key_mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                    ln2s, ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps)


def quant_keymasked_layer_block_ref(x, key_mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so,
                                    b_out, ln2s, ln2b, w1_q, s1, b1, w2_q, s2, b2,
                                    num_heads: int, eps: float = 1e-5,
                                    caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_keymasked_layer_block`."""
    return _q_layer(_PLAIN, x, key_mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                    ln2s, ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps)


def quant_attention_block(x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                          num_heads: int, eps: float = 1e-5, caps=None) -> torch.Tensor:
    """int8 x + OutProj(MHSA(LN(x))), rounded to x's dtype (Pallas
    ``quant_attention_block``, :199, body ``_q_attn_kernel`` :145).
    ``caps``: None or (ln_cap, attn_cap). Five launches on CUDA:
    ``quant_rows.ln``, GEMM ``bias``, ``attn_scores_pv``, ``quant_rows``,
    GEMM ``residual``."""
    return _q_attention(_KERNELS, x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                        num_heads, eps, caps)


def quant_attention_block_ref(x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                              num_heads: int, eps: float = 1e-5, caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_attention_block`."""
    return _q_attention(_PLAIN, x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                        num_heads, eps, caps)


def quant_mlp_block(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps: float = 1e-5,
                    caps=None) -> torch.Tensor:
    """int8 x + fc2(gelu(fc1(LN(x)))), h fp32, rounded to x's dtype
    (Pallas ``quant_mlp_block``, :224, body ``_q_mlp_kernel`` :177).
    ``caps``: None or (ln_cap, gelu_cap). Four launches on CUDA:
    ``quant_rows.ln``, GEMM ``gelu_f32``, ``quant_rows.f32``, GEMM
    ``residual``."""
    return _q_mlp(_KERNELS, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps, caps)


def quant_mlp_block_ref(x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps: float = 1e-5,
                        caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_mlp_block`."""
    return _q_mlp(_PLAIN, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps, caps)


def quant_masked_layer_block(x, mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s,
                             ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads: int,
                             eps: float = 1e-6, caps=None) -> torch.Tensor:
    """The merged int8 ResidualViT layer (Pallas ``quant_masked_layer_block``,
    :480: ``_q_layer_kernel`` mode ``masked``). x: (B, N, D); mask: (B, N,
    1) in x's dtype, continuous (the gate's relu(sig - thr)). mask * LN
    before each sublayer's quantization, the out-projection masked before
    the fp32 mid residual y = (attn Wo + bo) * mask + x, and an unmasked
    MLP output y + fc2(gelu(fc1(q8(mask * LN(y))))), rounded to x's dtype.
    ``caps`` as :func:`quant_layer_block`. Nine launches on CUDA: 2
    ``quant_rows.ln.*.masked``, ``quant_rows.bf16``, ``quant_rows.f32``,
    GEMMs ``bias``, ``masked_residual_f32``, ``gelu_f32``, ``residual``,
    and ``attn_scores_pv``."""
    return _q_layer(_KERNELS, x, None, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s,
                    ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps, mask)


def quant_masked_layer_block_ref(x, mask, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                                 ln2s, ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads: int,
                                 eps: float = 1e-6, caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_masked_layer_block`."""
    return _q_layer(_PLAIN, x, None, ln1s, ln1b, wqkv_q, sqkv, b_qkv, wo_q, so, b_out, ln2s,
                    ln2b, w1_q, s1, b1, w2_q, s2, b2, num_heads, eps, caps, mask)


def quant_masked_attention_block(x, mask, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so,
                                 b_out, num_heads: int, eps: float = 1e-6,
                                 caps=None) -> torch.Tensor:
    """int8 x + mask * OutProj(MHSA(q8(mask * LN(x)))), rounded to x's
    dtype (Pallas ``quant_masked_attention_block``, :311, body
    ``_q_masked_attn_kernel`` :246). mask: (B, N, 1); ``caps``: None or
    (ln_cap, attn_cap). Five launches on CUDA: ``quant_rows.ln.*.masked``,
    GEMM ``bias``, ``attn_scores_pv``, ``quant_rows``, GEMM
    ``masked_residual``."""
    return _q_attention(_KERNELS, x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                        num_heads, eps, caps, mask)


def quant_masked_attention_block_ref(x, mask, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so,
                                     b_out, num_heads: int, eps: float = 1e-6,
                                     caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_masked_attention_block`."""
    return _q_attention(_PLAIN, x, ln_scale, ln_bias, wqkv_q, sqkv, b_qkv, wo_q, so, b_out,
                        num_heads, eps, caps, mask)


def quant_masked_mlp_block(x, mask, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                           eps: float = 1e-6, caps=None) -> torch.Tensor:
    """int8 x + fc2(gelu(fc1(q8(mask * LN(x))))), h fp32, the residual
    unmasked, rounded to x's dtype (Pallas ``quant_masked_mlp_block``,
    :337, body ``_q_masked_mlp_kernel`` :282). ``caps``: None or (ln_cap,
    gelu_cap). Four launches on CUDA: ``quant_rows.ln.*.masked``, GEMM
    ``gelu_f32``, ``quant_rows.f32``, GEMM ``residual``."""
    return _q_mlp(_KERNELS, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps, caps, mask)


def quant_masked_mlp_block_ref(x, mask, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2,
                               eps: float = 1e-6, caps=None) -> torch.Tensor:
    """Plain version of :func:`quant_masked_mlp_block`."""
    return _q_mlp(_PLAIN, x, ln_scale, ln_bias, w1_q, s1, b1, w2_q, s2, b2, eps, caps, mask)
