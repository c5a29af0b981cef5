"""The trainable attention sublayer: an autograd Function over CUDA kernels
(counterpart of the unmasked half of
peekvit_tpu/ops/pallas/fused_attention_vjp.py:29-394).

``attention_block_trainable`` is x + OutProj(MHSA(LN(x))) with the Pallas
numerics: two-pass LN with affine rounded to the compute dtype, qkv
rounded, max-subtracted fp32 softmax normalised *before* the PV product
and rounded to bf16 there, the out-projection summed with its bias and x
in fp32 and rounded once. The Pallas forward and backward kernels each
run a whole image in one call; on Hopper each becomes a short chain of
launches (``peekvit_torch/csrc``)::

    forward:  ln_rows -> gemm(+bias) -> attn_softmax_fwd -> gemm(+bias+x)
    backward: ln_rows -> gemm_nt(g Wo^T) -> attn_softmax_bwd
              -> gemm_nt(dqkv Wqkv^T, fp32) -> ln_bwd_rows

Nine launches per layer on the default (``save_qkv=True``) path. With
``save_qkv=False`` (the recompute path, ``_attn_bwd_kernel``) the backward
also recomputes qkv with one more gemm(+bias) launch. The weight-gradient
products, bias sums and the sum of the LN partials stay plain torch, as
the JAX package leaves them to XLA (:334-348, :382-390); the fp32 dWo
product assumes TF32 is off for fp32 matmuls (PyTorch's default).

The Pallas ``images_per_cell`` (``mi``) is a TPU grid knob: how many images
one grid step holds in VMEM. Only the order in which the per-cell LN
partials are summed depends on it, so the port drops it; the LN partials
here are per block of 64 rows.

Dispatch follows ops/cuda/fused_attention.py: a wrapper runs its plain
version (``*_ref``) for CPU tensors and launches its kernel (or raises)
for CUDA tensors. ``attention_block_trainable_ref`` is the same Function
bound to the plain versions alone, whatever the device: the reference a
check holds the kernels against on the card. Launches count into
``fused_attention.LAUNCHES``.
"""

from __future__ import annotations

import torch

from peekvit_torch.ops.cuda import _build
from peekvit_torch.ops.cuda.fused_attention import (
    _check_bf16,
    _launched,
    _on_cpu,
    _require,
    _stream,
    gemm_bias_epilogue,
    gemm_bias_epilogue_ref,
    gemm_nt,
    gemm_nt_ref,
    ln_rows,
    ln_rows_ref,
)

HEAD_DIM = 64
MAX_TOKENS_FWD = 768  # K and V of one head in shared memory
MAX_TOKENS_BWD = 384  # Q, K, V and dA of one head in shared memory
ROWS_PER_PARTIAL = 64  # ln_bwd_rows writes one LN-grad partial per 64 rows


def _ln_f32(x, gamma, beta, eps):
    """Two-pass LayerNorm in fp32: (xhat * gamma + beta, xhat, inv)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mu) * inv
    return xhat * gamma + beta, xhat, inv


def _ln_bwd(dln, xhat, inv, gamma):
    """LN backward for the data path (gamma/beta grads handled by caller)."""
    dxhat = dln * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * inv


def _split_heads(t: torch.Tensor, parts: int, num_heads: int) -> torch.Tensor:
    """(B, N, parts * D) -> (parts, B, H, N, hd), as fp32."""
    b, n, width = t.shape
    hd = width // parts // num_heads
    return t.float().reshape(b, n, parts, num_heads, hd).permute(2, 0, 3, 1, 4)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, H * hd)."""
    b, h, n, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, n, h * hd)


# ------------------------------------------------------------ attn_softmax_fwd


def attn_softmax_fwd_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`attn_softmax_fwd` (``_attn_fwd_kernel``
    :65-82, per image and head)."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, 3, num_heads)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    return _merge_heads(torch.matmul(s.to(dt).float(), v).to(dt))


def _check_qkv(key: str, qkv: torch.Tensor, num_heads: int, max_tokens: int):
    _check_bf16(f"{key} qkv", qkv)
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, f"{key}: qkv must be (B, N, 3D)")
    b, n, three_d = qkv.shape
    d = three_d // 3
    _require(d == num_heads * HEAD_DIM,
             f"{key}: the kernel is built for head dim {HEAD_DIM}, got D={d}, H={num_heads}")
    _require(n <= max_tokens, f"{key}: N={n} tokens exceed the kernel's {max_tokens}")
    return b, n, d


def attn_softmax_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5) v per image and head over packed qkv
    (B, N, 3D) -> (B, N, D), with the trainable block's numerics (max
    subtracted, normalised, rounded to bf16 before PV). On CUDA: bf16,
    head dim 64, N <= 768."""
    if _on_cpu(qkv):
        return attn_softmax_fwd_ref(qkv, num_heads)
    b, n, d = _check_qkv("attn_softmax_fwd", qkv, num_heads, MAX_TOKENS_FWD)
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=qkv.device)
    err = _build.library("attn_softmax_fwd")(
        qkv.data_ptr(), out.data_ptr(), b, n, d, num_heads, HEAD_DIM ** -0.5, _stream())
    _launched("attn_softmax_fwd", err)
    return out


# ------------------------------------------------------------ attn_softmax_bwd


def attn_softmax_bwd_ref(qkv: torch.Tensor, dattn: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`attn_softmax_bwd` (``_attn_bwd_kernel``
    :117-156, ``_attn_bwd_kernel_saved`` :202-236, per image and head)."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, 3, num_heads)
    da = _split_heads(dattn, 1, num_heads)[0]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(s.to(dt).float().transpose(-1, -2), da).to(dt)
    ds = torch.matmul(da, v.transpose(-1, -2))
    dz = s * (ds - (ds * s).sum(-1, keepdim=True))
    dzb = (dz * scale).to(dt).float()
    dq = torch.matmul(dzb, k).to(dt)
    dk = torch.matmul(dzb.transpose(-1, -2), q).to(dt)
    return torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)], dim=-1)


def attn_softmax_bwd(qkv: torch.Tensor, dattn: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dqkv (B, N, 3D) in qkv's packed layout from qkv and the attention
    output's cotangent dattn (B, N, D). On CUDA: bf16, head dim 64,
    N <= 384."""
    if _on_cpu(qkv, dattn):
        return attn_softmax_bwd_ref(qkv, dattn, num_heads)
    b, n, d = _check_qkv("attn_softmax_bwd", qkv, num_heads, MAX_TOKENS_BWD)
    _check_bf16("attn_softmax_bwd dattn", dattn)
    _require(dattn.shape == (b, n, d), f"attn_softmax_bwd: dattn must be {(b, n, d)}")
    dqkv = torch.empty((b, n, 3 * d), dtype=torch.bfloat16, device=qkv.device)
    err = _build.library("attn_softmax_bwd")(
        qkv.data_ptr(), dattn.data_ptr(), dqkv.data_ptr(), b, n, d, num_heads,
        HEAD_DIM ** -0.5, _stream())
    _launched("attn_softmax_bwd", err)
    return dqkv


# ----------------------------------------------------------------- ln_bwd_rows


def ln_bwd_rows_ref(x, dln, g, gamma, eps: float):
    """Plain version of :func:`ln_bwd_rows`; its partials are the full
    column sums, shape (1, D)."""
    gf = gamma.float().reshape(-1)
    _, xhat, inv = _ln_f32(x, gf, 0.0, eps)
    dx = (_ln_bwd(dln, xhat, inv, gf) + g.float()).to(x.dtype)
    return dx, (dln * xhat).sum(0, keepdim=True), dln.sum(0, keepdim=True)


def ln_bwd_rows(x: torch.Tensor, dln: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                eps: float):
    """LN backward plus the residual cotangent, per row. x, g: (R, D);
    dln: (R, D) fp32; gamma: (D,). Returns dx (R, D) in x's dtype and the
    fp32 column partials of sum(dln * xhat) and sum(dln), (P, D) each, for
    the caller to sum over P. On CUDA: x, g, gamma bf16, D <= 1024."""
    if _on_cpu(x, dln, g, gamma):
        return ln_bwd_rows_ref(x, dln, g, gamma, eps)
    _require(x.dim() == 2 and dln.shape == x.shape and g.shape == x.shape,
             "ln_bwd_rows: x, dln and g must be the same (R, D)")
    rows, d = x.shape
    _require(d % 8 == 0 and d <= 1024, f"ln_bwd_rows: D={d} must be a multiple of 8, <= 1024")
    gamma = gamma.reshape(-1)
    _require(gamma.numel() == d, f"ln_bwd_rows: gamma must have {d} values")
    for name, t in (("x", x), ("g", g), ("gamma", gamma)):
        _check_bf16(f"ln_bwd_rows {name}", t)
    _require(dln.dtype == torch.float32 and dln.is_contiguous() and dln.data_ptr() % 16 == 0,
             "ln_bwd_rows: dln must be contiguous, 16-byte aligned fp32")
    dx = torch.empty_like(x)
    parts = -(-rows // ROWS_PER_PARTIAL)
    part_w = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    part_b = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    err = _build.library("ln_bwd_rows")(
        x.data_ptr(), dln.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
        part_w.data_ptr(), part_b.data_ptr(), rows, d, float(eps), _stream())
    _launched("ln_bwd_rows", err)
    return dx, part_w, part_b


# ------------------------------------------------------------- the sublayer


def _block_forward(ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, eps):
    ln_fn, gemm, _, attn_fwd, _, _ = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = ln_fn(x2, ln_scale, ln_bias, eps)
    qkv = gemm(ln, w_qkv, b_qkv, "bias").reshape(b, n, 3 * d)
    attn = attn_fwd(qkv, num_heads)
    out = gemm(attn.reshape(b * n, d), w_out, b_out, "residual", residual=x2)
    return out.reshape(b, n, d), attn, qkv


def _block_backward(ops, g, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, attn, qkv,
                    num_heads, eps):
    """dx and the six parameter grads; ``qkv=None`` recomputes it."""
    ln_fn, gemm, gemm_t, _, attn_bwd, ln_bwd = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    g2 = g.reshape(b * n, d).to(x.dtype).contiguous()
    ln = ln_fn(x2, ln_scale, ln_bias, eps)  # emitted (saved path) or recomputed
    if qkv is None:
        qkv = gemm(ln, w_qkv, b_qkv, "bias").reshape(b, n, 3 * d)
    dattn = gemm_t(g2, w_out, "none")
    dqkv = attn_bwd(qkv, dattn.reshape(b, n, d), num_heads).reshape(b * n, 3 * d)
    dln = gemm_t(dqkv, w_qkv, "none_f32")
    dx, dlns_parts, dlnb_parts = ln_bwd(x2, dln, g2, ln_scale, eps)

    # Weight grads: plain torch (XLA's in the JAX package).
    gf = g2.float()
    d_wqkv = (ln.t() @ dqkv).to(w_qkv.dtype)
    d_bqkv = dqkv.float().sum(0).to(b_qkv.dtype)
    d_wout = (attn.reshape(b * n, d).float().t() @ gf).to(w_out.dtype)
    d_bout = gf.sum(0).to(w_out.dtype)
    d_lns = dlns_parts.sum(0).to(ln_scale.dtype)
    d_lnb = dlnb_parts.sum(0).to(ln_bias.dtype)
    return (dx.reshape(b, n, d), d_lns.reshape(ln_scale.shape), d_lnb.reshape(ln_bias.shape),
            d_wqkv, d_bqkv.reshape(b_qkv.shape), d_wout, d_bout)


class _AttentionBlock(torch.autograd.Function):
    """Forward saves (x, params, attn[, qkv]), as ``_trainable_fwd``; the
    backward is ``_trainable_bwd_saved`` with qkv, ``_trainable_bwd``
    (recompute) without."""

    @staticmethod
    def forward(ctx, ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, eps,
                save_qkv):
        x = x.contiguous()
        out, attn, qkv = _block_forward(ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                        num_heads, eps)
        ctx.ops, ctx.num_heads, ctx.eps = ops, num_heads, eps
        ctx.save_for_backward(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, attn,
                              qkv if save_qkv else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, attn, qkv = ctx.saved_tensors
        grads = _block_backward(ctx.ops, g, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, attn,
                                qkv, ctx.num_heads, ctx.eps)
        return (None, *grads, None, None, None)


_KERNELS = (ln_rows, gemm_bias_epilogue, gemm_nt, attn_softmax_fwd, attn_softmax_bwd,
            ln_bwd_rows)
_PLAIN = (ln_rows_ref, gemm_bias_epilogue_ref, gemm_nt_ref, attn_softmax_fwd_ref,
          attn_softmax_bwd_ref, ln_bwd_rows_ref)


def attention_block_trainable(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                              num_heads: int, eps: float = 1e-5,
                              save_qkv: bool = False) -> torch.Tensor:
    """Differentiable x + OutProj(MHSA(LN(x))), x: (B, N, D), kernels
    (D, 3D) and (D, D) in the (in, out) layout. ``save_qkv=True`` keeps the
    forward's (B, N, 3D) qkv for the backward instead of recomputing it.
    On CUDA every tensor is bf16."""
    return _AttentionBlock.apply(_KERNELS, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                 num_heads, eps, save_qkv)


def attention_block_trainable_ref(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                  num_heads: int, eps: float = 1e-5,
                                  save_qkv: bool = False) -> torch.Tensor:
    """:func:`attention_block_trainable` on the plain versions alone."""
    return _AttentionBlock.apply(_PLAIN, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                 num_heads, eps, save_qkv)
