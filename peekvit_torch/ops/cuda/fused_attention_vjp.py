"""The trainable attention sublayers: autograd Functions over CUDA kernels
(counterpart of peekvit_tpu/ops/pallas/fused_attention_vjp.py).

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

``masked_attention_block_trainable`` is the ResidualViT sublayer
x + m * OutProj(MHSA(m * LN(x))) with the row mask m a differentiable
operand (:397-786), at the same rounding points plus the mask's::

    forward:  ln_rows.masked -> gemm(+bias) -> attn_softmax_fwd
              -> gemm(* mask + x)
    backward: gemm(masked_rowdot) -> gemm_nt(dproj Wo^T) -> attn_softmax_bwd
              -> gemm_nt(dqkv Wqkv^T, fp32) -> ln_bwd_rows.masked

The forward saves s1 = bf16(m * LN(x)), so the backward re-runs no LN (the
Pallas kernels rebuild s1 bit for bit, :466 = :573). The mask cotangent
dm = sum(g * proj) + sum(ds1 * ln_f32) takes both terms from fp32 values:
proj = attn Wo + bo rebuilt in the first GEMM's epilogue (never stored),
ln_f32 = xhat * gamma + beta in the LN backward (never rounded). Nine
launches per layer, ten with ``save_qkv=False``.

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
    _rows_mask,
    _stream,
    fused_attention_ref,
    gemm_bias_epilogue,
    gemm_bias_epilogue_ref,
    gemm_masked_rowdot,
    gemm_masked_rowdot_ref,
    gemm_nt,
    gemm_nt_ref,
    ln_rows,
    ln_rows_ref,
    softmax_head_dim,
    softmax_key,
    softmax_route,
)

ROWS_PER_PARTIAL = 64  # ln_bwd_rows writes one LN-grad partial per 64 rows
LN_BWD_MAX_WIDTH = 1024  # ln_bwd_rows.cu holds a row in registers


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
    :65-82, per image and head): ``fused_attention_ref`` on qkv's parts."""
    d = qkv.shape[-1] // 3
    return fused_attention_ref(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads)


def _check_qkv(key: str, qkv: torch.Tensor, num_heads: int):
    """(b, n, d, head dim) of packed qkv after the softmax kernels' checks."""
    _check_bf16(f"{key} qkv", qkv)
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, f"{key}: qkv must be (B, N, 3D)")
    b, n, three_d = qkv.shape
    d = three_d // 3
    return b, n, d, softmax_head_dim(key, d, num_heads)


def attn_softmax_fwd(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T * hd^-0.5) v per image and head over packed qkv
    (B, N, 3D) -> (B, N, D), with the trainable block's numerics (max
    subtracted, normalised, rounded to bf16 before PV). On CUDA: bf16,
    head dim 32 or 64, any N. Its C entry point chooses the kernel by
    shape (``fused_attention.softmax_route``): at head dim 64 the wgmma
    kernel up to 256 tokens, else the key-tiled kernel (counted as
    ``attn_softmax_fwd.tiled``)."""
    if _on_cpu(qkv):
        return attn_softmax_fwd_ref(qkv, num_heads)
    b, n, d, hd = _check_qkv("attn_softmax_fwd", qkv, num_heads)
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=qkv.device)
    base, step = qkv.data_ptr(), d * qkv.element_size()
    err = _build.library("attn_softmax_fwd")(
        base, base + step, base + 2 * step, out.data_ptr(), None, b, n, n, d, 3 * d, 3 * d,
        num_heads, hd ** -0.5, _stream())
    _launched(softmax_key("attn_softmax_fwd", hd, n), err)
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


def attn_softmax_bwd_route(n: int, head_dim: int = 64) -> str:
    """Which kernel :func:`attn_softmax_bwd` runs at ``n`` tokens on the
    card, chosen by shape inside its C entry point: ``"wgmma"`` (head dim
    64, n <= 256), ``"kept"`` (the earlier kernel, head dim 64, n <= 384)
    or ``"tiled"`` (the key-tiled pair). For the record; needs the built
    library."""
    return softmax_route(head_dim, n, backward=True)


def attn_softmax_bwd(qkv: torch.Tensor, dattn: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dqkv (B, N, 3D) in qkv's packed layout from qkv and the attention
    output's cotangent dattn (B, N, D). On CUDA: bf16, head dim 32 or 64,
    any N. Its C entry point chooses the kernel by shape
    (``fused_attention.softmax_route``): at head dim 64 the wgmma kernel up
    to 256 tokens and the kept kernel up to 384, else the key-tiled pair
    of launches (counted once, as ``attn_softmax_bwd.tiled``), which
    passes each row's -max * scale * log2(e), 1 / sum and D through a (3,
    B, H, N) fp32 workspace allocated here."""
    if _on_cpu(qkv, dattn):
        return attn_softmax_bwd_ref(qkv, dattn, num_heads)
    b, n, d, hd = _check_qkv("attn_softmax_bwd", qkv, num_heads)
    _check_bf16("attn_softmax_bwd dattn", dattn)
    _require(dattn.shape == (b, n, d), f"attn_softmax_bwd: dattn must be {(b, n, d)}")
    dqkv = torch.empty((b, n, 3 * d), dtype=torch.bfloat16, device=qkv.device)
    key = softmax_key("attn_softmax_bwd", hd, n, backward=True)
    ws = (torch.empty((3, b, num_heads, n), dtype=torch.float32, device=qkv.device)
          if key.endswith(".tiled") else None)
    err = _build.library("attn_softmax_bwd")(
        qkv.data_ptr(), dattn.data_ptr(), dqkv.data_ptr(), None if ws is None else ws.data_ptr(),
        b, n, d, num_heads, hd ** -0.5, _stream())
    _launched(key, err)
    return dqkv


# ----------------------------------------------------------------- ln_bwd_rows


def ln_bwd_rows_ref(x, dln, g, gamma, eps: float):
    """Plain version of :func:`ln_bwd_rows`; its partials are the full
    column sums, shape (1, D)."""
    gf = gamma.float().reshape(-1)
    _, xhat, inv = _ln_f32(x, gf, 0.0, eps)
    dx = (_ln_bwd(dln, xhat, inv, gf) + g.float()).to(x.dtype)
    return dx, (dln * xhat).sum(0, keepdim=True), dln.sum(0, keepdim=True)


def _check_ln_bwd(key, x, dln, g, gamma):
    """(rows, d, gamma as (D,), the two (P, D) fp32 partials) after the LN
    backward kernel's shared checks."""
    _require(x.dim() == 2 and dln.shape == x.shape and g.shape == x.shape,
             f"{key}: x, dln and g must be the same (R, D)")
    rows, d = x.shape
    _require(d % 8 == 0 and d <= LN_BWD_MAX_WIDTH,
             f"{key}: D={d} must be a multiple of 8, <= {LN_BWD_MAX_WIDTH}")
    gamma = gamma.reshape(-1)
    _require(gamma.numel() == d, f"{key}: gamma must have {d} values")
    _check_bf16(f"{key} gamma", gamma)
    for name, t in (("x", x), ("dln", dln), ("g", g)):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{key}: {name} must be contiguous and 16-byte aligned")
    _require(dln.dtype == torch.float32, f"{key}: dln must be fp32")
    parts = [torch.empty((-(-rows // ROWS_PER_PARTIAL), d), dtype=torch.float32,
                         device=x.device) for _ in range(2)]
    return rows, d, gamma, parts


def ln_bwd_rows(x: torch.Tensor, dln: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                eps: float):
    """LN backward plus the residual cotangent, per row. x, g: (R, D);
    dln: (R, D) fp32; gamma: (D,). Returns dx (R, D) in x's dtype and the
    fp32 column partials of sum(dln * xhat) and sum(dln), (P, D) each, for
    the caller to sum over P. On CUDA: x and gamma bf16, g bf16 or fp32
    (the merged layer's LN1 with the fp32 dy, ``ln_bwd_rows.g_f32``),
    D <= 1024."""
    if _on_cpu(x, dln, g, gamma):
        return ln_bwd_rows_ref(x, dln, g, gamma, eps)
    g_f32 = g.dtype == torch.float32
    key = "ln_bwd_rows.g_f32" if g_f32 else "ln_bwd_rows"
    rows, d, gamma, (part_w, part_b) = _check_ln_bwd(key, x, dln, g, gamma)
    _check_bf16(f"{key} x", x)
    if not g_f32:
        _check_bf16(f"{key} g", g)
    dx = torch.empty_like(x)
    err = _build.library("ln_bwd_rows")(
        x.data_ptr(), dln.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(), None,
        part_w.data_ptr(), part_b.data_ptr(), None, rows, d, float(eps), 2 if g_f32 else 0,
        None, None, None, 0, None, _stream())
    _launched(key, err)
    return dx, part_w, part_b


def ln_bwd_rows_f32_ref(y, dln, g, gamma, eps: float):
    """Plain version of :func:`ln_bwd_rows_f32`; its partials are the full
    column sums, shape (1, D)."""
    dy, part_w, part_b = ln_bwd_rows_ref(y, dln, g, gamma, eps)
    return dy, dy.to(g.dtype), part_w, part_b, dy.sum(0, keepdim=True)


def ln_bwd_rows_f32(y: torch.Tensor, dln: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                    eps: float):
    """The merged layer's LN2 backward (Pallas ``_layer_bwd_kernel``
    :206-208, :211, :215) on its fp32 mid residual y: dy = LN backward of
    dln + g in fp32, (R, D). Returns dy, dy rounded to g's dtype (the next
    GEMMs' operand), and the fp32 column partials of sum(dln * xhat),
    sum(dln) and sum(dy) (dbo), (P, D) each. y, dln: (R, D) fp32; g: (R,
    D); gamma: (D,). On CUDA g and gamma are bf16 (``ln_bwd_rows.f32``)."""
    if _on_cpu(y, dln, g, gamma):
        return ln_bwd_rows_f32_ref(y, dln, g, gamma, eps)
    key = "ln_bwd_rows.f32"
    rows, d, gamma, (part_w, part_b) = _check_ln_bwd(key, y, dln, g, gamma)
    _require(y.dtype == torch.float32, f"{key}: y must be fp32")
    _check_bf16(f"{key} g", g)
    dy = torch.empty_like(y)
    dy_b = torch.empty_like(g)
    part_dy = torch.empty_like(part_w)
    err = _build.library("ln_bwd_rows")(
        y.data_ptr(), dln.data_ptr(), g.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
        dy_b.data_ptr(), part_w.data_ptr(), part_b.data_ptr(), part_dy.data_ptr(), rows, d,
        float(eps), 1, None, None, None, 0, None, _stream())
    _launched(key, err)
    return dy, dy_b, part_w, part_b, part_dy


def ln_bwd_rows_masked_ref(x, ds1, g, gamma, beta, mask, rowdot, eps: float):
    """Plain version of :func:`ln_bwd_rows_masked`; its column partials are
    the full column sums, shape (1, D)."""
    gf = gamma.float().reshape(-1)
    ln, xhat, inv = _ln_f32(x, gf, beta.float().reshape(-1), eps)
    dm = (rowdot.sum(-1) + (ds1 * ln).sum(-1)).to(mask.dtype)
    dln = ds1 * mask.float().reshape(-1, 1)
    dx = (_ln_bwd(dln, xhat, inv, gf) + g.float()).to(x.dtype)
    return dx, dm, (dln * xhat).sum(0, keepdim=True), dln.sum(0, keepdim=True)


def ln_bwd_rows_masked(x: torch.Tensor, ds1: torch.Tensor, g: torch.Tensor,
                       gamma: torch.Tensor, beta: torch.Tensor, mask: torch.Tensor,
                       rowdot: torch.Tensor, eps: float):
    """The masked block's LN backward, per row (Pallas
    ``_masked_bwd_kernel``'s tail). x, g: (R, D); ds1 = dqkv Wqkv^T: (R, D)
    fp32; gamma, beta: (D,); mask: R values; rowdot: (R, P) fp32 partials
    of sum(g * proj) (``gemm_masked_rowdot``). With ln_f32 = xhat * gamma
    + beta in fp32, returns dx (R, D) in x's dtype, dm = sum(rowdot) +
    sum(ds1 * ln_f32) (R,) in the mask's dtype, and the fp32 column
    partials of sum(dln * xhat) and sum(dln), dln = ds1 * mask, (Q, D)
    each. On CUDA: x, g, gamma, beta, mask bf16, D <= 1024."""
    if _on_cpu(x, ds1, g, gamma, beta, mask, rowdot):
        return ln_bwd_rows_masked_ref(x, ds1, g, gamma, beta, mask, rowdot, eps)
    key = "ln_bwd_rows.masked"
    rows, d, gamma, (part_w, part_b) = _check_ln_bwd(key, x, ds1, g, gamma)
    beta = beta.reshape(-1)
    _require(beta.numel() == d, f"{key}: beta needs {d} values")
    for name, t in (("x", x), ("g", g), ("beta", beta)):
        _check_bf16(f"{key} {name}", t)
    mask = _rows_mask(key, mask, rows)
    _require(rowdot.dtype == torch.float32 and rowdot.dim() == 2 and rowdot.shape[0] == rows
             and rowdot.is_contiguous(), f"{key}: rowdot must be contiguous fp32 ({rows}, P)")
    dx = torch.empty_like(x)
    dm = torch.empty(rows, dtype=torch.bfloat16, device=x.device)
    err = _build.library("ln_bwd_rows")(
        x.data_ptr(), ds1.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(), None,
        part_w.data_ptr(), part_b.data_ptr(), None, rows, d, float(eps), 0, mask.data_ptr(),
        beta.data_ptr(), rowdot.data_ptr(), rowdot.shape[1], dm.data_ptr(), _stream())
    _launched(key, err)
    return dx, dm, part_w, part_b


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


# ------------------------------------------------- the masked (gated) sublayer


def _masked_forward(ops, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads,
                    eps):
    ln_fn, gemm, attn_fwd = ops[0], ops[1], ops[3]
    b, n, d = x.shape
    x2, m = x.reshape(b * n, d), mask.reshape(b * n)
    s1 = ln_fn(x2, ln_scale, ln_bias, eps, m)
    qkv = gemm(s1, w_qkv, b_qkv, "bias").reshape(b, n, 3 * d)
    attn = attn_fwd(qkv, num_heads)
    out = gemm(attn.reshape(b * n, d), w_out, b_out, "masked_residual", residual=x2, mask=m)
    return out.reshape(b, n, d), s1, attn, qkv


def _masked_backward(ops, g, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, s1, attn,
                     qkv, num_heads, eps):
    """dx, dmask and the six parameter grads; ``qkv=None`` recomputes it
    from the saved s1 (``_masked_bwd_kernel``'s recompute)."""
    _, gemm, gemm_t, _, attn_bwd, _, rowdot_gemm, ln_bwd = ops
    b, n, d = x.shape
    x2, m = x.reshape(b * n, d), mask.reshape(b * n)
    g2 = g.reshape(b * n, d).to(x.dtype).contiguous()
    attn2 = attn.reshape(b * n, d)
    if qkv is None:
        qkv = gemm(s1, w_qkv, b_qkv, "bias").reshape(b, n, 3 * d)
    dproj_c, rowdot = rowdot_gemm(attn2, w_out, b_out, g2, m)
    dattn = gemm_t(dproj_c, w_out, "none")
    dqkv = attn_bwd(qkv, dattn.reshape(b, n, d), num_heads).reshape(b * n, 3 * d)
    ds1 = gemm_t(dqkv, w_qkv, "none_f32")
    dx, dm, dlns_parts, dlnb_parts = ln_bwd(x2, ds1, g2, ln_scale, ln_bias, m, rowdot, eps)

    # Weight grads: plain torch (XLA's in the JAX package, :772-782). dWo
    # and dbo take the fp32 dproj = g * mask, not the bf16 copy the NT GEMM
    # read.
    dproj = g2.float() * m.float().reshape(-1, 1)
    d_wqkv = (s1.t() @ dqkv).to(w_qkv.dtype)
    d_bqkv = dqkv.float().sum(0).to(b_qkv.dtype)
    d_wout = (attn2.float().t() @ dproj).to(w_out.dtype)
    d_bout = dproj.sum(0).to(b_out.dtype)
    d_lns = dlns_parts.sum(0).to(ln_scale.dtype)
    d_lnb = dlnb_parts.sum(0).to(ln_bias.dtype)
    return (dx.reshape(b, n, d), dm.reshape(mask.shape).to(mask.dtype),
            d_lns.reshape(ln_scale.shape), d_lnb.reshape(ln_bias.shape), d_wqkv,
            d_bqkv.reshape(b_qkv.shape), d_wout, d_bout.reshape(b_out.shape))


class _MaskedAttentionBlock(torch.autograd.Function):
    """Forward saves (x, mask, params, s1, attn[, qkv]); the backward is
    ``_masked_trainable_bwd_saved`` with qkv, ``_masked_trainable_bwd``
    (recompute) without."""

    @staticmethod
    def forward(ctx, ops, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads,
                eps, save_qkv):
        x, mask = x.contiguous(), mask.contiguous()
        out, s1, attn, qkv = _masked_forward(ops, x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                                             w_out, b_out, num_heads, eps)
        ctx.ops, ctx.num_heads, ctx.eps = ops, num_heads, eps
        ctx.save_for_backward(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, s1, attn,
                              qkv if save_qkv else None)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = _masked_backward(ctx.ops, g, *ctx.saved_tensors, ctx.num_heads, ctx.eps)
        return (None, *grads, None, None, None)


_MASKED_KERNELS = _KERNELS + (gemm_masked_rowdot, ln_bwd_rows_masked)
_MASKED_PLAIN = _PLAIN + (gemm_masked_rowdot_ref, ln_bwd_rows_masked_ref)


def masked_attention_block_trainable(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                     num_heads: int, eps: float = 1e-6,
                                     save_qkv: bool = False) -> torch.Tensor:
    """Differentiable x + mask * OutProj(MHSA(mask * LN(x))), the
    ResidualViT attention sublayer with the mask (B, N, 1) a differentiable
    operand, so the gate gradients flow (Pallas
    ``masked_attention_block_trainable``, :661). Four launches forward
    (``ln_rows.masked``, GEMM ``bias``, ``attn_softmax_fwd``, GEMM
    ``masked_residual``) and five backward (GEMM ``masked_rowdot``, GEMM NT
    ``none``, ``attn_softmax_bwd``, GEMM NT ``none_f32``,
    ``ln_bwd_rows.masked``); ``save_qkv=False`` adds the qkv GEMM to the
    backward. dmask comes back in the mask's shape and dtype. On CUDA every
    tensor is bf16."""
    return _MaskedAttentionBlock.apply(_MASKED_KERNELS, x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_out, b_out, num_heads, eps, save_qkv)


def masked_attention_block_trainable_ref(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                                         num_heads: int, eps: float = 1e-6,
                                         save_qkv: bool = False) -> torch.Tensor:
    """:func:`masked_attention_block_trainable` on the plain versions alone."""
    return _MaskedAttentionBlock.apply(_MASKED_PLAIN, x, mask, ln_scale, ln_bias, w_qkv, b_qkv,
                                       w_out, b_out, num_heads, eps, save_qkv)
