"""The merged trainable layer: autograd Functions over CUDA kernels
(counterpart of peekvit_tpu/ops/pallas/fused_layer_vjp.py, sites 10-11).

``layer_block_trainable`` is the whole pre-LN layer
y = x + OutProj(MHSA(LN1(x))), out = y + fc2(gelu(fc1(LN2(y)))) with the
Pallas numerics: two-pass LNs with affine (LN1 on the input, LN2 on the
fp32 y), qkv rounded, the max-subtracted softmax normalised and rounded
before PV, the fp32 mid residual y = attn Wo + bo + x, tanh-gelu, and one
rounding of out = h W2 + b2 + y. The Pallas forward and backward kernels
each run a whole image in one call; on Hopper each becomes a chain of
launches (``peekvit_torch/csrc``)::

    forward:  ln_rows -> gemm(+bias) -> attn_softmax_fwd -> gemm(+bias+x, fp32)
              -> ln_rows.f32 -> gemm(+bias, gelu) -> gemm(+bias+y)
    backward: the forward's first five again, gemm(gelu_hpre: h and the
              fp32 hpre), then
              MLP:  gemm_wgrad(h, g: dW2, db2) -> gemm_nt.gelu_grad(g W2^T:
                    dhpre, db1 partials) -> gemm_wgrad(ln2, dhpre: dW1)
                    -> gemm_nt.none_f32(dhpre W1^T) -> ln_bwd_rows.f32 (dy,
                    its bf16 copy, dLN2 and dbo partials)
              attn: gemm_wgrad(attn, dy: dWo) -> gemm_nt.none(dy Wo^T)
                    -> attn_softmax_bwd -> gemm_wgrad(ln1, dqkv: dWqkv,
                    dbqkv) -> gemm_nt.none_f32(dqkv Wqkv^T)
                    -> ln_bwd_rows.g_f32 (dx, dLN1 partials)

Seven launches forward and seventeen backward. As the Pallas VJP
(``_trainable_fwd`` :309) the forward saves only x and the weights: the
backward recomputes the layer, and the (B, N, M) fp32 hpre it needs for
gelu' lives only inside one backward. Every weight gradient is a
``gemm_wgrad`` product (the Pallas ``accum`` blocks, :189-263); every bias
sum is taken over the fp32 values the Pallas kernel sums: db2 and dbqkv
over the bf16 GEMM operands (``gemm_wgrad``'s column sums), db1 over the
unrounded dhpre (the ``gelu_grad`` epilogue's partials) and dbo over the
fp32 dy (``ln_bwd_rows.f32``'s partials). Only the sums over those (P, D)
partials are torch ``.sum(0)``, as JAX sums its (8, k) blocks outside the
kernel (``row0`` :365). Gradients come back in the weights' dtypes.

``layer_block_hybrid`` has the same forward; its backward is torch
autograd over :func:`_layer_plain`, the port of ``_layer_jnp`` (:397),
as JAX hands that backward to XLA.

The Pallas ``interpret`` and ``images_per_cell`` arguments are TPU grid
knobs and are dropped. Dispatch follows ops/cuda/fused_attention.py: a
wrapper runs its plain version (``*_ref``) for CPU tensors and launches
its kernel (or raises) for CUDA tensors; the ``*_ref`` Functions are
bound to the plain versions alone, whatever the device. Launches count
into ``fused_attention.LAUNCHES``; ``gemm_wgrad`` counts its product
under ``gemm_wgrad.<K>x<N>`` and the summing launch that follows a row
split under ``gemm_wgrad.<K>x<N>.reduce`` (C and its column sums in one),
so the seventeen backward calls are 21 kernel launches at ViT-B/16
width.

``sp_tail_block`` is Pallas site 12 (``sp_tail_block`` :576,
``_sp_tail_call`` :548): the sequence-parallel tail, everything of a
layer after its K/V gather. A rank's local rows x and queries q (B,
n_local, D) attend to the gathered k, v (B, n_full, D) under a per-image
key mask (B, n_full), then out = y + fc2(gelu(fc1(LN2(y)))) with the fp32
y = x + attn Wo + bo: ``_sp_tail_math``'s numerics (:478-531). The Pallas
forward runs one image per grid step; on Hopper it is five launches::

    attn_softmax_fwd.kmask -> gemm(+bias+x, fp32) -> ln_rows.f32
    -> gemm(+bias, gelu) -> gemm(+bias+y)

the masked, rectangular mode of ``attn_softmax_fwd.cu`` and then the last
four launches of ``layer_block_trainable``'s forward, unchanged. Its
backward is torch autograd over :func:`_sp_tail_plain`, the port of
``_sp_tail_math``'s batched form, as ``_sp_tail_bwd`` (:595) hands it to
XLA; kmask gets no gradient.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from peekvit_torch.ops.cuda import _build
from peekvit_torch.ops.cuda.fused_attention import (
    _check_b15,
    _check_bf16,
    _count,
    _launched,
    _on_cpu,
    _require,
    _stream,
    gemm_bias_epilogue,
    gemm_bias_epilogue_ref,
    gemm_gelu_hpre,
    gemm_gelu_hpre_ref,
    gemm_nt,
    gemm_nt_gelu_grad,
    gemm_nt_gelu_grad_ref,
    gemm_nt_ref,
    ln_rows,
    ln_rows_ref,
    softmax_head_dim,
    softmax_key,
)
from peekvit_torch.ops.cuda.fused_attention_vjp import (
    _ln_f32,
    attn_softmax_bwd,
    attn_softmax_bwd_ref,
    attn_softmax_fwd,
    attn_softmax_fwd_ref,
    ln_bwd_rows,
    ln_bwd_rows_f32,
    ln_bwd_rows_f32_ref,
    ln_bwd_rows_ref,
)

WGRAD_SMS = 132    # persistent CTAs: one on each of the H100's SMs
WGRAD_ROWS = 64    # rows per ring stage; a split is a whole number of stages
WGRAD_TILE_M = 128  # C rows per tile (A's columns)


class WgradPlan(NamedTuple):
    """gemm_wgrad's static schedule (see csrc/gemm_wgrad.cu). ``units``
    holds (tile, first stage, end stage, slot) in the order the persistent
    CTAs take them (CTA c: units c, c + grid, ...); tile = tm * tiles_n +
    tn; slot -1 writes C directly, else the unit's fp32 partial goes to
    slot k * len(red_tiles) + i for the k-th row split of red_tiles[i],
    summed in split order by one more launch when splits > 1."""
    bn: int
    tiles_m: int
    tiles_n: int
    stages: int
    units: tuple
    grid: int
    red_tiles: tuple
    splits: int


def wgrad_plan(rows: int, k: int, n: int, bn: int | None = None) -> WgradPlan:
    """The work units of gemm_wgrad for A (rows, k) and B (rows, n): whole
    waves of WGRAD_SMS C tiles over all the rows first, then the remaining
    tiles each cut into ``splits`` row runs of whole WGRAD_ROWS-row stages,
    ``splits`` the least count that makes their units fill whole waves of
    WGRAD_SMS (at most one run per stage), split-major so that a wave
    reads the same rows. C tiles are 128 x bn: bn 256 (half the L2 reads
    per product of bn 128) when it still gives a quarter of WGRAD_SMS
    tiles, else 128 (``scripts/wgrad_widths.py`` times both widths at the
    ViT-B/16 products; ``bn`` forces one)."""
    tiles_m = -(-k // WGRAD_TILE_M)
    if bn is None:
        bn = 256 if tiles_m * -(-n // 256) >= WGRAD_SMS // 4 else 128
    tiles_n = -(-n // bn)
    tiles = tiles_m * tiles_n
    stages = -(-rows // WGRAD_ROWS)
    whole = tiles // WGRAD_SMS * WGRAD_SMS
    rest = tiles - whole
    splits = WGRAD_SMS // math.gcd(rest, WGRAD_SMS) if rest else 1
    splits = max(1, min(splits, stages))
    if splits == 1:
        whole = tiles
    units = [(t, 0, stages, -1) for t in range(whole)]
    red = tuple(range(whole, tiles)) if splits > 1 else ()
    for k_split in range(splits if red else 0):
        lo, hi = k_split * stages // splits, (k_split + 1) * stages // splits
        units += [(t, lo, hi, k_split * len(red) + i) for i, t in enumerate(red)]
    return WgradPlan(bn, tiles_m, tiles_n, stages, tuple(units),
                     max(1, min(WGRAD_SMS, len(units))), red, splits)


_WGRAD_PLANS: dict = {}


def _wgrad_plan_on(device, rows: int, k: int, n: int, bn: int | None):
    """The plan and its int32 unit and tile tensors on ``device``, made
    once per shape."""
    key = (device, rows, k, n, bn)
    got = _WGRAD_PLANS.get(key)
    if got is None:
        plan = wgrad_plan(rows, k, n, bn)
        units = torch.tensor(plan.units or [(0, 0, 0, -1)], dtype=torch.int32, device=device)
        red = torch.tensor(plan.red_tiles or (0,), dtype=torch.int32, device=device)
        got = _WGRAD_PLANS[key] = (plan, units, red)
    return got


# ------------------------------------------------------------------ gemm_wgrad


def gemm_wgrad_ref(a, b, colsum: bool = False):
    """Plain version of :func:`gemm_wgrad`."""
    bf = b.float()
    return torch.matmul(a.float().t(), bf), (bf.sum(0) if colsum else None)


def gemm_wgrad(a: torch.Tensor, b: torch.Tensor, colsum: bool = False):
    """C = a^T @ b in fp32, the reduction over the rows (the merged layer's
    weight gradients, Pallas ``_layer_bwd_kernel``'s ``accum`` products).
    a: (R, K), b: (R, N). Returns C (K, N) fp32 and, with ``colsum``, the
    fp32 column sums of b (N,) (db2, dbqkv), else None. The rows are cut
    by :func:`wgrad_plan` and split partials summed by a second launch in
    a fixed order: reruns give the same bits. On CUDA a and b are bf16, K
    and N multiples of 8. Counted as ``gemm_wgrad.<K>x<N>``, and its
    summing launch as ``gemm_wgrad.<K>x<N>.reduce``."""
    if _on_cpu(a, b):
        return gemm_wgrad_ref(a, b, colsum)
    return _gemm_wgrad(a, b, colsum, None)


def _gemm_wgrad(a: torch.Tensor, b: torch.Tensor, colsum: bool, bn: int | None):
    """gemm_wgrad on CUDA tensors with the C tile width ``bn`` (None: the
    plan's rule)."""
    _require(a.dim() == 2 and b.dim() == 2 and a.shape[0] == b.shape[0],
             f"gemm_wgrad: a {tuple(a.shape)} and b {tuple(b.shape)} must share their rows")
    rows, k = a.shape
    n = b.shape[1]
    key = f"gemm_wgrad.{k}x{n}"
    _require(k % 8 == 0 and n % 8 == 0, f"{key}: K={k} and N={n} must be multiples of 8")
    _check_bf16(f"{key} a", a)
    _check_bf16(f"{key} b", b)
    plan, units, red = _wgrad_plan_on(a.device, rows, k, n, bn)
    c = torch.empty((k, n), dtype=torch.float32, device=a.device)
    sums = torch.empty(n, dtype=torch.float32, device=a.device) if colsum else None
    slots = plan.splits * len(plan.red_tiles) if plan.splits > 1 else 0
    work = (torch.empty(slots * (WGRAD_TILE_M + 1) * plan.bn, dtype=torch.float32,
                        device=a.device) if slots else None)
    ws = None if work is None else work.data_ptr()
    cs_ws = None if work is None else ws + slots * WGRAD_TILE_M * plan.bn * 4
    err = _build.library("gemm_wgrad")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), None if sums is None else sums.data_ptr(),
        ws, cs_ws, units.data_ptr(), len(plan.units), plan.grid, red.data_ptr(),
        len(plan.red_tiles), plan.splits, rows, k, n, plan.bn, _stream())
    _launched(key, err)
    if slots and rows:  # the summing pass over the split tiles
        _count(f"{key}.reduce")
    return c, sums


# ------------------------------------------------------------ the merged layer


class _Ops(NamedTuple):
    """The functions one merged layer calls: the kernel wrappers, or their
    plain versions."""
    ln: Callable
    gemm: Callable
    gemm_hpre: Callable
    gemm_t: Callable
    gemm_t_gelu: Callable
    wgrad: Callable
    attn_fwd: Callable
    attn_bwd: Callable
    ln_bwd: Callable
    ln_bwd_f32: Callable


def _layer_head(ops, x2, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, num_heads, eps,
                rows_shape):
    """LN1 -> qkv -> attention -> y (fp32) -> LN2, shared by the forward
    and the backward's recompute."""
    b, n, d = rows_shape
    ln1 = ops.ln(x2, lns1, lnb1, eps)
    qkv = ops.gemm(ln1, w_qkv, b_qkv, "bias").reshape(b, n, 3 * d)
    attn = ops.attn_fwd(qkv, num_heads).reshape(b * n, d)
    y = ops.gemm(attn, w_out, b_out, "residual_f32", residual=x2)
    ln2 = ops.ln(y, lns2, lnb2, eps, out_dtype=x2.dtype)
    return ln1, qkv, attn, y, ln2


def _layer_forward(ops, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                   num_heads, eps):
    x2 = x.reshape(-1, x.shape[-1])
    *_, y, ln2 = _layer_head(ops, x2, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2,
                             num_heads, eps, x.shape)
    h = ops.gemm(ln2, w1, b1, "gelu")
    return ops.gemm(h, w2, b2, "residual", residual=y).reshape(x.shape)


def _layer_backward(ops, g, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2,
                    b2, num_heads, eps):
    """dx and the twelve parameter grads (``_trainable_bwd`` :317)."""
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    g2 = g.reshape(b * n, d).to(x.dtype).contiguous()
    ln1, qkv, attn, y, ln2 = _layer_head(ops, x2, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2,
                                         lnb2, num_heads, eps, x.shape)
    h, hpre = ops.gemm_hpre(ln2, w1, b1)

    # MLP backward (out = h W2 + b2 + y)
    dw2, db2 = ops.wgrad(h, g2, colsum=True)
    del h
    dhpre, db1_parts = ops.gemm_t_gelu(g2, w2, hpre)
    del hpre
    dw1, _ = ops.wgrad(ln2, dhpre)
    dln2 = ops.gemm_t(dhpre, w1, "none_f32")
    del dhpre, ln2
    dy, dy_b, dlns2_parts, dlnb2_parts, dbo_parts = ops.ln_bwd_f32(y, dln2, g2, lns2, eps)
    del y, dln2

    # attention backward (y = attn Wo + bo + x) with cotangent dy
    dwo, _ = ops.wgrad(attn, dy_b)
    dattn = ops.gemm_t(dy_b, w_out, "none")
    del attn, dy_b
    dqkv = ops.attn_bwd(qkv, dattn.reshape(b, n, d), num_heads).reshape(b * n, 3 * d)
    del qkv, dattn
    dwqkv, dbqkv = ops.wgrad(ln1, dqkv, colsum=True)
    dln1 = ops.gemm_t(dqkv, w_qkv, "none_f32")
    del dqkv
    dx, dlns1_parts, dlnb1_parts = ops.ln_bwd(x2, dln1, dy, lns1, eps)

    def row0(parts, like):
        return parts.sum(0).to(like.dtype).reshape(like.shape)

    return (dx.reshape(b, n, d), row0(dlns1_parts, lns1), row0(dlnb1_parts, lnb1),
            dwqkv.to(w_qkv.dtype), dbqkv.to(b_qkv.dtype).reshape(b_qkv.shape),
            dwo.to(w_out.dtype), row0(dbo_parts, b_out), row0(dlns2_parts, lns2),
            row0(dlnb2_parts, lnb2), dw1.to(w1.dtype), row0(db1_parts, b1),
            dw2.to(w2.dtype), db2.to(b2.dtype).reshape(b2.shape))


def _layer_plain(x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                 num_heads, eps):
    """Differentiable torch replica of the layer (``_layer_jnp`` :397):
    fp32 LNs and residuals, matmuls in the operands' dtype, the qkv and
    the attention output rounded, the hybrid backward's recompute."""
    dt = x.dtype
    b, n, d = x.shape
    hd = d // num_heads
    ln1, _, _ = _ln_f32(x.reshape(b * n, d), lns1.float(), lnb1.float(), eps)
    qkv = ((ln1.reshape(b, n, d).to(dt) @ w_qkv).float() + b_qkv.float()).to(dt)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, num_heads, hd).transpose(1, 2)
               for i in range(3))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / hd ** 0.5)
    s = torch.softmax(logits, dim=-1)
    attn = torch.matmul(s.to(dt).float(), v.float()).to(dt).transpose(1, 2).reshape(b, n, d)
    y = (attn @ w_out).float() + b_out.float() + x.float()
    ln2, _, _ = _ln_f32(y.reshape(b * n, d), lns2.float(), lnb2.float(), eps)
    hpre = (ln2.reshape(b, n, d).to(dt) @ w1).float() + b1.float()
    h = F.gelu(hpre, approximate="tanh").to(dt)
    return ((h @ w2).float() + b2.float() + y).to(dt)


class _LayerBlock(torch.autograd.Function):
    """Forward saves x and the weights only (``_trainable_fwd`` :309). The
    backward is ``_trainable_bwd`` on the kernels, or with ``hybrid``
    torch autograd over :func:`_layer_plain` (``_hybrid_bwd`` :453)."""

    @staticmethod
    def forward(ctx, ops, hybrid, x, *rest):
        *params, num_heads, eps = rest
        x = x.contiguous()
        out = _layer_forward(ops, x, *params, num_heads, eps)
        ctx.ops, ctx.hybrid, ctx.num_heads, ctx.eps = ops, hybrid, num_heads, eps
        ctx.save_for_backward(x, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.hybrid:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in saved]
                out = _layer_plain(*leaves, ctx.num_heads, ctx.eps)
                grads = torch.autograd.grad(out, leaves, g)
        else:
            grads = _layer_backward(ctx.ops, g, *saved, ctx.num_heads, ctx.eps)
        return (None, None, *grads, None, None)


_KERNELS = _Ops(ln=ln_rows, gemm=gemm_bias_epilogue, gemm_hpre=gemm_gelu_hpre, gemm_t=gemm_nt,
                gemm_t_gelu=gemm_nt_gelu_grad, wgrad=gemm_wgrad, attn_fwd=attn_softmax_fwd,
                attn_bwd=attn_softmax_bwd, ln_bwd=ln_bwd_rows, ln_bwd_f32=ln_bwd_rows_f32)
_PLAIN = _Ops(ln=ln_rows_ref, gemm=gemm_bias_epilogue_ref, gemm_hpre=gemm_gelu_hpre_ref,
              gemm_t=gemm_nt_ref, gemm_t_gelu=gemm_nt_gelu_grad_ref, wgrad=gemm_wgrad_ref,
              attn_fwd=attn_softmax_fwd_ref, attn_bwd=attn_softmax_bwd_ref, ln_bwd=ln_bwd_rows_ref,
              ln_bwd_f32=ln_bwd_rows_f32_ref)


def layer_block_trainable(x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2,
                          b2, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable merged pre-LN layer (Pallas ``layer_block_trainable``,
    :297): y = x + OutProj(MHSA(LN1(x))); out = y + fc2(gelu(fc1(LN2(y)))).
    x: (B, N, D); kernels in the (in, out) layout, (D, 3D), (D, D), (D, M),
    (M, D). Seven launches forward, seventeen backward; the backward emits
    dx and all twelve parameter gradients. On CUDA every tensor is bf16,
    head dim 32 or 64, any N."""
    return _LayerBlock.apply(_KERNELS, False, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2,
                             lnb2, w1, b1, w2, b2, num_heads, eps)


def layer_block_trainable_ref(x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1,
                              w2, b2, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """:func:`layer_block_trainable` on the plain versions alone."""
    return _LayerBlock.apply(_PLAIN, False, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2,
                             lnb2, w1, b1, w2, b2, num_heads, eps)


def layer_block_hybrid(x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                       num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The merged forward of :func:`layer_block_trainable` with a torch
    autograd backward over the recomputed layer (Pallas
    ``layer_block_hybrid``, :434). Seven launches forward."""
    return _LayerBlock.apply(_KERNELS, True, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2,
                             lnb2, w1, b1, w2, b2, num_heads, eps)


def layer_block_hybrid_ref(x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2, lnb2, w1, b1, w2,
                           b2, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """:func:`layer_block_hybrid` with its forward on the plain versions."""
    return _LayerBlock.apply(_PLAIN, True, x, lns1, lnb1, w_qkv, b_qkv, w_out, b_out, lns2,
                             lnb2, w1, b1, w2, b2, num_heads, eps)


# ------------------------------------------------- the sequence-parallel tail


def attn_softmax_fwd_kmask_ref(q, k, v, kmask, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`attn_softmax_fwd_kmask` (``_sp_tail_math``
    :478-514, batched): fp32 logits times hd^-0.5, excluded keys at -inf,
    the max-subtracted softmax, P rounded to q's dtype before PV, PV in
    fp32 rounded to q's dtype. Differentiable."""
    dt = q.dtype
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = d // num_heads
    qh = q.float().reshape(b, nq, num_heads, hd).transpose(1, 2)
    kh, vh = (t.float().reshape(b, nk, num_heads, hd).transpose(1, 2) for t in (k, v))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / hd ** 0.5)
    logits = torch.where(kmask[:, None, None, :] > 0, logits, float("-inf"))
    s = torch.softmax(logits, dim=-1)
    out = torch.matmul(s.to(dt).float(), vh).to(dt)
    return out.transpose(1, 2).reshape(b, nq, d)


def _row_stride(key: str, name: str, t: torch.Tensor, d: int) -> int:
    """The row stride of a (B, n, D) bf16 operand whose rows may be a
    column slice of a wider buffer (q of the local qkv, k and v of the
    gathered kv)."""
    _require(t.dtype == torch.bfloat16, f"{key} {name}: the kernel takes bf16, got {t.dtype}")
    _require(t.dim() == 3 and t.shape[-1] == d, f"{key} {name}: must be (B, n, {d})")
    rs = t.stride(1)
    _require(t.stride(2) == 1 and t.stride(0) == t.shape[1] * rs and rs >= d and rs % 8 == 0,
             f"{key} {name}: rows must be dense slices of one buffer, strides {t.stride()}")
    _require(t.data_ptr() % 16 == 0, f"{key} {name}: must be 16-byte aligned")
    return rs


def attn_softmax_fwd_kmask(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kmask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The SP tail's attention: q (B, n_q, D) against k, v (B, n_k, D)
    under kmask (B, n_k), 1 = attend -> (B, n_q, D), the trainable block's
    softmax (max subtracted, normalised, rounded to bf16 before PV). q may
    be a column slice of a wider buffer (the local qkv) and k, v of another
    (the gathered kv); k and v share one row stride. A row needs one
    attended key. On CUDA: ``attn_softmax_fwd``'s masked mode, bf16, head
    dim 32 or 64, any n_k, kmask fp32; counted as
    ``attn_softmax_fwd.kmask``, or ``attn_softmax_fwd.kmask.tiled`` where
    the shape takes the key-tiled kernel (head dim 32, or past 256 keys)."""
    if _on_cpu(q, k, v, kmask):
        return attn_softmax_fwd_kmask_ref(q, k, v, kmask, num_heads)
    key = "attn_softmax_fwd.kmask"
    b, nq, d = q.shape
    nk = k.shape[1]
    hd = softmax_head_dim(key, d, num_heads)
    _require(k.shape == (b, nk, d) and v.shape == (b, nk, d),
             f"{key}: k and v must be {(b, nk, d)}")
    q_stride = _row_stride(key, "q", q, d)
    kv_stride = _row_stride(key, "k", k, d)
    _require(_row_stride(key, "v", v, d) == kv_stride, f"{key}: k and v must share a row stride")
    _require(kmask.dtype == torch.float32 and kmask.shape == (b, nk) and kmask.is_contiguous(),
             f"{key}: kmask must be a contiguous fp32 {(b, nk)}")
    out = torch.empty((b, nq, d), dtype=torch.bfloat16, device=q.device)
    err = _build.library("attn_softmax_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), kmask.data_ptr(), b, nq, nk,
        d, q_stride, kv_stride, num_heads, hd ** -0.5, _stream())
    _launched(softmax_key(key, hd, nk), err)
    return out


def _sp_tail_plain(x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2, b2, num_heads, eps):
    """Differentiable torch replica of the tail (``_sp_tail_math``
    batched, :499-531): the products take the operands in their dtype and
    sum in fp32, y and the residual sums in fp32, LN2 two-pass on y, then
    LN2, h and the output rounded to x's dtype. The backward's recompute."""
    dt = x.dtype
    d = x.shape[-1]
    attn = attn_softmax_fwd_kmask_ref(q, k, v, kmask, num_heads)
    y = torch.matmul(attn.float(), w_out.float()) + b_out.float().reshape(-1) + x.float()
    ln2, _, _ = _ln_f32(y.reshape(-1, d), lns2.float().reshape(-1), lnb2.float().reshape(-1), eps)
    ln2 = ln2.reshape(y.shape).to(dt)
    hpre = torch.matmul(ln2.float(), w1.float()) + b1.float().reshape(-1)
    h = F.gelu(hpre, approximate="tanh").to(dt)
    return (torch.matmul(h.float(), w2.float()) + b2.float().reshape(-1) + y).to(dt)


class _SpTail(torch.autograd.Function):
    """Forward: the five launches (``_sp_tail_call``), saving the inputs.
    Backward: torch autograd over :func:`_sp_tail_plain` (``_sp_tail_bwd``
    :595); no gradient for kmask."""

    @staticmethod
    def forward(ctx, ops, x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                num_heads, eps):
        ln, gemm, attn_fn = ops
        b, nq, d = x.shape
        x2 = x.contiguous().reshape(b * nq, d)
        attn = attn_fn(q, k, v, kmask, num_heads).reshape(b * nq, d)
        y = gemm(attn, w_out, b_out, "residual_f32", residual=x2)
        ln2 = ln(y, lns2, lnb2, eps, out_dtype=x.dtype)
        h = gemm(ln2, w1, b1, "gelu")
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2, b2)
        return gemm(h, w2, b2, "residual", residual=y).reshape(b, nq, d)

    @staticmethod
    def backward(ctx, g):
        x, q, k, v, kmask, *ws = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, q, k, v, *ws)]
            out = _sp_tail_plain(*leaves[:4], kmask, *leaves[4:], ctx.num_heads, ctx.eps)
            dx, dq, dk, dv, *dws = torch.autograd.grad(out, leaves, g)
        return (None, dx, dq, dk, dv, None, *dws, None, None)


_TAIL_KERNELS = (ln_rows, gemm_bias_epilogue, attn_softmax_fwd_kmask)
_TAIL_PLAIN = (ln_rows_ref, gemm_bias_epilogue_ref, attn_softmax_fwd_kmask_ref)


def sp_tail_block(x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                  num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Post-gather SP tail (Pallas ``sp_tail_block``, :576): out = y +
    MLP(LN2(y)), y = x + OutProj(Attn(q, k, v; kmask)). x, q: (B, n_local,
    D); k, v: (B, n_full, D); kmask: (B, n_full) fp32, 1 = attend. Weights
    in the (in, out) layout. Differentiable in every tensor but kmask. On
    the CPU the plain versions; on CUDA five kernel launches, every tensor
    bf16 but kmask (fp32 raises naming B15), head dim 32 or 64, any n_full."""
    if not _on_cpu(x, q, k, v, kmask):
        _check_b15("sp_tail_block", x)
    return _SpTail.apply(_TAIL_KERNELS, x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1,
                         w2, b2, num_heads, eps)


def sp_tail_block_ref(x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2, b2,
                      num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """:func:`sp_tail_block` on the plain versions alone, whatever the
    device: the reference the kernels are held against."""
    return _SpTail.apply(_TAIL_PLAIN, x, q, k, v, kmask, w_out, b_out, lns2, lnb2, w1, b1, w2,
                         b2, num_heads, eps)
