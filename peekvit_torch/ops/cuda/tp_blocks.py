"""Tensor-parallel partial sublayers (counterpart of
peekvit_tpu/ops/pallas/tp_blocks.py, Pallas sites 25-28).

Under tensor-parallel serving each rank of the mesh's model axis holds a
head slice of the attention weights and a column / row slice of the MLP
(the Megatron layout: column-parallel qkv and fc1, row-parallel
out-projection and fc2), runs these functions on the full token stream,
which every rank holds, and returns a PARTIAL sublayer output: the bare
fp32 product of its out-projection or fc2 slice, with no bias and no
residual. One all-reduce over the model axis completes each sublayer;
bias and residual are added once after it (``parallel/tp_serving.py``).

Each Pallas body is one VMEM-resident program per image block; here each
is a short chain of launches over the kernels the single-device layer
already uses, closed by the GEMM epilogue ``partial_f32``::

    tp_attention_partial (site 25)       norm_rows -> gemm(+bias) ->
                                         attn_scores_pv(local heads) -> gemm partial_f32
    tp_masked_attention_partial (26)     norm_rows.masked (affine, then mask) -> as 25
    tp_masked_mlp_partial (27)           norm_rows.masked -> gemm(+bias, gelu) -> gemm partial_f32
    tp_mlp_partial (28)                  norm_rows -> gemm(+bias, gelu) -> gemm partial_f32

Four, four, three and three launches. The norms are the Pallas
``_norm_rows`` one-pass statistics; the plain sites take the LN affine
folded into the qkv / fc1 slices, the masked sites apply it before the
row mask (a mask does not commute with a folded bias). A shard's
``[q_s | k_s | v_s]`` qkv block is the packed layout ``attn_scores_pv``
reads, at width dl = D / n_model over the shard's heads.

Each function has a plain version (``*_ref``) over the kernels' plain
versions; dispatch is by device, as every wrapper's: CPU tensors take
the plain versions, CUDA tensors the kernels.
"""

from __future__ import annotations

import torch

from peekvit_torch.ops.cuda.fused_attention import (
    attn_scores_pv,
    attn_scores_pv_ref,
    gemm_bias_epilogue,
    gemm_bias_epilogue_ref,
    gemm_partial_f32,
    gemm_partial_f32_ref,
    norm_rows,
    norm_rows_ref,
)

_KERNELS = (norm_rows, gemm_bias_epilogue, attn_scores_pv, gemm_partial_f32)
_PLAIN = (norm_rows_ref, gemm_bias_epilogue_ref, attn_scores_pv_ref, gemm_partial_f32_ref)


def _attention_partial(ops, x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, heads_local, eps):
    norm, gemm, attn_fn, partial = ops
    b, n, d = x.shape
    dl = wo.shape[0]
    x2 = x.reshape(b * n, d)
    ln = norm(x2, eps, x.dtype, ln_scale, ln_bias, None if mask is None else mask.reshape(b * n))
    qkv = gemm(ln, wqkv, bqkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * dl), heads_local).reshape(b * n, dl)
    return partial(attn, wo).reshape(b, n, d)


def _mlp_partial(ops, x, mask, ln_scale, ln_bias, w1, b1, w2, eps):
    norm, gemm, _, partial = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = norm(x2, eps, x.dtype, ln_scale, ln_bias, None if mask is None else mask.reshape(b * n))
    h = gemm(ln, w1, b1, "gelu")
    return partial(h, w2).reshape(b, n, d)


def tp_attention_partial(x, wqkv, bqkv, wo, heads_local: int, eps: float = 1e-5) -> torch.Tensor:
    """Site 25 (``tp_attention_partial``, :73): norm(x) @ wqkv + bqkv,
    rounded to x's dtype, local-head MHSA, @ wo -> fp32 (B, N, D), no bias
    and no residual. x: (B, N, D); wqkv: (D, 3·dl) folded-LN column slice
    ``[q_s | k_s | v_s]``; bqkv: (1, 3·dl); wo: (dl, D) row slice. Four
    launches on CUDA: ``norm_rows``, GEMM ``bias``, ``attn_scores_pv``,
    GEMM ``partial_f32``."""
    return _attention_partial(_KERNELS, x, None, None, None, wqkv, bqkv, wo, heads_local, eps)


def tp_attention_partial_ref(x, wqkv, bqkv, wo, heads_local: int,
                             eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`tp_attention_partial`."""
    return _attention_partial(_PLAIN, x, None, None, None, wqkv, bqkv, wo, heads_local, eps)


def tp_masked_attention_partial(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, heads_local: int,
                                eps: float = 1e-6) -> torch.Tensor:
    """Site 26 (``tp_masked_attention_partial``, :149): mask · (norm(x) ·
    ln_scale + ln_bias), rounded, then as :func:`tp_attention_partial`.
    mask: (B, N, 1) in x's dtype; ln_scale, ln_bias: (1, D) or (D,),
    unfolded. The caller applies ``(psum + b_out) * mask + x``. Four
    launches on CUDA, the norm ``norm_rows.masked``."""
    return _attention_partial(_KERNELS, x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, heads_local,
                              eps)


def tp_masked_attention_partial_ref(x, mask, ln_scale, ln_bias, wqkv, bqkv, wo,
                                    heads_local: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`tp_masked_attention_partial`."""
    return _attention_partial(_PLAIN, x, mask, ln_scale, ln_bias, wqkv, bqkv, wo, heads_local,
                              eps)


def tp_masked_mlp_partial(x, mask, ln_scale, ln_bias, w1, b1, w2,
                          eps: float = 1e-6) -> torch.Tensor:
    """Site 27 (``tp_masked_mlp_partial``, :211): mask · (norm(x) · ln_scale
    + ln_bias) @ w1 + b1, tanh-gelu, rounded, @ w2 -> fp32 (B, N, D). w1:
    (D, M/n) column slice; b1: (1, M/n); w2: (M/n, D) row slice. The
    output is not masked: the caller adds ``psum + b2 + x``. Three
    launches on CUDA: ``norm_rows.masked``, GEMM ``gelu``, GEMM
    ``partial_f32``."""
    return _mlp_partial(_KERNELS, x, mask, ln_scale, ln_bias, w1, b1, w2, eps)


def tp_masked_mlp_partial_ref(x, mask, ln_scale, ln_bias, w1, b1, w2,
                              eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`tp_masked_mlp_partial`."""
    return _mlp_partial(_PLAIN, x, mask, ln_scale, ln_bias, w1, b1, w2, eps)


def tp_mlp_partial(x, w1, b1, w2, eps: float = 1e-5) -> torch.Tensor:
    """Site 28 (``tp_mlp_partial``, :262): norm(x) @ w1 + b1 (LN folded),
    tanh-gelu, rounded, @ w2 -> fp32 (B, N, D). Three launches on CUDA:
    ``norm_rows``, GEMM ``gelu``, GEMM ``partial_f32``."""
    return _mlp_partial(_KERNELS, x, None, None, None, w1, b1, w2, eps)


def tp_mlp_partial_ref(x, w1, b1, w2, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`tp_mlp_partial`."""
    return _mlp_partial(_PLAIN, x, None, None, None, w1, b1, w2, eps)
