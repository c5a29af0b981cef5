"""Multi-head self-attention (counterpart of peekvit_tpu/ops/attention.py).

Numerically the torch ``nn.MultiheadAttention(batch_first=True)`` contract
the reference wraps: packed qkv projection, query scaled by 1/sqrt(head
dim), max-subtracted softmax over keys in fp32, output projection.
Parameters keep the JAX layout and names:

  in_proj_kernel  : (D, 3D)   in_proj_bias  : (3D,)
  out_proj_kernel : (D, D)    out_proj_bias : (D,)

This is the model's (linen-equivalent) attention; the inference engine's
kernel with the fast softmax lives in ops/cuda/fused_attention.py.

:func:`set_attention_impl` ("xla", the default, or "pallas", JAX's names)
chooses between two numerics for every module forward at once, as the
JAX package's switch does: under "pallas" a deterministic forward without
a key mask runs the attention core through ``fused_mhsa`` (the fast
clamped exp2 softmax; ``attn_scores_pv`` on the card). That kernel has no
backward, so a CUDA forward under "pallas" whose qkv needs a gradient
raises; ``SelfAttention`` is deterministic exactly when the module is in
eval mode and its forward is not a train forward.

Attention dropout (``SelfAttention(dropout=rate)``, JAX's
``attention_core`` at ops/attention.py:84-86): in a train forward at a
nonzero rate the softmax weights (fp32, cast to the compute dtype) go
through ``ops/dropout.dropout`` before the PV product, always on this
explicit-softmax form: never SDPA's ``dropout_p`` (its draws cannot be
fed) and never ``fused_mhsa``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from peekvit_torch.ops.cuda.fused_attention import fused_mhsa
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.fake_quant import maybe_fq

# Global switch: "xla" (the module's own attention, default) or "pallas"
# (the fused kernel, deterministic forwards only).
_ATTENTION_IMPL = "xla"


def set_attention_impl(name: str) -> None:
    global _ATTENTION_IMPL
    if name not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl {name!r}")
    _ATTENTION_IMPL = name


def get_attention_impl() -> str:
    return _ATTENTION_IMPL


def qkv_projection(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """Packed qkv projection. x: (B, N, D) -> q, k, v each (B, N, D)."""
    d = x.shape[-1]
    qkv = torch.matmul(x, kernel) + bias
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, *,
                   key_mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None,
                   head_shard: Optional[tuple] = None) -> torch.Tensor:
    """Scaled dot-product attention over heads. q/k/v: (B, N, D).
    key_mask: optional (B, N), 1 = attend, 0 = exclude. A nonzero
    ``dropout_rate`` in a non-deterministic call drops softmax weights
    (B, H, N, N), drawn from ``generator``; ``head_shard=(n, index)``: these
    are head group ``index`` of ``n`` (a tensor-parallel rank's), and the
    mask is drawn over every head. Returns (B, N, D)."""
    b, n, d = q.shape
    hd = d // num_heads
    q = q.reshape(b, n, num_heads, hd)
    k = k.reshape(b, k.shape[1], num_heads, hd)
    v = v.reshape(b, v.shape[1], num_heads, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        neg = torch.finfo(torch.float32).min
        logits = torch.where(key_mask[:, None, None, :] > 0, logits,
                             torch.full_like(logits, neg))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    weights = dropout(weights, dropout_rate, generator, train=not deterministic,
                      shard=None if head_shard is None else (1,) + tuple(head_shard))
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.reshape(b, n, d)


def multi_head_attention(x: torch.Tensor, params: dict, num_heads: int, *,
                         key_mask: Optional[torch.Tensor] = None,
                         deterministic: bool = True, dropout_rate: float = 0.0,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full MHSA: packed qkv proj -> attention -> out proj. x: (B, N, D).
    params: {'in_proj': {'kernel', 'bias'}, 'out_proj': {'kernel', 'bias'}}.
    Under ``set_attention_impl("pallas")`` a deterministic call without a
    key mask takes ``fused_mhsa`` (JAX ops/attention.py:114-119); a
    non-deterministic call drops attention weights at ``dropout_rate``,
    drawn from ``generator`` (``attention_core``). The qkv
    and out-proj matmuls are QAT sites (``ops/fake_quant.maybe_fq``) in
    both branches, identity unless a ``fake_quant`` block is open."""
    xq, wq = maybe_fq(x, params["in_proj"]["kernel"], site="qkv")
    if _ATTENTION_IMPL == "pallas" and key_mask is None and deterministic:
        qkv = torch.matmul(xq, wq) + params["in_proj"]["bias"]
        if qkv.is_cuda and qkv.requires_grad:
            raise RuntimeError(
                "attention impl 'pallas': the fused kernel has no backward; run the forward "
                "under torch.no_grad() / inference_mode, or train with impl 'xla'")
        out = fused_mhsa(qkv, num_heads)
    else:
        q, k, v = qkv_projection(xq, wq, params["in_proj"]["bias"])
        out = attention_core(q, k, v, num_heads, key_mask=key_mask, dropout_rate=dropout_rate,
                             deterministic=deterministic, generator=generator)
    oq, wo = maybe_fq(out, params["out_proj"]["kernel"], site="out")
    return torch.matmul(oq, wo) + params["out_proj"]["bias"]


class SelfAttention(nn.Module):
    """MHSA module with the JAX parameter names. Init: xavier-uniform
    kernels, zero biases (the torch nn.MultiheadAttention init).
    ``dropout``: the attention-weight dropout rate of a train forward."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 generator: torch.Generator | None = None, dropout: float = 0.0):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_kernel = nn.Parameter(torch.empty(d, 3 * d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj_kernel = nn.Parameter(torch.empty(d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(d))
        nn.init.xavier_uniform_(self.in_proj_kernel, generator=generator)
        nn.init.xavier_uniform_(self.out_proj_kernel, generator=generator)

    def forward(self, x: torch.Tensor, *, key_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        return multi_head_attention(
            x,
            {"in_proj": {"kernel": self.in_proj_kernel, "bias": self.in_proj_bias},
             "out_proj": {"kernel": self.out_proj_kernel, "bias": self.out_proj_bias}},
            self.num_heads, key_mask=key_mask, deterministic=not (self.training or train),
            dropout_rate=self.dropout if train else 0.0, generator=generator)
