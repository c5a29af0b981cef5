"""Multi-head self-attention (counterpart of peekvit_tpu/ops/attention.py).

Numerically the torch ``nn.MultiheadAttention(batch_first=True)`` contract
the reference wraps: packed qkv projection, query scaled by 1/sqrt(head
dim), max-subtracted softmax over keys in fp32, output projection.
Parameters keep the JAX layout and names:

  in_proj_kernel  : (D, 3D)   in_proj_bias  : (3D,)
  out_proj_kernel : (D, D)    out_proj_bias : (D,)

This is the model's (linen-equivalent) attention; the inference engine's
kernel with the fast softmax lives in ops/cuda/fused_attention.py.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def qkv_projection(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """Packed qkv projection. x: (B, N, D) -> q, k, v each (B, N, D)."""
    d = x.shape[-1]
    qkv = torch.matmul(x, kernel) + bias
    return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int, *,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over heads. q/k/v: (B, N, D).
    key_mask: optional (B, N), 1 = attend, 0 = exclude. Returns (B, N, D)."""
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
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    return out.reshape(b, n, d)


def multi_head_attention(x: torch.Tensor, params: dict, num_heads: int, *,
                         key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full MHSA: packed qkv proj -> attention -> out proj. x: (B, N, D).
    params: {'in_proj': {'kernel', 'bias'}, 'out_proj': {'kernel', 'bias'}}."""
    q, k, v = qkv_projection(x, params["in_proj"]["kernel"], params["in_proj"]["bias"])
    out = attention_core(q, k, v, num_heads, key_mask=key_mask)
    return torch.matmul(out, params["out_proj"]["kernel"]) + params["out_proj"]["bias"]


class SelfAttention(nn.Module):
    """MHSA module with the JAX parameter names. Init: xavier-uniform
    kernels, zero biases (the torch nn.MultiheadAttention init)."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.in_proj_kernel = nn.Parameter(torch.empty(d, 3 * d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj_kernel = nn.Parameter(torch.empty(d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(d))
        nn.init.xavier_uniform_(self.in_proj_kernel, generator=generator)
        nn.init.xavier_uniform_(self.out_proj_kernel, generator=generator)

    def forward(self, x: torch.Tensor, *,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(
            x,
            {"in_proj": {"kernel": self.in_proj_kernel, "bias": self.in_proj_bias},
             "out_proj": {"kernel": self.out_proj_kernel, "bias": self.out_proj_bias}},
            self.num_heads, key_mask=key_mask)
