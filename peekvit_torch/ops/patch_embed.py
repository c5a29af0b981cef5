"""Patch embedding as a reshaped matmul (counterpart of
peekvit_tpu/ops/patch_embed.py).

A stride-P conv with a PxP kernel over non-overlapping patches is a matmul
of flattened patches with the flattened kernel. Images are NHWC and patch
rows are in (row, col, channel) order, the JAX package's layout, so both
packages hold the same (P*P*C, D) kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def extract_patches(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C), N = (H/P)*(W/P), pixel order
    (row, col, channel) within the patch."""
    b, h, w, c = x.shape
    p = patch_size
    nh, nw = h // p, w // p
    x = x.reshape(b, nh, p, nw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, p * p * c)


def patch_embed(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                patch_size: int) -> torch.Tensor:
    """x: (B, H, W, C); kernel: (P*P*C, D); bias: (D,). Returns (B, N, D)."""
    return torch.matmul(extract_patches(x, patch_size), kernel) + bias


class PatchEmbed(nn.Module):
    """Conv patch-embed as a matmul. Init as the JAX module (reference
    models/vit.py:191-194): truncated normal (at two standard deviations)
    with std sqrt(1/fan_in), fan_in = C*P*P; zero bias."""

    def __init__(self, hidden_dim: int, patch_size: int, in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.patch_size = patch_size
        fan_in = in_channels * patch_size * patch_size
        std = math.sqrt(1.0 / fan_in)
        self.kernel = nn.Parameter(torch.empty(fan_in, hidden_dim))
        nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.bias = nn.Parameter(torch.zeros(hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return patch_embed(x, self.kernel, self.bias, self.patch_size)
