"""Point Cloud Transformer (counterpart of peekvit_tpu/models/pct.py;
reference models/pct.py).

Contract, as the JAX module:

- ARPE embedding (pct.py:60-90): kNN among the points themselves (self
  included, k = int(32 * num_points / 512)) from the pairwise squared
  distances, [point, point - neighbour] concatenated, Linear -> BatchNorm
  -> elu, max-pool over the neighbours, Linear -> BatchNorm -> elu;
- pre-LN blocks (LayerNorm eps 1e-5), residuals after attention and MLP,
  no dropout on the residual adds (pct.py:78), attention dropout on the
  softmax weights (:89): the ViT block (``models/vit.ViTBlock``) at
  dropout 0;
- classifier: the MEAN over all tokens (class tokens exist as a parameter
  but are never prepended, a reference quirk kept for checkpoint parity),
  then Linear -> BatchNorm -> exact gelu -> Dropout(0.5) -> Linear.

``BatchNorm`` has flax's semantics, not ``nn.BatchNorm1d``'s: parameters
``scale`` and ``bias``, buffers ``mean`` and ``var`` (no
``num_batches_tracked``), statistics over every axis but the last, the
biased batch variance E[x^2] - E[x]^2 (clamped at 0), the running update
0.9 * old + 0.1 * batch, eps 1e-5. Its buffers are the JAX
``batch_stats`` collection; ``models.adapters.params_from_jax(model,
params, batch_stats)`` loads both.

Points are (B, N, 3). ``forward(x, train=False, generator=None)`` returns
``(logits, {})``; in train mode the batch statistics normalize and
update the buffers, and every dropout draws from ``generator``: the
tokens after the embedder at ``dropout`` (pct.py:146, :164), the blocks'
attention weights at ``attention_dropout``, the head's Dropout(0.5), in
that order (ops/dropout.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from peekvit_torch.models.residualvit import _dense
from peekvit_torch.models.vit import ViTBlock
from peekvit_torch.ops.dropout import dropout


def knn_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) nearest-neighbour indices, self included
    (pct.py:34): the top k of -d2, d2 = |a|^2 + |b|^2 - 2 a.b. The order
    among neighbours at an equal distance may differ from
    ``jax.lax.top_k``'s."""
    sq = (x * x).sum(-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.einsum("bnc,bmc->bnm", x, x)
    return torch.topk(-d2, k, dim=-1).indices


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last
    axis (module docstring)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            axes = tuple(range(x.dim() - 1))
            xf = x.float()
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class ARPE(nn.Module):
    """Absolute-Relative Position Encoding (pct.py:46)."""

    def __init__(self, out_channels: int, num_points: int, in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        c2 = 2 * in_channels
        self.num_points = num_points
        self.lin1 = _dense(c2, c2, generator)
        self.bn1 = BatchNorm(c2)
        self.lin2 = _dense(c2, out_channels, generator)
        self.bn2 = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, n, c = x.shape
        k = int(32 * self.num_points / 512)
        idx = knn_indices(x, k)                                    # (B, N, K)
        knn = x[torch.arange(b, device=x.device)[:, None, None], idx]  # (B, N, K, C)
        centre = x[:, :, None, :].expand(b, n, k, c)
        feats = torch.cat([centre, centre - knn], dim=-1)          # (B, N, K, 2C)
        h = self.bn1(self.lin1(feats).reshape(b * n, k, 2 * c), train)
        h = F.elu(h).amax(dim=1)                                   # max-pool over neighbours
        h = self.bn2(self.lin2(h.reshape(b, n, 2 * c)), train)
        return F.elu(h)


class ClassfHead(nn.Module):
    """Linear -> BatchNorm -> exact gelu -> Dropout(0.5) -> Linear
    (pct.py:95)."""

    def __init__(self, in_channels: int, n_classes: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin1 = _dense(in_channels, in_channels // 2, generator)
        self.bn1 = BatchNorm(in_channels // 2)
        self.lin2 = _dense(in_channels // 2, n_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        h = F.gelu(self.bn1(self.lin1(x), train), approximate="none")
        return self.lin2(dropout(h, 0.5, generator, train=train))


class _PointCloudBase(nn.Module):
    """The embedder, class tokens, registers and head the two PCT
    classifiers share; the blocks are the subclass's."""

    def __init__(self, num_points: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, dropout: float, attention_dropout: float, num_classes: int,
                 num_registers: int, num_class_tokens: int, generator, block_cls):
        super().__init__()
        self.num_points = num_points
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.num_classes = num_classes
        self.num_registers = num_registers
        self.num_class_tokens = num_class_tokens
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.embedder = ARPE(hidden_dim, num_points, generator=generator)
        # exists but unused, kept for checkpoint parity (reference pct.py:181, 218)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        if num_registers > 0:
            self.registers = nn.Parameter(torch.zeros(1, num_registers, hidden_dim))
        for i in range(num_layers):
            self.add_module(f"layers_{i}",
                            block_cls(num_heads, hidden_dim, mlp_dim, generator=generator,
                                      attention_dropout=attention_dropout))
        self.head = ClassfHead(hidden_dim, num_classes, generator)

    def embed(self, x: torch.Tensor, train: bool, generator) -> torch.Tensor:
        tokens = self.embedder(x, train)
        if self.num_registers > 0:
            regs = self.registers.expand(x.shape[0], -1, -1)
            tokens = torch.cat([regs, tokens], dim=1)
        return dropout(tokens, self.dropout, generator, train=train)


class PointCloudTransformer(_PointCloudBase):
    """PCT classifier over (B, num_points, 3) clouds (pct.py:110).
    Returns (logits, {})."""

    def __init__(self, num_points: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 40, representation_size: Optional[int] = None,
                 num_registers: int = 0, num_class_tokens: int = 1,
                 generator: torch.Generator | None = None):
        del representation_size  # constructor parity with the JAX module
        super().__init__(num_points, num_layers, num_heads, hidden_dim, mlp_dim, dropout,
                         attention_dropout, num_classes, num_registers, num_class_tokens,
                         generator, ViTBlock)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                noise_value=None) -> tuple[torch.Tensor, dict]:
        """``noise_value`` is taken and ignored, as JAX's (pct.py:155-157): a
        PCT has no NoiseBlock, and a ``noise_layer`` fails at construction."""
        del noise_value
        tokens = self.embed(x, train, generator)
        for i in range(self.num_layers):
            tokens = getattr(self, f"layers_{i}")(tokens, train=train, generator=generator)
        return self.head(tokens.mean(dim=1), train, generator), {}
