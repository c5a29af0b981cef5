"""ViT MLP: fc1 -> exact (erf) GELU -> fc2, no internal dropout
(counterpart of peekvit_tpu/ops/mlp.py; reference models/blocks.py:74-84).

This is the model's MLP. The inference kernel's MLP uses tanh-gelu
(ops/cuda/fused_attention.py), as the Pallas kernel does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from peekvit_torch.ops.fake_quant import maybe_fq

# lecun_normal: truncated normal at two standard deviations, rescaled so
# the variance is 1/fan_in (the stddev of a unit normal truncated there).
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """JAX's lecun_normal for an (in, out) kernel: fan_in = t.shape[0]."""
    std = math.sqrt(1.0 / t.shape[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)


def mlp_forward(x: torch.Tensor, params: dict) -> torch.Tensor:
    """params: {'fc1': {'kernel', 'bias'}, 'fc2': {'kernel', 'bias'}}. Both
    matmuls are QAT sites (``ops/fake_quant.maybe_fq``), identity unless a
    ``fake_quant`` block is open."""
    x1, w1 = maybe_fq(x, params["fc1"]["kernel"], site="fc1")
    h = torch.matmul(x1, w1) + params["fc1"]["bias"]
    h = F.gelu(h, approximate="none")
    h2, w2 = maybe_fq(h, params["fc2"]["kernel"], site="fc2")
    return torch.matmul(h2, w2) + params["fc2"]["bias"]


class MLP(nn.Module):
    def __init__(self, hidden_dim: int, mlp_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1_kernel = nn.Parameter(lecun_normal_(torch.empty(hidden_dim, mlp_dim), generator))
        self.fc1_bias = nn.Parameter(torch.zeros(mlp_dim))
        self.fc2_kernel = nn.Parameter(lecun_normal_(torch.empty(mlp_dim, hidden_dim), generator))
        self.fc2_bias = nn.Parameter(torch.zeros(hidden_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(x, {"fc1": {"kernel": self.fc1_kernel, "bias": self.fc1_bias},
                               "fc2": {"kernel": self.fc2_kernel, "bias": self.fc2_bias}})
