"""A-ViT: token-level Adaptive Computation Time (counterpart of
peekvit_tpu/models/adavit.py; reference models/adavit.py, arXiv
2112.07658).

Behavioural contract, as the JAX module:

- each block masks both sublayers' inputs by the still-computing mask a:
  ``x + Attn(LN(x * a) * a)``, then ``x + MLP(LN(x * a) * a)``, LN eps
  1e-5, no dropout on the residual adds (adavit.py:21-80); a train
  forward drops the attention weights at ``attention_dropout`` and the
  tokens after the pos-embedding at ``dropout`` (JAX :49, :65, :166;
  ops/dropout.py), drawn from ``generator``;
- the per-token halting score is ``sigmoid(x[:, :, 0] * gate_scale -
  gate_center)`` of the block's output;
- the ACT loop carries the cumulative halting c, the remainder R, the
  ponder cost rho, the counter and the active mask; the output is the sum
  over layers of delta1 (tokens reaching 1 - eps, weighted by their
  remainder) and delta2 (still-active tokens, weighted by h); the last
  layer forces h = 1, so every token halts (adavit.py:140-219);
- documented divergence kept from JAX: each layer's mean halting score
  excludes the class token, ``mean(h[:, 1:])`` (the reference's
  ``mean(h[1:])`` slices the batch), over the global batch under data
  parallelism (ops/global_batch.batch_mean);
- ``noise_layer`` puts the NoiseBlock (ops/noise.py) inside the ACT loop,
  on the carried tokens before layer ``noise_layer`` masks them by the
  active mask (JAX adavit.py:93-102), driven by the forward's
  ``noise_value`` / ``noise_rng``;
- ``forward`` returns ``(logits, aux)`` with aux = {"rho_token",
  "counter_token": (B, N), "halting_score_layer": (num_layers,)}, what
  the A-ViT losses read (utils/losses.py).

The JAX encoder scans one block over the layers (``nn.scan``), so the
block's parameters carry a leading layer axis under
``encoder.blocks.block`` (``encoder.blocks.block.ln_1.scale`` is (L, D),
``encoder.blocks.block.self_attention.in_proj_kernel`` (L, D, 3D) ...).
The port keeps that layout, so ``params_from_jax`` loads a JAX tree with
no transpose. Without dropout the eval and the train forward are one. The
ACT carry takes no ``detach``, as JAX's takes no ``stop_gradient``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from peekvit_torch.models.vit import Dense, LayerNorm, check_noise_layer, noise_spec
from peekvit_torch.ops.attention import multi_head_attention
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.global_batch import batch_mean
from peekvit_torch.ops.mlp import lecun_normal_, mlp_forward
from peekvit_torch.ops.noise import inject_noise
from peekvit_torch.ops.patch_embed import PatchEmbed


class _StackedLayerNorm(nn.Module):
    """One LayerNorm per layer, ``scale``/``bias`` of shape (L, D)."""

    def __init__(self, num_layers: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_layers, dim))
        self.bias = nn.Parameter(torch.zeros(num_layers, dim))

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale[layer], self.bias[layer], self.eps)


class _StackedSelfAttention(nn.Module):
    """One MHSA per layer with the JAX names and a leading layer axis;
    each layer's kernels xavier-uniform, biases zero (ops/attention.py)."""

    def __init__(self, num_layers: int, hidden_dim: int, num_heads: int, generator=None,
                 dropout: float = 0.0):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_kernel = nn.Parameter(torch.empty(num_layers, d, 3 * d))
        self.in_proj_bias = nn.Parameter(torch.zeros(num_layers, 3 * d))
        self.out_proj_kernel = nn.Parameter(torch.empty(num_layers, d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(num_layers, d))
        with torch.no_grad():
            for i in range(num_layers):
                nn.init.xavier_uniform_(self.in_proj_kernel[i], generator=generator)
                nn.init.xavier_uniform_(self.out_proj_kernel[i], generator=generator)

    def forward(self, x: torch.Tensor, layer: int, train: bool = False,
                generator=None) -> torch.Tensor:
        return multi_head_attention(
            x, {"in_proj": {"kernel": self.in_proj_kernel[layer],
                            "bias": self.in_proj_bias[layer]},
                "out_proj": {"kernel": self.out_proj_kernel[layer],
                             "bias": self.out_proj_bias[layer]}}, self.num_heads,
            deterministic=not (self.training or train),
            dropout_rate=self.dropout if train else 0.0, generator=generator)


class _StackedMLP(nn.Module):
    """One MLP per layer (fc1 -> erf gelu -> fc2) with a leading layer
    axis; lecun-normal kernels, zero biases (ops/mlp.py)."""

    def __init__(self, num_layers: int, hidden_dim: int, mlp_dim: int, generator=None):
        super().__init__()
        self.fc1_kernel = nn.Parameter(torch.empty(num_layers, hidden_dim, mlp_dim))
        self.fc1_bias = nn.Parameter(torch.zeros(num_layers, mlp_dim))
        self.fc2_kernel = nn.Parameter(torch.empty(num_layers, mlp_dim, hidden_dim))
        self.fc2_bias = nn.Parameter(torch.zeros(num_layers, hidden_dim))
        with torch.no_grad():
            for i in range(num_layers):
                lecun_normal_(self.fc1_kernel[i], generator)
                lecun_normal_(self.fc2_kernel[i], generator)

    def forward(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        return mlp_forward(x, {"fc1": {"kernel": self.fc1_kernel[layer],
                                       "bias": self.fc1_bias[layer]},
                               "fc2": {"kernel": self.fc2_kernel[layer],
                                       "bias": self.fc2_bias[layer]}})


class AViTBlock(nn.Module):
    """The scanned block (JAX ``AViTBlock``, adavit.py:47): every layer's
    weights in one module, the layer chosen per call."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int, mlp_dim: int,
                 gate_scale: float = 10.0, gate_center: float = 30.0, generator=None,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.gate_scale = gate_scale
        self.gate_center = gate_center
        self.ln_1 = _StackedLayerNorm(num_layers, hidden_dim)
        self.self_attention = _StackedSelfAttention(num_layers, hidden_dim, num_heads, generator,
                                                    attention_dropout)
        self.ln_2 = _StackedLayerNorm(num_layers, hidden_dim)
        self.mlp = _StackedMLP(num_layers, hidden_dim, mlp_dim, generator)

    def forward(self, x: torch.Tensor, active: torch.Tensor, layer: int, train: bool = False,
                generator=None):
        """active: (B, N), 1 = still computing. Returns (x, halting score)."""
        a = active[..., None]
        x = x + self.self_attention(self.ln_1(x * a, layer) * a, layer, train, generator)
        x = x + self.mlp(self.ln_2(x * a, layer) * a, layer)
        return x, torch.sigmoid(x[:, :, 0] * self.gate_scale - self.gate_center)


class _Blocks(nn.Module):
    """The scan's container: its one child is named ``block``, as in JAX."""

    def __init__(self, block: AViTBlock):
        super().__init__()
        self.block = block


class AViTEncoder(nn.Module):
    """Pos-emb + the ACT loop over the block + final LN (JAX ``AViTEncoder``,
    adavit.py:136)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, eps: float = 0.01, gate_scale: float = 10.0,
                 gate_center: float = 30.0, generator=None, noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.eps = eps
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        self.blocks = _Blocks(AViTBlock(num_layers, num_heads, hidden_dim, mlp_dim, gate_scale,
                                        gate_center, generator, attention_dropout))
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, x: torch.Tensor, noise_value=None, noise_rng=None, train: bool = False,
                generator=None):
        """-> (LN(output), aux). The carry is the ACT state of _ACTStep
        (adavit.py:73-133)."""
        x = dropout(x + self.pos_embedding, self.dropout, generator, train=train)
        spec = noise_spec(self.noise_layer, self.noise_type, noise_value, noise_rng)
        b, n = x.shape[0], x.shape[1]
        c = x.new_zeros(b, n)
        R = x.new_ones(b, n)
        rho = x.new_zeros(b, n)
        counter = x.new_ones(b, n)
        active = x.new_ones(b, n)
        output = torch.zeros_like(x)
        out = x
        mean_h = []
        for layer in range(self.num_layers):
            out = inject_noise(out, layer, spec) * active[..., None]
            block_out, h = self.blocks.block(out, active, layer, train, generator)
            mean_h.append(batch_mean(h[:, 1:]))  # class token excluded (module docstring)
            out = block_out
            block_out = block_out * active[..., None]
            if layer == self.num_layers - 1:  # every remaining token halts
                h = torch.ones_like(h)
            c = c + h
            rho = rho + active
            reached = (c > 1.0 - self.eps).to(x.dtype) * active
            delta1 = block_out * (R * reached)[..., None]
            rho = rho + R * reached
            not_reached = (c < 1.0 - self.eps).to(x.dtype)
            R = R - not_reached * h
            delta2 = block_out * (h * not_reached)[..., None]
            counter = counter + not_reached
            active = not_reached
            output = output + delta1 + delta2
        aux = {"rho_token": rho, "counter_token": counter,
               "halting_score_layer": torch.stack(mean_h)}
        return self.ln(output), aux


class AdaptiveVisionTransformer(nn.Module):
    """A-ViT classifier (JAX ``AdaptiveVisionTransformer``, adavit.py:213).
    Returns (logits, aux) with the ACT state in aux."""

    accepts_budget = False  # depth emerges from the losses

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: Optional[int] = None, num_registers: int = 0,
                 num_class_tokens: int = 1, eps: float = 0.01, gate_scale: float = 10.0,
                 gate_center: float = 30.0, noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", generator: torch.Generator | None = None):
        super().__init__()
        del representation_size
        if image_size % patch_size != 0:
            raise ValueError("Input shape indivisible by patch size!")
        check_noise_layer(noise_layer, noise_type)
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.num_classes = num_classes
        self.num_registers = num_registers
        self.num_class_tokens = num_class_tokens
        self.eps = eps
        self.gate_scale = gate_scale
        self.gate_center = gate_center
        self.ln_eps = 1e-5

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        if num_registers > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + num_class_tokens + num_registers
        self.encoder = AViTEncoder(seq_length, num_layers, num_heads, hidden_dim, mlp_dim, eps,
                                   gate_scale, gate_center, generator, noise_layer, noise_type,
                                   dropout, attention_dropout)
        self.head = Dense(hidden_dim, num_classes)  # zero init

    def forward(self, x: torch.Tensor, budget=None, train: bool = False, noise_value=None,
                noise_rng: torch.Generator | None = None,
                generator: torch.Generator | None = None):
        """(logits, aux). ``budget`` is ignored (A-ViT takes none); the
        NoiseBlock draws from ``noise_rng``, the dropout masks of a train
        forward from ``generator``."""
        del budget
        n = x.shape[0]
        pieces = [self.class_tokens.expand(n, -1, -1)]
        if self.num_registers > 0:
            pieces.append(self.register_tokens.expand(n, -1, -1))
        tokens, aux = self.encoder(torch.cat(pieces + [self.conv_proj(x)], dim=1), noise_value,
                                   noise_rng, train, generator)
        return self.head(tokens[:, :self.num_class_tokens].sum(dim=1)), aux
