"""Plain Vision Transformer (counterpart of peekvit_tpu/models/vit.py).

Behavioural contract (reference models/vit.py):
- conv patch-embed expressed as a matmul (ops/patch_embed.py);
- [class tokens] + [registers] + [patches] token layout (vit.py:229-236);
- learned pos-emb added inside the encoder (vit.py:92);
- pre-LN blocks, LayerNorm eps 1e-5;
- classifier = SUM of class tokens -> zero-init linear head (vit.py:242-247);
- ``forward(train=True, generator=g)``: dropout after the pos-embedding and
  on each block's attention output, attention dropout on the softmax
  weights (JAX vit.py:49-51, :92), every mask drawn from ``g``
  (ops/dropout.py); the default is the eval forward, where dropout is the
  identity.

Parameter names and layouts are the JAX package's, so a state_dict key is
the JAX tree path joined by dots (``encoder.layers_0.ln_1.scale``,
``encoder.layers_0.self_attention.in_proj_kernel``, ``head.kernel`` ...)
and kernels are (in, out). Images are NHWC. ``forward`` returns
``(logits, aux)`` with an empty aux, like the JAX module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from peekvit_torch.ops.attention import SelfAttention
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.mlp import MLP
from peekvit_torch.ops.noise import NOISE_TYPES, NoiseSpec, inject_noise
from peekvit_torch.ops.patch_embed import PatchEmbed


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with the JAX names ``scale``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class Dense(nn.Module):
    """x @ kernel + bias with an (in, out) kernel; zero init (the head)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class ViTBlock(nn.Module):
    """Pre-LN transformer encoder block (reference vit.py:19-55). A train
    forward drops the attention weights at ``attention_dropout`` and the
    attention output at ``dropout`` (JAX vit.py:49-51), drawn from
    ``generator``."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int,
                 ln_eps: float = 1e-5, generator: torch.Generator | None = None,
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln_1 = LayerNorm(hidden_dim, ln_eps)
        self.self_attention = SelfAttention(hidden_dim, num_heads, generator, attention_dropout)
        self.ln_2 = LayerNorm(hidden_dim, ln_eps)
        self.mlp = MLP(hidden_dim, mlp_dim, generator)

    def forward(self, x: torch.Tensor, *, key_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.self_attention(self.ln_1(x), key_mask=key_mask, train=train,
                                generator=generator)
        x = x + dropout(y, self.dropout, generator, train=train)
        return x + self.mlp(self.ln_2(x))


def check_noise_layer(noise_layer: Optional[int], noise_type: str) -> None:
    """A model's NoiseBlock settings: a known noise type where a layer is
    set (JAX raises at its first apply, in build_model's init)."""
    if noise_layer is not None and noise_type not in NOISE_TYPES:
        raise ValueError(f"unknown noise_type {noise_type!r}")


def noise_spec(noise_layer: Optional[int], noise_type: str, noise_value,
               noise_rng: Optional[torch.Generator]) -> Optional[NoiseSpec]:
    """The NoiseSpec of a module forward: None without a noise layer; a
    ``noise_value`` of None is the 0.0 sentinel, a ``noise_rng`` of None a
    generator seeded 0 on the tokens' device."""
    if noise_layer is None:
        return None
    return NoiseSpec(int(noise_layer), noise_type, noise_value, noise_rng)


class ViTEncoder(nn.Module):
    """Pos-emb + block stack + final LN (reference vit.py:59-95). Layers are
    attributes ``layers_0 .. layers_{L-1}``, the JAX names. ``noise_layer``
    puts the NoiseBlock (ops/noise.py) before that block (JAX vit.py:94-101);
    a train forward drops the tokens after the pos-embedding (:92)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int,
                 generator: torch.Generator | None = None,
                 noise_layer: Optional[int] = None, noise_type: str = "gaussian",
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"layers_{i}",
                            ViTBlock(num_heads, hidden_dim, mlp_dim, generator=generator,
                                     dropout=dropout, attention_dropout=attention_dropout))
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, x: torch.Tensor, noise_value=None,
                noise_rng: torch.Generator | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(x + self.pos_embedding, self.dropout, generator, train=train)
        spec = noise_spec(self.noise_layer, self.noise_type, noise_value, noise_rng)
        for i in range(self.num_layers):
            x = inject_noise(x, i, spec)
            x = getattr(self, f"layers_{i}")(x, train=train, generator=generator)
        return self.ln(x)


class VisionTransformer(nn.Module):
    """Plain ViT classifier. Returns (logits, aux).
    ``noise_layer`` / ``noise_type``: the NoiseBlock before that block; the
    forward's ``noise_value`` (snr in dB or drop probability, default the
    0.0 sentinel) and ``noise_rng`` (a ``torch.Generator`` on the input's
    device, default one seeded 0) drive it. ``train=True`` applies
    ``dropout`` / ``attention_dropout``, drawn from ``generator``."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000, representation_size: Optional[int] = None,
                 num_registers: int = 0, num_class_tokens: int = 1,
                 noise_layer: Optional[int] = None, noise_type: str = "gaussian",
                 generator: torch.Generator | None = None):
        super().__init__()
        # Accepted for constructor parity with the JAX module and its
        # configs; unused there too.
        del representation_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        if image_size % patch_size != 0:
            raise ValueError("Input shape indivisible by patch size!")
        check_noise_layer(noise_layer, noise_type)
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.num_classes = num_classes
        self.num_registers = num_registers
        self.num_class_tokens = num_class_tokens
        self.ln_eps = 1e-5

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        if num_registers > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + num_class_tokens + num_registers
        self.encoder = ViTEncoder(seq_length, num_layers, num_heads, hidden_dim,
                                  mlp_dim, generator, noise_layer, noise_type, dropout,
                                  attention_dropout)
        self.head = Dense(hidden_dim, num_classes)  # zero init (vit.py:186-188)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> [class tokens, registers, patches]."""
        n = x.shape[0]
        x = self.conv_proj(x)
        pieces = [self.class_tokens.expand(n, -1, -1)]
        if self.num_registers > 0:
            pieces.append(self.register_tokens.expand(n, -1, -1))
        return torch.cat(pieces + [x], dim=1)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(x[:, :self.num_class_tokens].sum(dim=1))

    def forward(self, x: torch.Tensor, noise_value=None,
                noise_rng: torch.Generator | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
        tokens = self.encoder(self.embed(x), noise_value, noise_rng, train, generator)
        return self.classify(tokens), {}
