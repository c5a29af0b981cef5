"""RankViT: train-free norm-based token pruning (counterpart of
peekvit_tpu/models/rankvit.py).

Contract (reference models/rankvit.py): at each layer in
``rankvit_layers``, the alive image tokens are ranked by their L2 norm,
descending, and the top ``ceil(n_alive * budget)`` stay alive; the rest
are excluded as attention keys from then on (the reference drops them
physically; excluding them as keys is the same for every kept token).
Without a budget no layer ranks. ``budget`` is a float or a per-layer
sequence indexed by layer id. Every class token is protected from
ranking. Registers are refused. ``noise_layer`` puts the NoiseBlock
(ops/noise.py) before that block, ahead of its rank update (JAX
rankvit.py:124-131).

Parameter names are the JAX module's (``conv_proj``, ``class_tokens``,
``encoder.pos_embedding``, ``encoder.layers_{i}``, ``encoder.ln``,
``head``); a ranking layer has the plain block's parameters, so a JAX
tree loads through ``params_from_jax`` unchanged. ``forward`` returns
``(logits, {"masks": {"layer_i": (B, N_img, 1)}})`` with one keep mask
per ranking layer. ``train=True`` applies ``dropout`` (after the
pos-embedding and on each attention output) and ``attention_dropout``,
drawn from ``generator`` (JAX rankvit.py:75-77, :115; ops/dropout.py).

``RankVisionTransformer`` is not a ``VisionTransformer`` subclass: the
engine and the Trainer dispatch on it by name, so that a budget is never
quietly ignored by a plain-ViT path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from peekvit_torch.models.vit import Dense, LayerNorm, ViTBlock, check_noise_layer, noise_spec
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.noise import inject_noise
from peekvit_torch.ops.patch_embed import PatchEmbed


def _rank_update(img_tokens: torch.Tensor, alive: torch.Tensor, budget) -> torch.Tensor:
    """New keep mask: the top ceil(alive_count * budget) alive tokens by
    fp32 norm (stable descending order, ties to the lower index), computed
    in fp32 like the JAX ``_rank_update``. img_tokens: (B, N, D); alive:
    (B, N) in {0, 1}; returns (B, N) in the tokens' dtype."""
    norms = torch.linalg.vector_norm(img_tokens.float(), dim=-1)
    neg = torch.finfo(torch.float32).min
    norms = torch.where(alive > 0, norms, torch.full_like(norms, neg))
    order = torch.argsort(-norms, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1)
    alive_count = alive.float().sum(dim=-1, keepdim=True)
    budget = torch.as_tensor(budget, dtype=torch.float32, device=img_tokens.device)
    n_keep = torch.ceil(alive_count * budget)
    return ((ranks < n_keep) & (alive > 0)).to(img_tokens.dtype)


def _with_class_keys(alive: torch.Tensor, num_class_tokens: int) -> torch.Tensor:
    """(B, N_img) keep mask -> (B, c + N_img) key mask, class tokens 1."""
    ones = torch.ones((alive.shape[0], num_class_tokens), dtype=alive.dtype, device=alive.device)
    return torch.cat([ones, alive], dim=1)


class RankViTBlock(ViTBlock):
    """ViT block that re-ranks the alive tokens before attending
    (reference rankvit.py:24-101)."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int, num_class_tokens: int = 1,
                 ln_eps: float = 1e-5, generator: torch.Generator | None = None,
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__(num_heads, hidden_dim, mlp_dim, ln_eps, generator, dropout,
                         attention_dropout)
        self.num_class_tokens = num_class_tokens

    def forward(self, tokens: torch.Tensor, alive: torch.Tensor, budget, train: bool = False,
                generator: torch.Generator | None = None):
        c = self.num_class_tokens
        alive = _rank_update(tokens[:, c:], alive, budget)
        return super().forward(tokens, key_mask=_with_class_keys(alive, c), train=train,
                               generator=generator), alive


class RankViTEncoder(nn.Module):
    """Pos-emb, a mixed stack of plain and ranking blocks, final LN
    (reference rankvit.py:105-152)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, rankvit_layers: tuple = (), num_class_tokens: int = 1,
                 generator: torch.Generator | None = None, noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.rankvit_layers = tuple(rankvit_layers)
        self.num_class_tokens = num_class_tokens
        self.n_img = seq_length - num_class_tokens
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        rates = dict(dropout=dropout, attention_dropout=attention_dropout)
        for i in range(num_layers):
            block = (RankViTBlock(num_heads, hidden_dim, mlp_dim, num_class_tokens,
                                  generator=generator, **rates)
                     if i in self.rankvit_layers
                     else ViTBlock(num_heads, hidden_dim, mlp_dim, generator=generator, **rates))
            self.add_module(f"layers_{i}", block)
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, tokens: torch.Tensor, budget=None, noise_value=None, noise_rng=None,
                train: bool = False, generator: torch.Generator | None = None):
        tokens = dropout(tokens + self.pos_embedding, self.dropout, generator, train=train)
        spec = noise_spec(self.noise_layer, self.noise_type, noise_value, noise_rng)
        alive = torch.ones((tokens.shape[0], self.n_img), dtype=tokens.dtype,
                           device=tokens.device)
        masks = {}
        budget_vec = None if budget is None else torch.as_tensor(budget, dtype=torch.float32)
        for i in range(self.num_layers):
            tokens = inject_noise(tokens, i, spec)
            layer = getattr(self, f"layers_{i}")
            if i in self.rankvit_layers and budget_vec is not None:
                # per-layer budgets are indexed by layer id
                b_i = budget_vec[i] if budget_vec.dim() == 1 else budget_vec
                tokens, alive = layer(tokens, alive, b_i, train, generator)
                masks[f"layer_{i}"] = alive[..., None]
                continue
            # dropped tokens were physically removed in the reference, so
            # a non-ranking layer must not attend to them either
            key_mask = None
            if budget_vec is not None and self.rankvit_layers:
                key_mask = _with_class_keys(alive, self.num_class_tokens)
            # a ranking block without a budget runs as a plain block
            tokens = (layer(tokens, key_mask=key_mask, train=train, generator=generator)
                      if i not in self.rankvit_layers
                      else ViTBlock.forward(layer, tokens, key_mask=key_mask, train=train,
                                            generator=generator))
        return self.ln(tokens), masks


class RankVisionTransformer(nn.Module):
    """RankViT classifier. Returns (logits, aux["masks"])."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: Optional[int] = None, num_registers: int = 0,
                 num_class_tokens: int = 1, rankvit_layers: Optional[Sequence[int]] = None,
                 noise_layer: Optional[int] = None, noise_type: str = "gaussian",
                 generator: torch.Generator | None = None):
        super().__init__()
        # constructor parity with the JAX module: unused there too
        del representation_size
        if image_size % patch_size != 0:
            raise ValueError("Input shape indivisible by patch size!")
        if num_registers > 0:
            raise ValueError("Registers are not supported yet for this model.")
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
        self.num_registers = 0
        self.num_class_tokens = num_class_tokens
        self.rankvit_layers = tuple(rankvit_layers or ())
        self.ln_eps = 1e-5

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + num_class_tokens
        self.encoder = RankViTEncoder(seq_length, num_layers, num_heads, hidden_dim, mlp_dim,
                                      self.rankvit_layers, num_class_tokens, generator,
                                      noise_layer, noise_type, dropout, attention_dropout)
        self.head = Dense(hidden_dim, num_classes)  # zero init

    def forward(self, x: torch.Tensor, budget=None, noise_value=None,
                noise_rng: torch.Generator | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
        """x: (B, H, W, 3). ``budget``: None (no ranking), a float, or a
        per-layer sequence indexed by layer id. ``noise_value`` /
        ``noise_rng``, ``train`` / ``generator`` as in models/vit.py."""
        n = x.shape[0]
        tokens = torch.cat([self.class_tokens.expand(n, -1, -1), self.conv_proj(x)], dim=1)
        tokens, masks = self.encoder(tokens, budget, noise_value, noise_rng, train, generator)
        logits = self.head(tokens[:, :self.num_class_tokens].sum(dim=1))
        return logits, {"masks": masks}
