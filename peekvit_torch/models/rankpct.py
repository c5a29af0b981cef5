"""Rank-PCT: PCT with norm-based token ranking (counterpart of
peekvit_tpu/models/rankpct.py; reference models/rankpct.py).

Contract, quirks kept (rankpct.py:48-146):

- position 0 is protected from ranking (the reference treats it as a class
  token although PCT never prepends one);
- TRAIN: the non-protected tokens are ranked by descending fp32 norm and
  all but ``ceil((N - 1) * budget)`` of them are ZEROED, relative to the
  full N - 1 at every layer (not compounding); the zeroing is re-applied
  to the ln_1 / ln_2 outputs; the classifier mean divides by N;
- EVAL: a compounding keep mask: ``ceil(N_alive * budget)`` of the alive
  tokens stay (position 0 counts toward it), the others are excluded as
  attention keys from then on (the reference drops them; as keys they are
  the same), and the classifier mean divides by the survivor count;
- a block that does not rank (ranking off for it, or no budget) attends
  to every token, as the JAX module does;
- ``enable_ranking(bool | list)`` toggles ranking per block (":330-345").

``forward(x, budget=None, train=False, generator=None)`` returns
``(logits, {"masks": {"layer_i": (B, N, 1)}})``, one keep mask per block
that ranked. A train forward drops as PCT's does (models/pct.py;
rankpct.py:93, :138, :156).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from peekvit_torch.models.pct import _PointCloudBase
from peekvit_torch.models.vit import ViTBlock


def _ranks_desc(tokens: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Rank of each token by descending fp32 norm among the alive ones
    (0 = largest), ties to the lower index (rankpct.py:35)."""
    norms = torch.linalg.vector_norm(tokens.float(), dim=-1)
    norms = torch.where(alive > 0, norms, torch.full_like(norms, torch.finfo(torch.float32).min))
    order = torch.argsort(-norms, dim=-1, stable=True)
    return torch.argsort(order, dim=-1)


class RankingPCTBlock(ViTBlock):
    """The PCT block with optional ranking (rankpct.py:44)."""

    def forward(self, tokens: torch.Tensor, alive: torch.Tensor, budget, rank: bool,
                train: bool = False, generator: torch.Generator | None = None):
        b, n, _ = tokens.shape
        mask = key_mask = None
        if rank and budget is not None:
            budget = torch.as_tensor(budget, dtype=torch.float32, device=tokens.device)
            rest = tokens[:, 1:]
            ones = torch.ones((b, 1), dtype=tokens.dtype, device=tokens.device)
            if train:
                ranks = _ranks_desc(rest, torch.ones((b, n - 1), device=tokens.device))
                keep_rest = (ranks < torch.ceil((n - 1) * budget)).to(tokens.dtype)
                mask = torch.cat([ones, keep_rest], dim=1)
                tokens = tokens * mask[..., None]
            else:
                # ceil(N_alive * budget) of the full sequence; position 0 is
                # first in the sort, so it always survives (:103-113)
                ranks = _ranks_desc(rest, alive[:, 1:])
                n_keep = torch.ceil(alive.float().sum(-1, keepdim=True) * budget)
                keep_rest = ((ranks < (n_keep - 1)) & (alive[:, 1:] > 0)).to(tokens.dtype)
                mask = torch.cat([alive[:, :1], keep_rest], dim=1)
                alive = key_mask = mask
        y = self.ln_1(tokens)
        if train and mask is not None:
            y = y * mask[..., None]  # mask_tokens re-applied to the LN output (:135)
        x = self.self_attention(y, key_mask=key_mask, train=train, generator=generator) + tokens
        z = self.ln_2(x)
        if train and mask is not None:
            z = z * mask[..., None]
        x = self.mlp(z) + x
        return x, alive, None if mask is None else mask[..., None]


class RankPointCloudTransformer(_PointCloudBase):
    """Rank-PCT classifier (rankpct.py:102). Returns (logits, aux["masks"])."""

    def __init__(self, num_points: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 40, representation_size: Optional[int] = None,
                 num_registers: int = 0, num_class_tokens: int = 1,
                 ranking_enabled: Sequence[bool] = (),
                 generator: torch.Generator | None = None):
        del representation_size  # constructor parity with the JAX module
        super().__init__(num_points, num_layers, num_heads, hidden_dim, mlp_dim, dropout,
                         attention_dropout, num_classes, num_registers, num_class_tokens,
                         generator, RankingPCTBlock)
        self.ranking_enabled = tuple(bool(r) for r in ranking_enabled)

    def enable_ranking(self, sort_tokens=True) -> None:
        """Ranking on or off for every block (a bool) or per block (a
        sequence of bools, one per layer)."""
        if isinstance(sort_tokens, bool):
            sort_tokens = [sort_tokens] * self.num_layers
        self.ranking_enabled = tuple(bool(s) for s in sort_tokens)

    def forward(self, x: torch.Tensor, budget=None, train: bool = False,
                generator: torch.Generator | None = None,
                noise_value=None) -> tuple[torch.Tensor, dict]:
        """``noise_value`` is taken and ignored, as JAX's (rankpct.py:147-149)."""
        del noise_value
        tokens = self.embed(x, train, generator)
        b, n, _ = tokens.shape
        ranking = self.ranking_enabled or (False,) * self.num_layers
        alive = torch.ones((b, n), dtype=tokens.dtype, device=tokens.device)
        masks = {}
        for i in range(self.num_layers):
            tokens, alive, mask = getattr(self, f"layers_{i}")(tokens, alive, budget, ranking[i],
                                                               train, generator)
            if mask is not None:
                masks[f"layer_{i}"] = mask
        if masks and not train:
            # the physical drop's mean: over the surviving tokens only
            w = alive[..., None]
            pooled = (tokens * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        else:
            pooled = tokens.mean(dim=1)
        return self.head(pooled, train, generator), {"masks": masks}
