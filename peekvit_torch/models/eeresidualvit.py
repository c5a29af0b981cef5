"""ResidualViT with per-layer early-exit heads (counterpart of
peekvit_tpu/models/eeresidualvit.py; reference models/eeresidualvit.py).

Each layer gets an LN -> Dense exit head on the class token,
``encoder.early_exit_heads_{i}_ln`` / ``_head`` (eeresidualvit.py:75-76,
JAX :103-112); the forward returns ``((exit_0, ..., exit_{L-1}, final),
aux)`` with one scalar budget per batch in ``aux["current_budget"]``.
Both learnable budget-token modes allocate ``learnable_budget_token_2``
(reference :217-219).
"""

from __future__ import annotations

from peekvit_torch.models.residualvit import ResidualVisionTransformer


class EEResidualVisionTransformer(ResidualVisionTransformer):
    """Early-exit ResidualViT. Primary output = tuple(exits..., final)."""

    early_exits = True
    output_format = "early_exits"
