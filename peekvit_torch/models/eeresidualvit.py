"""ResidualViT with per-layer early-exit heads (counterpart of
peekvit_tpu/models/eeresidualvit.py; reference models/eeresidualvit.py).

Each layer gets an LN -> Dense exit head on the class token,
``encoder.early_exit_heads_{i}_ln`` / ``_head`` (eeresidualvit.py:75-76,
JAX :103-112); the forward returns ``((exit_0, ..., exit_{L-1}, final),
aux)`` with one scalar budget per batch in ``aux["current_budget"]``.
Both learnable budget-token modes allocate ``learnable_budget_token_2``
(reference :217-219).

Under ``train=True`` the one budget is drawn even when a budget is given
(JAX :196-204, :232-243, a quirk kept): a float ``add_budget_token`` is
the constant, a list or tuple a uniform choice, anything else uniform
in [0, 1) (``budget_interval`` is not read).
"""

from __future__ import annotations

import torch

from peekvit_torch.models.residualvit import ResidualVisionTransformer


def sample_batch_budget(model, generator, device) -> torch.Tensor:
    """ONE training budget for the batch, a 0-d fp32 tensor on ``device``
    (JAX :196-204): a float ``add_budget_token`` is the constant, a list or
    tuple a uniform choice, anything else uniform in [0, 1). Drawn from
    ``generator`` on its own device."""
    bt = model.add_budget_token
    if isinstance(bt, float):
        return torch.tensor(bt, dtype=torch.float32, device=device)
    gen_device = generator.device if generator is not None else None
    if isinstance(bt, (list, tuple)):
        idx = int(torch.randint(len(bt), (), generator=generator, device=gen_device))
        return torch.tensor(float(bt[idx]), dtype=torch.float32, device=device)
    return torch.rand((), generator=generator, device=gen_device).to(device)


class EEResidualVisionTransformer(ResidualVisionTransformer):
    """Early-exit ResidualViT. Primary output = tuple(exits..., final)."""

    early_exits = True
    both_budget_tokens = True
    output_format = "early_exits"

    def _current_budget(self, budget, n: int, train: bool, generator, device) -> torch.Tensor:
        """ONE budget per batch, a 0-d fp32 tensor."""
        if not train:
            if budget is None:
                raise ValueError("Budget not set. Call set_budget() (or pass budget=) before "
                                 "evaluating this model.")
            return torch.as_tensor(budget, dtype=torch.float32, device=device)
        return sample_batch_budget(self, generator, device)
