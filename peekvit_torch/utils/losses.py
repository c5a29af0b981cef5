"""Regularizer losses and LossCompose (counterpart of
peekvit_tpu/utils/losses.py; reference utils/losses.py).

Each loss is a pure function of the forward's ``aux`` dict (the per-layer
gate masks ``aux["masks"]``, A-ViT's ``rho_token`` and
``halting_score_layer``) and scalars, differentiable through autograd.
The reference's quirks are kept as the JAX file keeps them:

- sparsity per mask = the mean over the sequence axis of a (B, S, 1)
  mask, per image (losses.py:55-57);
- ``solo_l1`` and ``l1_and_intraentropy`` SUM over the batch, then take
  the mean over layers (losses.py:95-108, 187-203): the scale depends on
  the batch size;
- ``solo_mse``: strict (two-sided) or relu (one-sided) penalties,
  ``skip_layers``, per-layer or all-layer-mean, and the final
  ``* (2 - budget)`` (losses.py:111-141);
- ``L1Loss`` takes an explicit ``budget=0.0`` (a ``None`` check, not the
  reference's ``budget or self.budget``);
- A-ViT's ponder loss is mean(rho_token) and its distribution prior the
  KL of the per-layer halting distribution against N(target_depth, 1)
  with the reference's clamp and ``batchmean`` (losses.py:144-184).

``LossCompose`` keeps the reference's config contract (losses.py:417-476):
``{name: {_target_: ..., weight: w, **ctor_args}}``, targets resolved by
class name, so the reference's loss YAMLs work unchanged.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

Aux = Dict[str, Any]


# ---------------------------------------------------------------- helpers


def _mask_list(aux: Aux) -> list:
    """Per-layer gate masks from aux, in layer order. Each is (B, S, 1)."""
    masks = aux.get("masks", {})
    if isinstance(masks, dict):
        items = sorted(masks.items(), key=lambda kv: int(str(kv[0]).split("_")[-1]))
        return [m for _, m in items]
    return list(masks)


def _entr(x: torch.Tensor) -> torch.Tensor:
    """torch.special.entr (-x ln x for x > 0, 0 at 0, -inf below), written
    with a safe branch so that the gradient at x = 0 is 0, not inf."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, -safe * torch.log(safe),
                       torch.where(x == 0, torch.zeros_like(x), torch.full_like(x, -math.inf)))


def _per_image_sparsity(mask: torch.Tensor) -> torch.Tensor:
    """reduce(mask, 'b s 1 -> b', 'mean'): the fraction of kept tokens."""
    return mask.mean(dim=(1, 2))


# ------------------------------------------------- functional regularizers


def sparsity_loss_per_block(aux: Aux, budget: float = 0.65, sparsity_type: str = "l1",
                            **_) -> torch.Tensor:
    """Mean over layers of a per-layer sparsity-vs-budget penalty
    (reference losses.py:34-75)."""
    losses = []
    for mask in _mask_list(aux):
        sparsity = _per_image_sparsity(mask)  # (B,)
        if sparsity_type == "mse":
            losses.append(((sparsity - budget) ** 2).mean())
        elif sparsity_type == "cross_entropy":
            # torch cross_entropy(input=(B,), target=(B,) float) treats the
            # batch axis as the class axis with probabilistic targets
            target = torch.zeros_like(sparsity) + budget
            losses.append(-(target * torch.log_softmax(sparsity, dim=0)).sum())
        else:  # 'l1'
            losses.append((sparsity - budget).abs().mean())
    return torch.stack(losses).mean()


def entropy_per_blocks(aux: Aux, **_) -> torch.Tensor:
    """Mean over layers and batch of entr(per-image sparsity)
    (reference losses.py:78-92)."""
    return torch.stack([_entr(_per_image_sparsity(m)) for m in _mask_list(aux)]).mean()


def solo_l1(aux: Aux, budget: float = 0.25, **_) -> torch.Tensor:
    """Mean over layers of the SUM over the batch of |sparsity - budget|
    (reference losses.py:95-108)."""
    return torch.stack([(_per_image_sparsity(m) - budget).abs().sum()
                        for m in _mask_list(aux)]).mean()


def solo_mse(aux: Aux, budget: float = 0.65, strict: bool = False,
             skip_layers: Sequence[int] = (), per_layer: bool = True, **_) -> torch.Tensor:
    """MSE (strict) or one-sided relu² (default) sparsity-vs-budget penalty,
    scaled by (2 - budget) (reference losses.py:111-141)."""
    skip = set(int(s) for s in (skip_layers or ()))

    def penalty(s):
        d = (s - budget) if strict else torch.relu(s - budget)
        return d ** 2

    per_layer_vals = []
    for layer, mask in enumerate(_mask_list(aux)):
        if layer in skip:
            continue
        sparsity = _per_image_sparsity(mask)  # (B,)
        per_layer_vals.append(penalty(sparsity).sum() if per_layer else sparsity)

    if not per_layer_vals:  # every gated layer skipped (e.g. a 12-layer
        masks = _mask_list(aux)  # skip_layers config on a shallower model)
        return torch.zeros((), device=masks[0].device if masks else None)
    stacked = torch.stack(per_layer_vals)  # (L,) or (L, B)
    if not per_layer:
        stacked = penalty(stacked.mean()).sum()
    return (stacked * (2.0 - budget)).mean()


def l1_and_intraentropy(aux: Aux, budget: float = 0.65, **_) -> torch.Tensor:
    """Mean over layers of the SUM over the batch of relu(sparsity - budget)
    (reference losses.py:187-203)."""
    return torch.stack([torch.relu(_per_image_sparsity(m) - budget).abs().sum()
                        for m in _mask_list(aux)]).mean()


def avit_ponder_loss(aux: Aux, **_) -> torch.Tensor:
    """mean(rho_token) (reference losses.py:144-157)."""
    return aux["rho_token"].mean()


def avit_distr_prior_loss(aux: Aux, target_depth: float = 7, **_) -> torch.Tensor:
    """KL between the per-layer mean-halting distribution and log N(d, 1) at
    layers 1..L (reference losses.py:160-184): torch.kl_div(log h, log t,
    log_target=True, reduction='batchmean') = sum(t (log t - log h)) / L."""
    h = torch.as_tensor(aux["halting_score_layer"], dtype=torch.float32)  # (L,)
    num_layers = h.shape[0]
    depths = torch.arange(num_layers, dtype=torch.float32, device=h.device) + 1.0
    log_t = -0.5 * (depths - target_depth) ** 2 - 0.5 * math.log(2.0 * math.pi)
    h = torch.clamp(h / h.sum(), 0.001, 0.999)
    return (torch.exp(log_t) * (log_t - torch.log(h))).sum() / num_layers


# ----------------------------------------------------- class wrappers


class ModelLoss:
    """Base regularizer: ``__call__(aux, **kw) -> scalar``."""

    def __call__(self, aux: Aux, **kwargs) -> torch.Tensor:
        raise NotImplementedError


class SparsityLoss(ModelLoss):
    def __init__(self, budget: float = 0.65, sparsity_type: str = "l1"):
        self.budget, self.sparsity_type = budget, sparsity_type

    def __call__(self, aux, budget=None, **kw):
        b = budget if budget is not None else self.budget
        return sparsity_loss_per_block(aux, budget=b, sparsity_type=self.sparsity_type)


class EntropyLoss(ModelLoss):
    def __call__(self, aux, **kw):
        return entropy_per_blocks(aux)


class L1Loss(ModelLoss):
    def __init__(self, budget: float = 0.25):
        self.budget = budget

    def __call__(self, aux, budget=None, **kw):
        # an explicit None check: budget=0.0 is a budget (the reference's
        # `budget or self.budget` falls back on it)
        return solo_l1(aux, budget if budget is not None else self.budget)


class MSELoss(ModelLoss):
    def __init__(self, budget: Optional[float] = None, strict: bool = False,
                 skip_layers: Sequence[int] = (), per_layer: bool = True, **_):
        self.budget, self.strict = budget, strict
        self.skip_layers, self.per_layer = skip_layers, per_layer

    def __call__(self, aux, budget=None, per_layer=None, **kw):
        b = budget if budget is not None else self.budget
        assert b is not None, "budget must be provided as argument or ctor attr"
        pl_ = per_layer if per_layer is not None else self.per_layer
        return solo_mse(aux, b, self.strict, skip_layers=self.skip_layers, per_layer=pl_)


class ChannelMSELoss(ModelLoss):
    """MSELoss keyed on ``channel_budget`` instead of ``budget``
    (reference losses.py:304-330)."""

    def __init__(self, budget: Optional[float] = None, strict: bool = False,
                 skip_layers: Sequence[int] = (), **_):
        self.budget, self.strict, self.skip_layers = budget, strict, skip_layers

    def __call__(self, aux, channel_budget=None, **kw):
        b = channel_budget if channel_budget is not None else self.budget
        assert b is not None, "budget must be provided as argument or ctor attr"
        return solo_mse(aux, b, self.strict, skip_layers=self.skip_layers)


class L1AndIntraEntropyLoss(ModelLoss):
    def __init__(self, budget: float = 0.65):
        self.budget = budget

    def __call__(self, aux, budget=None, **kw):
        return l1_and_intraentropy(aux, budget if budget is not None else self.budget)


class AlwaysZeroLoss(ModelLoss):
    def __call__(self, aux, **kw):
        return torch.zeros(())


class AViTPonderLoss(ModelLoss):
    def __call__(self, aux, **kw):
        return avit_ponder_loss(aux)


class AViTDPriorLoss(ModelLoss):
    def __init__(self, target_depth: float = 7):
        self.target_depth = target_depth

    def __call__(self, aux, **kw):
        return avit_distr_prior_loss(aux, target_depth=self.target_depth)


LOSSES_MAP = {
    cls.__name__: cls
    for cls in (
        SparsityLoss, EntropyLoss, L1Loss, MSELoss, ChannelMSELoss,
        L1AndIntraEntropyLoss, AlwaysZeroLoss, AViTPonderLoss, AViTDPriorLoss,
    )
}


def resolve_loss_target(target: str):
    """Resolve a ``_target_`` such as ``peekvit.utils.losses.MSELoss`` by its
    final class-name segment, so the reference's loss YAMLs work unchanged."""
    name = target.rsplit(".", 1)[-1]
    if name not in LOSSES_MAP:
        raise ValueError(f"Unknown loss target {target!r}; known: {sorted(LOSSES_MAP)}")
    return LOSSES_MAP[name]


class LossCompose:
    """Weighted sum of named regularizers (reference losses.py:417-476).
    ``compute(aux, **kw)`` returns ``(per-loss dict, total)`` as 0-d
    tensors, which the Trainer carries out as metrics."""

    def __init__(self, losses_dict: Optional[Dict[str, dict]] = None):
        self.additional_losses: Dict[str, dict] = {}
        for name, args in dict(losses_dict or {}).items():
            args = dict(args)
            weight = args.pop("weight", 1.0)
            target = args.pop("_target_", None)
            cls = resolve_loss_target(target) if target else LOSSES_MAP[name]
            self.additional_losses[name] = {"weight": weight, "loss_fn": cls(**args)}

    def compute(self, aux: Aux, dict_prefix: str = "", return_dict: bool = True, **kwargs):
        losses_dict = {}
        total = torch.zeros(())
        for name, entry in self.additional_losses.items():
            val = entry["loss_fn"](aux, **kwargs) * entry["weight"]
            losses_dict[f"{dict_prefix}{name}"] = val
            total = total + val
        if return_dict:
            return losses_dict, total
        return total
