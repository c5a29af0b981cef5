"""Analytic FLOPs of the model families (counterpart of
peekvit_tpu/utils/flops_count.py).

Counted terms mirror the reference hooks: patch-embed conv, qkv and out
projections, the QK^T and PV products, the MLP, the head on the summed
class tokens (PCT: the ARPE embedding's two products). LayerNorm, GELU
and softmax elementwise terms are excluded. FLOPs = 2 x MACs.

A model with a budget token counts it as a special token. Given a
forward's ``aux`` (the module's ``aux["masks"]``), each gated layer counts
its mean kept tokens (a token dropped once stays dropped: the incremental
masks), the reference's mask-aware count. ``compact_macs`` counts what a
compacted forward computes: every layer at its buffer's width.
``compute_flops`` and ``sparsity_per_module`` run the model's eval
forward at a budget to observe its masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from peekvit_torch.utils.introspection import get_forward_masks, sparsity_per_layer


def _encoder_layer_macs(n: float, d: int, m: int) -> float:
    """MACs of one pre-LN transformer block at n tokens."""
    return 4 * n * d * d + 2 * n * n * d + 2 * n * d * m


def _geometry(module):
    """(patches, special tokens counting the budget token)."""
    n_patches = (module.image_size // module.patch_size) ** 2
    specials = module.num_class_tokens + module.num_registers
    if getattr(module, "add_budget_token", None):
        specials += 1
    return n_patches, specials


def _embed_head_macs(module, n_patches: int) -> float:
    p, d = module.patch_size, module.hidden_dim
    return n_patches * d * (p * p * 3) + d * module.num_classes


def _layer_tokens(aux: Optional[dict], num_layers: int, seq: float, specials: float) -> list:
    """Mean active tokens per encoder layer from the incremental masks; a
    layer without a mask keeps the previous layer's count."""
    by_layer = {int(str(k).split("_")[-1]): v
                for k, v in get_forward_masks(aux or {}, incremental=True).items()}
    counts, current = [], float(seq)
    for i in range(num_layers):
        if i in by_layer:
            current = by_layer[i].ceil().sum(dim=1).float().mean().item() + specials
        counts.append(current)
    return counts


def analytic_macs(module, aux: Optional[dict] = None) -> float:
    """Per-image MACs of a ViT-family or PCT-family module; with a
    forward's ``aux``, the gated layers count their kept tokens."""
    d, m = module.hidden_dim, module.mlp_dim
    if hasattr(module, "num_points"):  # PCT: the ARPE embedding, then the blocks
        n = module.num_points
        counts = _layer_tokens(aux, module.num_layers, n, 0)
        return (n * 3 * d + n * d * d + sum(_encoder_layer_macs(c, d, m) for c in counts)
                + d * module.num_classes)
    n_patches, specials = _geometry(module)
    counts = _layer_tokens(aux, module.num_layers, n_patches + specials, specials)
    return _embed_head_macs(module, n_patches) + sum(_encoder_layer_macs(c, d, m)
                                                    for c in counts)


def compact_macs(module, caps: tuple) -> float:
    """Per-image MACs of a compacted ResidualViT forward (``compact_caps``):
    layer i runs on the special tokens, the budget token, the phantom slot
    and min(caps[:i + 1]) image slots, whatever the gates decide."""
    d, m = module.hidden_dim, module.mlp_dim
    n_patches, specials = _geometry(module)
    phantom = int(min(caps) < n_patches)
    macs, width = _embed_head_macs(module, n_patches), n_patches
    for cap in caps:
        width = min(width, cap)
        macs += _encoder_layer_macs(specials + phantom + width, d, m)
    return macs


def count_params(model) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def eval_forward(model, batch, budget=None, noise_value=None):
    """The model's eval forward, (outputs, aux), without gradients: the
    budget to a family that takes one, the noise value to a NoiseBlock
    (its draws from a generator seeded 0), as the JAX ``Model.__call__``."""
    from peekvit_torch.models.registry import accepts_budget

    device = next(model.parameters()).device
    x = torch.as_tensor(batch).to(device, torch.float32)
    kw = {}
    if budget is not None and accepts_budget(model):
        kw["budget"] = float(budget)
    if noise_value is not None and getattr(model, "noise_layer", None) is not None:
        kw["noise_value"] = noise_value
    with torch.no_grad():
        return model(x, **kw)


def compute_flops(model, batch, budget: Optional[float] = None,
                  noise_value: Optional[float] = None, as_strings: bool = False,
                  verbose: bool = False) -> Tuple[float, int]:
    """(FLOPs per image, parameter count): one forward at ``budget`` shows
    the masks the model produces, then the count is analytic."""
    _, aux = eval_forward(model, batch, budget, noise_value)
    flops = 2.0 * analytic_macs(model, aux)
    params = count_params(model)
    if as_strings:
        return f"{flops / 1e9:.2f} GFLOPs", f"{params / 1e6:.2f} M"
    return flops, params


def sparsity_per_module(model, batch, budget=None) -> Dict[str, float]:
    """The kept-token fraction of each gated layer at ``budget``."""
    _, aux = eval_forward(model, batch, budget)
    return sparsity_per_layer(aux)
