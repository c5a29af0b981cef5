"""Analytic MACs of the ViT family (counterpart of
peekvit_tpu/utils/flops_count.py:42-99).

Counted terms mirror the reference hooks: patch-embed conv, qkv and out
projections, the QK^T and PV products, the MLP, the head on the summed
class tokens. LayerNorm/GELU/softmax elementwise terms are excluded.
FLOPs = 2 x MACs.

A model with a budget token counts it as a special token. Given a
forward's ``aux`` (the module's ``aux["masks"]``), each gated layer counts
its mean kept tokens (a token dropped once stays dropped: the incremental
masks), the reference's mask-aware count. ``compact_macs`` counts what a
compacted forward computes: every layer at its buffer's width.
"""

from __future__ import annotations

from typing import Optional


def _incremental_masks(aux: dict) -> dict:
    """aux['masks'] in layer order, each layer's mask multiplied by the ceil
    of the previous product so that a token dropped once stays dropped
    (peekvit_tpu/utils/introspection.py:23 ``get_forward_masks(aux,
    incremental=True)``, reference utils.py:100-122)."""
    masks = aux.get("masks", {})
    masks = dict(sorted(masks.items(), key=lambda kv: int(str(kv[0]).split("_")[-1])))
    out, prev = {}, None
    for name, mask in masks.items():
        if prev is not None:
            mask = mask * prev.ceil()
        out[name] = mask
        prev = mask
    return out


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


def analytic_macs(module, aux: Optional[dict] = None) -> float:
    """Per-image MACs of a ViT-family module; with a forward's ``aux``, the
    gated layers count their kept tokens (layers without a mask inherit
    the previous layer's count)."""
    d, m = module.hidden_dim, module.mlp_dim
    n_patches, specials = _geometry(module)
    by_layer = {int(str(k).split("_")[-1]): v
                for k, v in _incremental_masks(aux or {}).items()}
    macs, current = _embed_head_macs(module, n_patches), float(n_patches + specials)
    for i in range(module.num_layers):
        if i in by_layer:
            kept = by_layer[i].ceil().sum(dim=1).float().mean().item()
            current = kept + specials
        macs += _encoder_layer_macs(current, d, m)
    return macs


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
