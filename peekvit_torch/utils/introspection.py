"""Model introspection over a forward's aux outputs and the parameter
tree (counterpart of peekvit_tpu/utils/introspection.py)."""

from __future__ import annotations

from typing import Dict


def _by_layer(items: dict) -> dict:
    return dict(sorted(items.items(), key=lambda kv: int(str(kv[0]).split("_")[-1])))


def ordered_masks(aux: dict) -> dict:
    """aux['masks'] as an ordered {layer_name: (B, S, 1)} dict."""
    masks = aux.get("masks", {})
    if not isinstance(masks, dict):
        masks = {f"layer_{i}": m for i, m in enumerate(masks)}
    return _by_layer(masks)


def get_forward_masks(aux: dict, incremental: bool = False) -> dict:
    """Per-layer masks; ``incremental=True`` multiplies each layer's mask by
    the ceil of the previous product, so that a token dropped once stays
    dropped."""
    masks = ordered_masks(aux)
    if not incremental:
        return masks
    out, prev = {}, None
    for name, mask in masks.items():
        if prev is not None:
            mask = mask * prev.ceil()
        out[name] = mask
        prev = mask
    return out


def get_gating_probs(aux: dict) -> dict:
    """Per-layer MoE gating probabilities."""
    probs = aux.get("gating_probs", {})
    if not isinstance(probs, dict):
        probs = {f"layer_{i}": p for i, p in enumerate(probs)}
    return _by_layer(probs)


def get_learned_thresholds(params) -> Dict[str, float]:
    """The learned gate thresholds (leaves named 'threshold') of a model or
    a parameter tree, by their "/"-joined paths."""
    from torch import nn

    from peekvit_torch.models.adapters import module_params, tree_leaves

    tree = module_params(params) if isinstance(params, nn.Module) else params
    return {name: float(leaf) for name, leaf in tree_leaves(tree)
            if name.endswith("threshold")}


def get_moes(module) -> Dict[str, int]:
    """Per-layer expert counts (above one) of a MoE model."""
    out = {}
    for kind in ("mlp_moes", "attn_moes"):
        for i, c in enumerate(getattr(module, kind, None) or ()):
            if c and c > 1:
                out[f"layer_{i}/{kind[:-5]}"] = int(c)
    return out


def get_ranking_layers(module) -> list:
    """Block indices that rank and drop tokens."""
    if getattr(module, "rankvit_layers", None):
        return list(module.rankvit_layers)
    enabled = getattr(module, "ranking_enabled", None)
    if enabled:
        return [i for i, e in enumerate(enabled) if e]
    return []


def sparsity_per_layer(aux: dict) -> Dict[str, float]:
    """Fraction of tokens kept per gated layer, from the masks."""
    return {name: float(mask.float().mean()) for name, mask in ordered_masks(aux).items()}
