"""build_model for the port (counterpart of peekvit_tpu/models/registry.py
:115-180). Only the plain ViT is ported; the other registered families
raise NotImplementedError naming their ROADMAP item."""

from __future__ import annotations

from typing import Optional

import torch

from peekvit_torch.models.vit import VisionTransformer

_VIT = ("visiontransformer", "VisionTransformer", "vit")
# JAX registry names not ported yet -> ROADMAP.md port queue A item
_NOT_PORTED = {
    **dict.fromkeys(("residualvisiontransformer", "ResidualVisionTransformer",
                     "residualvit", "EEResidualVisionTransformer",
                     "eeResidualVisionTransformer", "eeResidualvit", "eeresidualvit",
                     "ResidualVisionTransformerWithDecoder", "encdecresidualvit"),
                    "item 4 (ResidualViT)"),
    **dict.fromkeys(("RankingVisionTransformer", "RankVisionTransformer", "rankvit"),
                    "item 5 (RankViT)"),
    **dict.fromkeys(("visiontransformermoe", "VisionTransformerMoE", "vitmoe", "moevit",
                     "MoEVisionTransformer", "AdaptiveVisionTransformer", "adavit",
                     "MAEVisionTransformer", "maevit", "PointCloudTransformer",
                     "pointcloudtransformer", "pct", "RankPointCloudTransformer",
                     "rankpointcloudtransformer", "rankpct"),
                    "item 7 (remaining families)"),
}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: nothing moves to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_model(model_class: str, model_args: dict,
                noise_args: Optional[dict] = None,
                remove_layers: Optional[list] = None,
                seed: int = 0, device="cuda") -> VisionTransformer:
    """Build and initialise a model from ``seed`` on ``device`` (default
    the card). Weights are drawn on the CPU from a seeded
    ``torch.Generator`` and then moved, so one seed gives one model on
    every device."""
    dev = resolve_device(device)
    if model_class in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_class!r} is not ported yet: ROADMAP.md port queue A "
            f"{_NOT_PORTED[model_class]}")
    if model_class not in _VIT:
        raise ValueError(f"Unknown model class {model_class}")
    args = dict(model_args)
    args.pop("_target_", None)
    if args.pop("torch_pretrained_weights", None) or args.pop("timm_pretrained_weights", None):
        raise NotImplementedError(
            "pretrained checkpoint loading is not ported yet (ROADMAP.md port "
            "queue A item 8); load a JAX tree with models.adapters.params_from_jax")
    if noise_args:
        raise NotImplementedError("noise is not ported yet: ROADMAP.md port queue A item 10 (noise)")
    if remove_layers:
        raise NotImplementedError("layer removal (models/topology) is ROADMAP.md port queue A item 8")
    gen = torch.Generator().manual_seed(seed)
    model = VisionTransformer(**args, generator=gen)
    return model.to(dev).eval()
