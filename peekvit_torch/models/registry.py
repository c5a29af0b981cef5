"""build_model for the port (counterpart of peekvit_tpu/models/registry.py
:115-180). Every registered family is ported: the plain ViT, the
ResidualViT, the early-exit and the EncDec ResidualViT, RankViT, A-ViT,
MAE, MoE, PCT and RankPCT."""

from __future__ import annotations

from typing import Optional

import torch

from torch import nn

from peekvit_torch.models.adavit import AdaptiveVisionTransformer
from peekvit_torch.models.eeresidualvit import EEResidualVisionTransformer
from peekvit_torch.models.encdecresidualvit import ResidualVisionTransformerWithDecoder
from peekvit_torch.models.maevit import MAEVisionTransformer
from peekvit_torch.models.moevit import VisionTransformerMoE
from peekvit_torch.models.pct import PointCloudTransformer
from peekvit_torch.models.rankpct import RankPointCloudTransformer
from peekvit_torch.models.rankvit import RankVisionTransformer
from peekvit_torch.models.residualvit import ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer

# name -> class; the aliases are the JAX registry's (registry.py:32-57)
_PORTED = {
    **dict.fromkeys(("visiontransformer", "VisionTransformer", "vit"), VisionTransformer),
    **dict.fromkeys(("residualvisiontransformer", "ResidualVisionTransformer", "residualvit"),
                    ResidualVisionTransformer),
    **dict.fromkeys(("EEResidualVisionTransformer", "eeResidualVisionTransformer",
                     "eeResidualvit", "eeresidualvit"), EEResidualVisionTransformer),
    **dict.fromkeys(("ResidualVisionTransformerWithDecoder", "encdecresidualvit"),
                    ResidualVisionTransformerWithDecoder),
    **dict.fromkeys(("MAEVisionTransformer", "maevit"), MAEVisionTransformer),
    **dict.fromkeys(("visiontransformermoe", "VisionTransformerMoE", "vitmoe", "moevit",
                     "MoEVisionTransformer"), VisionTransformerMoE),
    **dict.fromkeys(("RankingVisionTransformer", "RankVisionTransformer", "rankvit"),
                    RankVisionTransformer),
    **dict.fromkeys(("AdaptiveVisionTransformer", "adavit"), AdaptiveVisionTransformer),
    **dict.fromkeys(("PointCloudTransformer", "pointcloudtransformer", "pct"),
                    PointCloudTransformer),
    **dict.fromkeys(("RankPointCloudTransformer", "rankpointcloudtransformer", "rankpct"),
                    RankPointCloudTransformer),
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
                seed: int = 0, device="cuda") -> nn.Module:
    """Build and initialise a model from ``seed`` on ``device`` (default
    the card), with the NoiseBlock of ``noise_args`` ({"layer",
    "noise_type"}, configs/noise/*.yaml) where given. Weights are drawn on the CPU from a seeded
    ``torch.Generator`` and then moved, so one seed gives one model on
    every device."""
    dev = resolve_device(device)
    if model_class not in _PORTED:
        raise ValueError(f"Unknown model class {model_class}")
    args = dict(model_args)
    args.pop("_target_", None)
    if args.pop("torch_pretrained_weights", None) or args.pop("timm_pretrained_weights", None):
        raise NotImplementedError(
            "pretrained checkpoint loading is not ported yet (ROADMAP.md port "
            "queue A item 8); load a JAX tree with models.adapters.params_from_jax")
    if noise_args:
        # the NoiseBlock as module config (JAX registry.py:137-146); its
        # value is the forward's noise_value, the 0.0 sentinel by default.
        # A family without one (MAE, PCT, RankPCT) refuses the keyword, as
        # JAX's does.
        args["noise_layer"] = noise_args.get("layer")
        args["noise_type"] = noise_args.get("noise_type", "gaussian")
    if remove_layers:
        raise NotImplementedError("layer removal (models/topology) is ROADMAP.md port queue A item 8")
    gen = torch.Generator().manual_seed(seed)
    model = _PORTED[model_class](**args, generator=gen)
    return model.to(dev).eval()
