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


def accepts_budget(model: nn.Module) -> bool:
    """Whether the family takes a token budget (the JAX modules'
    ``accepts_budget``): the ResidualViT family, RankViT and RankPCT."""
    return isinstance(model, (ResidualVisionTransformer, RankVisionTransformer,
                              RankPointCloudTransformer))


def build_model(model_class: str, model_args: dict,
                noise_args: Optional[dict] = None,
                remove_layers: Optional[list] = None,
                seed: int = 0, device="cuda") -> nn.Module:
    """Build and initialise a model from ``seed`` on ``device`` (default
    the card), as JAX's build_model (registry.py:115-180):

    - the NoiseBlock of ``noise_args`` ({"layer", "noise_type"},
      configs/noise/*.yaml) where given;
    - ``torch_pretrained_weights`` / ``timm_pretrained_weights`` in
      ``model_args``: a local ``.pth`` merged in by
      ``adapters.load_pretrained`` (a hub name raises);
    - ``remove_layers``: those encoder blocks taken out
      (``topology.remove_layers_and_stitch``).

    Weights are drawn on the CPU from a seeded ``torch.Generator`` and then
    moved, so one seed gives one model on every device. The module records
    ``model_class``, ``model_args`` (without ``_target_`` and the
    pretrained paths) and ``noise_args``, which a checkpoint's metadata
    holds (utils/checkpoint.py)."""
    dev = resolve_device(device)
    if model_class not in _PORTED:
        raise ValueError(f"Unknown model class {model_class}")
    model_args = dict(model_args)
    model_args.pop("_target_", None)
    torch_w = model_args.pop("torch_pretrained_weights", None)
    timm_w = model_args.pop("timm_pretrained_weights", None)
    args = dict(model_args)
    if noise_args:
        # the NoiseBlock as module config (JAX registry.py:137-146); its
        # value is the forward's noise_value, the 0.0 sentinel by default.
        # A family without one (MAE, PCT, RankPCT) refuses the keyword, as
        # JAX's does.
        args["noise_layer"] = noise_args.get("layer")
        args["noise_type"] = noise_args.get("noise_type", "gaussian")
    gen = torch.Generator().manual_seed(seed)
    model = _PORTED[model_class](**args, generator=gen).to(dev).eval()
    model.model_class = model_class
    model.model_args = model_args
    model.noise_args = dict(noise_args) if noise_args else None
    if torch_w is not None or timm_w is not None:
        from peekvit_torch.models.adapters import load_pretrained

        model = load_pretrained(model, torch_w, timm_w)
    if remove_layers:
        from peekvit_torch.models.topology import remove_layers_and_stitch

        model = remove_layers_and_stitch(model, remove_layers)
    return model
