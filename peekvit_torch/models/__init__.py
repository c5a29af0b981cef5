"""Models of the port (plain ViT, ResidualViT, early-exit ResidualViT,
RankViT, A-ViT, PCT, RankPCT) and weight adapters."""

from peekvit_torch.models.registry import build_model

__all__ = ["build_model"]
