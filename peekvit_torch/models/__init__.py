"""Models of the port (plain ViT) and weight adapters."""

from peekvit_torch.models.registry import build_model

__all__ = ["build_model"]
