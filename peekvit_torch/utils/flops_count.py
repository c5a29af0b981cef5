"""Analytic MACs of the plain ViT (counterpart of
peekvit_tpu/utils/flops_count.py:42-99, dense case only).

Counted terms mirror the reference hooks: patch-embed conv, qkv and out
projections, the QK^T and PV products, the MLP, the head on the summed
class tokens. LayerNorm/GELU/softmax elementwise terms are excluded.
FLOPs = 2 x MACs.
"""

from __future__ import annotations


def _encoder_layer_macs(n: float, d: int, m: int) -> float:
    """MACs of one pre-LN transformer block at n tokens."""
    return 4 * n * d * d + 2 * n * n * d + 2 * n * d * m


def analytic_macs(module) -> float:
    """Per-image MACs of a plain ViT module (every token in every layer)."""
    d, m, p = module.hidden_dim, module.mlp_dim, module.patch_size
    n_patches = (module.image_size // p) ** 2
    seq = n_patches + module.num_class_tokens + module.num_registers
    macs = n_patches * d * (p * p * 3)
    macs += module.num_layers * _encoder_layer_macs(seq, d, m)
    return macs + d * module.num_classes
