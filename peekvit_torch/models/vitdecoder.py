"""Token -> image ViT decoder (counterpart of peekvit_tpu/models/vitdecoder.py;
reference models/vitdecoder.py), the EncDec ResidualViT's reconstruction
head.

Contract, as the JAX module: the gate mask is softly binarised,
``m = sigmoid(mask * 100)``, and a gated-off token is replaced by the
learned ``mask_token`` (tokens * m + mask_token * (1 - m)); the
pos-embedding has ``seq_length - 1`` rows (the image tokens of the
one-class-token layout) and is added once, before the blocks; the blocks
are plain pre-LN ViT blocks with LN eps 1e-5 and no pos-embedding of
their own, then the final LN; a Dense ``head`` maps each token to
3 * P * P values in (c, p1, p2) order, folded back to an NHWC image. The
mask image broadcasts the mask's first channel over each patch (JAX
:96-103).

A train forward drops the stack's input tokens, each block's attention
weights and attention output at the decoder's own rates (JAX
vitdecoder.py:38-45, :84-85; ops/dropout.py).

Parameter names are the JAX tree's: ``mask_token``, ``pos_embedding``,
``encoder.layers_i``, ``encoder.ln``, ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from peekvit_torch.models.residualvit import _dense
from peekvit_torch.models.vit import LayerNorm, ViTBlock
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.patch_embed import mask_image, unpatchify_cmajor


class ViTDecoderEncoder(nn.Module):
    """Block stack + LN (eps 1e-5), no pos-embedding (reference
    vitdecoder.py:21-58). Layers are ``layers_0 .. layers_{L-1}``."""

    def __init__(self, num_layers: int, num_heads: int, hidden_dim: int, mlp_dim: int,
                 generator: torch.Generator | None = None, dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        for i in range(num_layers):
            self.add_module(f"layers_{i}",
                            ViTBlock(num_heads, hidden_dim, mlp_dim, generator=generator,
                                     dropout=dropout, attention_dropout=attention_dropout))
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(x, self.dropout, generator, train=train)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, train=train, generator=generator)
        return self.ln(x)


class VisionTransformerDecoder(nn.Module):
    """(tokens (B, N_img, D), gate mask (B, N_img, 1)) -> (image NHWC,
    mask image (B, H, W, 1))."""

    def __init__(self, image_size: int, patch_size: int, hidden_dim: int, mlp_dim: int,
                 seq_length: int, num_layers: int, num_heads: int,
                 generator: torch.Generator | None = None, dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.mask_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        # seq_length counts the class token (the reference's API)
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length - 1, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        self.encoder = ViTDecoderEncoder(num_layers, num_heads, hidden_dim, mlp_dim, generator,
                                         dropout, attention_dropout)
        self.head = _dense(hidden_dim, 3 * patch_size ** 2, generator)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None):
        m = torch.sigmoid(mask * 100.0).expand(tokens.shape)  # soft binarisation (:98-100)
        tokens = tokens * m + self.mask_token * (1.0 - m) + self.pos_embedding
        img = unpatchify_cmajor(self.head(self.encoder(tokens, train, generator)),
                                self.patch_size)
        return img, mask_image(m, self.patch_size)
