"""Masked-Autoencoder ViT (counterpart of peekvit_tpu/models/maevit.py;
reference models/maevit.py).

Contract, as the JAX module:

- ``pos_embedding`` covers the patches only and is added before the
  [class tokens, registers, patches] concat;
- under ``train=True`` with ``mask_ratio > 0``, ONE permutation shared
  across the batch shuffles the patches after the pos-embedding and the
  first ``n - int(mask_ratio * n)`` are kept (JAX :148-153); the
  permutation is drawn from ``generator`` by :func:`_shuffle_permutation`
  (torch cannot reproduce JAX's draw, so a test feeds JAX's through it);
  the eval forward runs every patch;
- the encoder and the decoder are plain pre-LN block stacks with a final
  LN (eps 1e-5) and no pos-embedding inside (:62-96);
- the decoder re-embeds with ``decoder_embed`` when the hidden widths
  differ, appends mask tokens for the dropped patches and un-shuffles,
  adds ``decoder_pos_embedding``, runs ``decoder_blocks`` and maps each
  token to 3 * P * P values in (c, p1, p2) order with ``decoder_head``;
- the forward returns ``((logits, reconstruction NHWC), aux)``, aux =
  {"forward_perm", "backward_perm"} when shuffled, else {}.

A train forward drops the encoder's input tokens, attention weights and
attention outputs at ``dropout`` / ``attention_dropout`` and the decoder
stack's at ``decoder_dropout`` / ``decoder_attention_dropout`` (JAX
:48-52, :107, :127; ops/dropout.py), drawn from ``generator`` after the
shuffle. The forward takes ``noise_value`` and ignores it, as JAX's does.
Parameter names are the JAX tree's.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from peekvit_torch.models.residualvit import _dense
from peekvit_torch.models.vit import Dense
from peekvit_torch.models.vitdecoder import ViTDecoderEncoder
from peekvit_torch.ops.patch_embed import PatchEmbed, unpatchify_cmajor


# block stack + LN, no pos-embedding (reference maevit.py:62-96): the
# EncDec decoder's stack
MAEViTEncoder = ViTDecoderEncoder


def _shuffle_permutation(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The training shuffle's permutation of ``n`` patches, drawn from
    ``generator`` on its own device, then moved."""
    gen_device = generator.device if generator is not None else None
    return torch.randperm(n, generator=generator, device=gen_device).to(device)


class MAEVisionTransformer(nn.Module):
    """MAE: shuffle-drop (training) -> encode -> decode the full image.
    Primary output = (logits, reconstructed image NHWC)."""

    output_format = "logits_recon"

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, mask_ratio: float, decoder_hidden_dim: int,
                 decoder_mlp_dim: int, num_decoder_layers: int, num_decoder_heads: int,
                 decoder_dropout: float = 0.0, decoder_attention_dropout: float = 0.0,
                 dropout: float = 0.0, attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: Optional[int] = None, num_registers: int = 0,
                 num_class_tokens: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        del representation_size  # constructor parity: unused there too
        if image_size % patch_size != 0:
            raise ValueError("Input shape indivisible by patch size!")
        self.dropouts = (dropout, attention_dropout, decoder_dropout, decoder_attention_dropout)
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.mask_ratio = mask_ratio
        self.decoder_hidden_dim = decoder_hidden_dim
        self.num_decoder_heads = num_decoder_heads
        self.num_classes = num_classes
        self.num_registers = num_registers
        self.num_class_tokens = num_class_tokens
        n_patches = (image_size // patch_size) ** 2

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.pos_embedding = nn.Parameter(torch.empty(1, n_patches, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        if num_registers > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, hidden_dim))
        self.encoder = MAEViTEncoder(num_layers, num_heads, hidden_dim, mlp_dim, generator,
                                     dropout, attention_dropout)
        self.head = Dense(hidden_dim, num_classes)  # zero init
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_hidden_dim))
        self.decoder_pos_embedding = nn.Parameter(torch.empty(1, n_patches, decoder_hidden_dim))
        nn.init.normal_(self.decoder_pos_embedding, std=0.02, generator=generator)
        if decoder_hidden_dim != hidden_dim:
            self.decoder_embed = _dense(hidden_dim, decoder_hidden_dim, generator)
        self.decoder_blocks = MAEViTEncoder(num_decoder_layers, num_decoder_heads,
                                            decoder_hidden_dim, decoder_mlp_dim, generator,
                                            decoder_dropout, decoder_attention_dropout)
        self.decoder_head = _dense(decoder_hidden_dim, 3 * patch_size ** 2, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, noise_value=None):
        """(outputs, aux). ``train=True`` shuffles and drops patches with a
        permutation drawn from ``generator``, then draws the dropout masks
        from it. ``noise_value`` is taken and
        ignored, as JAX's (the MAE has no NoiseBlock: a ``noise_layer``
        fails at construction, as JAX's does)."""
        del noise_value
        n = x.shape[0]
        tokens = self.conv_proj(x) + self.pos_embedding
        n_patches = tokens.shape[1]
        aux = {}
        if self.mask_ratio > 0.0 and train:
            num_mask = int(self.mask_ratio * n_patches)
            forward_perm = _shuffle_permutation(n_patches, generator, x.device)
            aux = {"forward_perm": forward_perm, "backward_perm": torch.argsort(forward_perm)}
            tokens = tokens[:, forward_perm][:, :n_patches - num_mask]
        pieces = [self.class_tokens.expand(n, -1, -1)]
        if self.num_registers > 0:
            pieces.append(self.register_tokens.expand(n, -1, -1))
        tokens = self.encoder(torch.cat(pieces + [tokens], dim=1), train, generator)
        logits = self.head(tokens[:, :self.num_class_tokens].sum(dim=1))
        img = tokens[:, self.num_class_tokens + self.num_registers:]
        if hasattr(self, "decoder_embed"):
            img = self.decoder_embed(img)
        if aux:
            missing = n_patches - img.shape[1]
            img = torch.cat([img, self.mask_token.expand(n, missing, -1)], dim=1)
            img = img[:, aux["backward_perm"]]
        dec = self.decoder_head(self.decoder_blocks(img + self.decoder_pos_embedding, train,
                                                    generator))
        return (logits, unpatchify_cmajor(dec, self.patch_size)), aux
