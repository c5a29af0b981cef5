"""ResidualViT encoder + ViT decoder reconstructing the input image from the
gated tokens (counterpart of peekvit_tpu/models/encdecresidualvit.py;
reference models/encdecresidualvit.py).

Contract, as the JAX module: classification logits from the summed class
tokens; the decoder (models/vitdecoder.py) sees the image tokens after the
encoder's final LN, ``tokens[:, c + r : -1]`` (class, register and budget
tokens stripped, :329-333), with the LAST layer's gate mask (:336). The
forward returns ``((logits, reconstruction NHWC, mask image), aux)``, aux =
{"masks", "current_budget"}, with ONE budget per batch (:245-301; drawn
under ``train=True`` as the early-exit model draws it); a train forward
drops at the encoder's rates and, in the decoder, at ``decoder_dropout`` /
``decoder_attention_dropout`` (JAX :93-94, :129-130). A falsy
``add_budget_token`` is refused at construction (JAX :68-72: the token
slicing needs the budget token).

One difference, where the JAX module cannot run: when
``decoder_hidden_dim`` differs from ``hidden_dim`` the JAX decoder mixes
hidden-wide tokens with a decoder-wide mask token and raises a shape
error at construction, which the shipped
``configs/model/residualvitwithdecoder.yaml`` (256 -> 192) hits. Here a
Dense ``decoder_embed`` (lecun-normal, zero bias) bridges the widths
before the decoder, the fix the JAX MAE applies to the same mismatch
(peekvit_tpu/models/maevit.py). At equal widths there is no
``decoder_embed`` and the tree is the JAX tree.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from peekvit_torch.models.eeresidualvit import EEResidualVisionTransformer
from peekvit_torch.models.residualvit import ResidualVisionTransformer, _dense
from peekvit_torch.models.vitdecoder import VisionTransformerDecoder


class ResidualVisionTransformerWithDecoder(ResidualVisionTransformer):
    """Primary output = (logits, reconstructed images, reconstruction mask)."""

    both_budget_tokens = True
    output_format = "logits_recon_mask"
    _current_budget = EEResidualVisionTransformer._current_budget  # one budget per batch

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, add_budget_token: Any = True,
                 sample_budget: Any = False, decoder_hidden_dim: Optional[int] = None,
                 decoder_num_layers: Optional[int] = None,
                 decoder_num_heads: Optional[int] = None, decoder_mlp_dim: Optional[int] = None,
                 decoder_dropout: float = 0.0, decoder_attention_dropout: float = 0.0,
                 generator: torch.Generator | None = None, **kwargs):
        del sample_budget  # constructor parity: unused in the reference too
        if not add_budget_token:
            raise ValueError(
                "ResidualVisionTransformerWithDecoder requires add_budget_token (SURVEY.md "
                "section 7.7: the reference's token slicing is broken without it).")
        super().__init__(image_size, patch_size, num_layers, num_heads, hidden_dim, mlp_dim,
                         add_budget_token=add_budget_token, generator=generator, **kwargs)
        self.decoder_hidden_dim = decoder_hidden_dim or hidden_dim
        self.decoder_num_layers = decoder_num_layers or num_layers
        self.decoder_num_heads = decoder_num_heads or num_heads
        self.decoder_mlp_dim = decoder_mlp_dim or mlp_dim
        self.decoder_dropout = decoder_dropout
        self.decoder_attention_dropout = decoder_attention_dropout
        seq_length = ((image_size // patch_size) ** 2 + self.num_class_tokens
                      + self.num_registers)
        if self.decoder_hidden_dim != hidden_dim:
            self.decoder_embed = _dense(hidden_dim, self.decoder_hidden_dim, generator)
        self.decoder = VisionTransformerDecoder(
            image_size, patch_size, self.decoder_hidden_dim, self.decoder_mlp_dim, seq_length,
            self.decoder_num_layers, self.decoder_num_heads, generator, decoder_dropout,
            decoder_attention_dropout)

    def _outputs(self, tokens, logits, exits, masks, train, generator):
        img = tokens[:, self.num_class_tokens + self.num_registers:-1]
        if hasattr(self, "decoder_embed"):
            img = self.decoder_embed(img)
        recon, recon_mask = self.decoder(img, masks[f"layer_{self.num_layers - 1}"], train,
                                         generator)
        return logits, recon, recon_mask
