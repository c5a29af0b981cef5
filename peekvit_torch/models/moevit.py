"""ViT with per-token top-1 Mixture-of-Experts on the MLP and/or the
attention (counterpart of peekvit_tpu/models/moevit.py; reference
models/moevit.py).

Contract, as the JAX module:

- ``TopKGate``: Dense ``gate`` -> the hard gumbel-softmax in train, the
  one-hot argmax in eval (``ops/gates.gumbel_softmax``);
- a sublayer with one expert is an ordinary ``SelfAttention`` / ``MLP``
  named ``experts_0`` and has no gate; one with E > 1 experts holds them
  in ``experts``, every leaf with a leading E axis (JAX's ``nn.vmap``:
  ``in_proj_kernel`` (E, D, 3D), ``fc1_kernel`` (E, D, M), ...), beside
  ``gating_network.gate.{kernel, bias}``;
- the experts run densely and combine through the one-hot einsum
  ``ebsd,bse->bsd``, in eval and in train;
- per-layer expert counts ``mlp_moes`` / ``attn_moes`` (1 where omitted);
- one class token, no class-token sum: the head reads token 0 after the
  final LN;
- the forward returns ``(logits, {"gating_probs": {f"layer_{i}":
  {"attn" | "mlp": probs}}})``, with only the layers that have experts
  and only their gated sublayers.

``train=True`` draws each gate's Gumbel noise from ``generator``, layer by
layer, the attention's gate before the MLP's. ``noise_layer`` puts the
NoiseBlock (ops/noise.py) before that block (JAX moevit.py:159-166),
driven by the forward's ``noise_value`` / ``noise_rng``. A train forward
drops the tokens after the pos-embedding and each attention output at
``dropout``, and a one-expert attention's weights at
``attention_dropout`` (JAX :79-93, :117, :156; ops/dropout.py), each mask
from ``generator`` in call order. A stack of attention experts drops
nothing, as in JAX: flax's ``nn.vmap`` does not pass the ``deterministic``
keyword on (moevit.py:88-95), so the vmapped experts run deterministic.
Parameter names are the JAX tree's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from peekvit_torch.models.residualvit import _dense
from peekvit_torch.models.vit import Dense, LayerNorm, check_noise_layer, noise_spec
from peekvit_torch.ops.attention import SelfAttention, multi_head_attention
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.fake_quant import rewind_sites, site_counts
from peekvit_torch.ops.gates import gumbel_softmax
from peekvit_torch.ops.mlp import MLP, lecun_normal_, mlp_forward
from peekvit_torch.ops.noise import inject_noise
from peekvit_torch.ops.patch_embed import PatchEmbed


def combine(outs: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """The dense top-1 combine: (E, B, N, D) expert outputs weighted by the
    (B, N, E) gate, summed over the experts."""
    return torch.einsum("ebsd,bse->bsd", outs, probs)


class TopKGate(nn.Module):
    def __init__(self, hidden_dim: int, num_experts: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.gate = _dense(hidden_dim, num_experts, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return gumbel_softmax(self.gate(x), generator, hard=True, train=train)


def _per_expert(fn, num_experts: int) -> torch.Tensor:
    """(E, ...): ``fn(i)`` for every expert, stacked. JAX runs the stack as
    one ``nn.vmap`` call, traced once, so its QAT sites count one layer
    for the whole stack: each expert rewinds the site counters to the
    stack's first (``ops/fake_quant.rewind_sites``)."""
    start = site_counts()
    outs = []
    for i in range(num_experts):
        rewind_sites(start)
        outs.append(fn(i))
    return torch.stack(outs)


class StackedSelfAttention(nn.Module):
    """E ``SelfAttention`` experts stacked on a leading axis (JAX's
    ``nn.vmap``); each initialised as the port's ``SelfAttention``."""

    def __init__(self, num_experts: int, hidden_dim: int, num_heads: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        e, d = num_experts, hidden_dim
        self.num_heads = num_heads
        self.in_proj_kernel = nn.Parameter(torch.empty(e, d, 3 * d))
        self.in_proj_bias = nn.Parameter(torch.zeros(e, 3 * d))
        self.out_proj_kernel = nn.Parameter(torch.empty(e, d, d))
        self.out_proj_bias = nn.Parameter(torch.zeros(e, d))
        with torch.no_grad():
            for i in range(e):
                nn.init.xavier_uniform_(self.in_proj_kernel[i], generator=generator)
                nn.init.xavier_uniform_(self.out_proj_kernel[i], generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(E, B, N, D): every expert on every token."""
        return _per_expert(lambda i: multi_head_attention(
            x, {"in_proj": {"kernel": self.in_proj_kernel[i], "bias": self.in_proj_bias[i]},
                "out_proj": {"kernel": self.out_proj_kernel[i], "bias": self.out_proj_bias[i]}},
            self.num_heads, deterministic=not self.training), self.in_proj_kernel.shape[0])


class StackedMLP(nn.Module):
    """E ``MLP`` experts stacked on a leading axis; each initialised as the
    port's ``MLP`` (lecun-normal kernels, zero biases)."""

    def __init__(self, num_experts: int, hidden_dim: int, mlp_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        e = num_experts
        self.fc1_kernel = nn.Parameter(torch.empty(e, hidden_dim, mlp_dim))
        self.fc1_bias = nn.Parameter(torch.zeros(e, mlp_dim))
        self.fc2_kernel = nn.Parameter(torch.empty(e, mlp_dim, hidden_dim))
        self.fc2_bias = nn.Parameter(torch.zeros(e, hidden_dim))
        with torch.no_grad():
            for i in range(e):
                lecun_normal_(self.fc1_kernel[i], generator)
                lecun_normal_(self.fc2_kernel[i], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _per_expert(lambda i: mlp_forward(
            x, {"fc1": {"kernel": self.fc1_kernel[i], "bias": self.fc1_bias[i]},
                "fc2": {"kernel": self.fc2_kernel[i], "bias": self.fc2_bias[i]}}),
            self.fc1_kernel.shape[0])


class MoESublayer(nn.Module):
    """``AttentionMoE`` / ``MLPMoE`` around ``experts``: one expert as
    ``experts_0``, else the gate and the stacked experts. Returns (output,
    probs or None)."""

    def __init__(self, experts: nn.Module, num_experts: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        # a one-expert attention takes the train forward's dropout (a
        # stack runs deterministic, as JAX's vmapped stack)
        self.attention = isinstance(experts, SelfAttention)
        if num_experts == 1:
            self.experts_0 = experts
        else:
            self.experts = experts
            self.gating_network = TopKGate(hidden_dim, num_experts, generator)

    def forward(self, x: torch.Tensor, train: bool, generator):
        kw = dict(train=train, generator=generator) if self.attention else {}
        if hasattr(self, "experts_0"):
            return self.experts_0(x, **kw), None
        probs = self.gating_network(x, train, generator)
        return combine(self.experts(x, **kw), probs), probs


class ViTBlockMoE(nn.Module):
    """MoE pre-LN block (reference moevit.py:106-141)."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int, mlp_num_experts: int = 1,
                 attn_num_experts: int = 1, generator: torch.Generator | None = None,
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        d, ea, em = hidden_dim, attn_num_experts, mlp_num_experts
        self.dropout = dropout
        self.ln_1 = LayerNorm(d, 1e-5)
        attn = (SelfAttention(d, num_heads, generator, attention_dropout) if ea == 1
                else StackedSelfAttention(ea, d, num_heads, generator))
        self.self_attention = MoESublayer(attn, ea, d, generator)
        self.ln_2 = LayerNorm(d, 1e-5)
        mlp = MLP(d, mlp_dim, generator) if em == 1 else StackedMLP(em, d, mlp_dim, generator)
        self.mlp = MoESublayer(mlp, em, d, generator)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None):
        y, attn_probs = self.self_attention(self.ln_1(x), train, generator)
        x = x + dropout(y, self.dropout, generator, train=train)
        z, mlp_probs = self.mlp(self.ln_2(x), train, generator)
        return x + z, {"attn": attn_probs, "mlp": mlp_probs}


class ViTEncoderMoE(nn.Module):
    """Pos-emb + MoE block stack + final LN (reference moevit.py:157-225)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, mlp_moes: Sequence[int], attn_moes: Sequence[int],
                 generator: torch.Generator | None = None, noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.dropout = dropout
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        for i in range(num_layers):
            self.add_module(f"layers_{i}", ViTBlockMoE(num_heads, hidden_dim, mlp_dim,
                                                       mlp_moes[i], attn_moes[i], generator,
                                                       dropout, attention_dropout))
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None, noise_value=None,
                noise_rng=None):
        x = dropout(x + self.pos_embedding, self.dropout, generator, train=train)
        spec = noise_spec(self.noise_layer, self.noise_type, noise_value, noise_rng)
        gating = {}
        for i in range(self.num_layers):
            x = inject_noise(x, i, spec)
            x, probs = getattr(self, f"layers_{i}")(x, train, generator)
            kept = {k: v for k, v in probs.items() if v is not None}
            if kept:
                gating[f"layer_{i}"] = kept
        return self.ln(x), gating


class VisionTransformerMoE(nn.Module):
    """MoE ViT classifier. Returns (logits, {"gating_probs": ...})."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: Optional[int] = None,
                 mlp_moes: Optional[Sequence[int]] = None,
                 attn_moes: Optional[Sequence[int]] = None, noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", generator: torch.Generator | None = None):
        super().__init__()
        del representation_size  # constructor parity: unused there too
        if image_size % patch_size != 0:
            raise ValueError("Input shape indivisible by patch size!")
        check_noise_layer(noise_layer, noise_type)
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.image_size = image_size
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.mlp_dim = mlp_dim
        self.num_classes = num_classes
        self.mlp_moes = tuple(mlp_moes) if mlp_moes else (1,) * num_layers
        self.attn_moes = tuple(attn_moes) if attn_moes else (1,) * num_layers

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + 1
        self.encoder = ViTEncoderMoE(seq_length, num_layers, num_heads, hidden_dim, mlp_dim,
                                     self.mlp_moes, self.attn_moes, generator, noise_layer,
                                     noise_type, dropout, attention_dropout)
        self.head = Dense(hidden_dim, num_classes)  # zero init

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, noise_value=None,
                noise_rng: torch.Generator | None = None):
        """(logits, aux). ``train=True`` draws the gates' Gumbel noise and the
        dropout masks from ``generator``; the NoiseBlock draws from
        ``noise_rng``."""
        n = x.shape[0]
        tokens = torch.cat([self.class_token.expand(n, -1, -1), self.conv_proj(x)], dim=1)
        tokens, gating = self.encoder(tokens, train, generator, noise_value, noise_rng)
        return self.head(tokens[:, 0]), {"gating_probs": gating}
