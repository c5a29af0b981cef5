"""Residual Vision Transformer: per-layer token gating with a budget token
(counterpart of peekvit_tpu/models/residualvit.py; reference
models/residualvit.py): the eval forward and the train forward
(``train=True``) the Trainer's module path runs. The early-exit variant
is models/eeresidualvit.py; its exit heads live in this file's encoder.

Behavioural contract, as the JAX modules:

- ``ResidualGate``: Dense(1) ``projection`` -> gumbel gate (train: the
  straight-through gumbel-sigmoid; eval: round(sigmoid)) or sigmoid gate
  pushed toward {0, 1} by ``relu(mask - (1 - budget))`` or
  ``relu(mask - threshold)``.
- ``ResidualViTBlock`` skip modes 'attention', 'mlp', 'attention+mlp' and
  plain, LN eps 1e-6. The masked-LN trick ``mask * ln(x)`` keeps gated
  tokens exactly zero through the block (residualvit.py:175-183); gated
  tokens still take part in attention as keys. The 'attention' and 'mlp'
  modes drop the final residual like the reference.
- The budget token is the LAST token: the budget as a constant fill,
  'learnable' (embedding * budget) or 'learnable_interpolate' (a lerp of
  two embeddings). Non-'learnable' modes gate on the mean of the WHOLE
  batch's budget token (a scalar, residualvit.py:208), over the global
  batch under data parallelism (ops/global_batch.batch_mean).
- The pos-embedding skips the budget token (JAX :283-288).
- Under ``train=True`` a budget is drawn per sample (JAX :408-417): a
  float ``add_budget_token`` is the constant, a list or tuple a uniform
  choice, anything else uniform over ``budget_interval``; a given
  ``budget`` is broadcast instead. The draws come from ``generator``
  (budgets first, then each gumbel gate in layer order), as are the
  dropout masks: the tokens after the pos-embedding, each block's
  attention weights and attention output (JAX :135-171, :289;
  ops/dropout.py).
- ``noise_layer`` puts the NoiseBlock (ops/noise.py) before that block,
  over the whole stream, the budget token included (JAX :294-301); the
  forward's ``noise_value`` / ``noise_rng`` drive it (models/vit.py).
- ``forward`` returns ``(logits, aux)``, aux = {"masks": {"layer_i":
  (B, N_img, 1)}, "current_budget": ...}; the early-exit model returns the
  tuple ``(exit_0, ..., exit_{L-1}, final)`` in place of the logits, its
  exit heads ``early_exit_heads_{i}_ln`` / ``_head`` on the class token.

Parameter names and layouts are the JAX trees', as in models/vit.py.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from peekvit_torch.models.vit import Dense, LayerNorm, check_noise_layer, noise_spec
from peekvit_torch.ops.attention import SelfAttention
from peekvit_torch.ops.dropout import dropout
from peekvit_torch.ops.gates import gumbel_sigmoid, hard_sigmoid_eval, sigmoid_with_temp
from peekvit_torch.ops.global_batch import batch_mean, per_sample
from peekvit_torch.ops.mlp import MLP, lecun_normal_
from peekvit_torch.ops.noise import inject_noise
from peekvit_torch.ops.patch_embed import PatchEmbed

def _dense(in_dim: int, out_dim: int, generator) -> Dense:
    """A linen nn.Dense: lecun-normal kernel, zero bias."""
    layer = Dense(in_dim, out_dim)
    with torch.no_grad():
        lecun_normal_(layer.kernel, generator)
    return layer


def sample_budgets(model, batch: int, generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
    """Per-sample training budgets of a ResidualViT, (batch,) fp32 on
    ``device`` (JAX residualvit.py:408-417, training/fused.py:273-283): a
    float ``add_budget_token`` is the constant; a list or tuple, a uniform
    choice; anything else, uniform over ``budget_interval``. Drawn from
    ``generator`` on its own device, then moved; over the global batch
    under data parallelism (ops/global_batch.per_sample)."""
    bt = model.add_budget_token
    if isinstance(bt, float):
        return torch.full((batch,), bt, dtype=torch.float32, device=device)
    gen_device = generator.device if generator is not None else None
    if isinstance(bt, (list, tuple)):
        idx = per_sample(lambda s: torch.randint(len(bt), s, generator=generator,
                                                 device=gen_device), (batch,))
        return torch.tensor(bt, dtype=torch.float32, device=gen_device)[idx].to(device)
    lo, hi = getattr(model, "budget_interval", (0.0, 1.0))
    u = per_sample(lambda s: torch.rand(s, generator=generator, device=gen_device), (batch,))
    return (u * (hi - lo) + lo).to(device)


class ResidualGate(nn.Module):
    """Token gate: Dense(1) projection -> gumbel/sigmoid gate -> mask. The
    scalar ``threshold`` parameter exists where linen creates it: a
    sigmoid gate with threshold 'learnable' that is given neither a budget
    nor a threshold (``own_threshold``, a block without a budget token)."""

    def __init__(self, hidden_dim: int, threshold: Union[float, str] = 0.5, temp: float = 1.0,
                 gate_type: str = "gumbel", sigmoid_bias: float = 10.0,
                 own_threshold: bool = True, generator=None):
        super().__init__()
        if gate_type not in ("gumbel", "sigmoid"):
            raise ValueError(f"Unknown gate type {gate_type}")
        self.gate_type = gate_type
        self.temp = temp
        self.sigmoid_bias = sigmoid_bias
        self.fixed_threshold = threshold
        self.projection = _dense(hidden_dim, 1, generator)
        if gate_type == "sigmoid" and threshold == "learnable" and own_threshold:
            self.threshold = nn.Parameter(torch.tensor(0.5))

    def forward(self, x, budget=None, threshold=None, train: bool = False, generator=None):
        if budget is not None and threshold is not None:
            raise ValueError("Cannot specify both budget and threshold")
        logits = self.projection(x)
        if self.gate_type == "gumbel":
            if budget is not None:
                raise ValueError("Gumbel gate does not support budget")
            if train:
                return gumbel_sigmoid(logits, generator, tau=self.temp, bias=self.sigmoid_bias)
            return hard_sigmoid_eval(logits)
        mask = sigmoid_with_temp(logits, self.temp, self.sigmoid_bias)
        if budget is not None:
            return torch.relu(mask - (1.0 - budget))
        if threshold is not None:
            return torch.relu(mask - threshold)
        thr = self.threshold if self.fixed_threshold == "learnable" else self.fixed_threshold
        return torch.relu(mask - thr)


class ResidualViTBlock(nn.Module):
    """Gated transformer block (reference residualvit.py:81-273). LN eps 1e-6."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int, temp: float = 1.0,
                 add_input: bool = False, num_class_tokens: int = 1, num_registers: int = 0,
                 skip: Optional[str] = None, gate_type: str = "gumbel", gate_bias: float = 10.0,
                 gate_threshold: Union[float, str] = 0.5, budget_token: Any = False,
                 ln_eps: float = 1e-6, generator=None, dropout: float = 0.0,
                 attention_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        if skip == "attention" and budget_token:
            raise ValueError("skip='attention' with a budget token is inconsistent in the "
                             "spec (reference crashes); use 'attention+mlp'.")
        self.skip = skip
        self.add_input = add_input
        self.num_special_tokens = num_class_tokens + num_registers
        self.budget_token = budget_token
        if skip in ("attention", "mlp", "attention+mlp"):
            self.residual_gate = ResidualGate(hidden_dim, gate_threshold, temp, gate_type,
                                              gate_bias, own_threshold=not budget_token,
                                              generator=generator)
        self.ln_1 = LayerNorm(hidden_dim, ln_eps)
        self.self_attention = SelfAttention(hidden_dim, num_heads, generator, attention_dropout)
        self.ln_2 = LayerNorm(hidden_dim, ln_eps)
        self.mlp = MLP(hidden_dim, mlp_dim, generator)
        if budget_token == "learnable":
            self.budget_token_gate = _dense(hidden_dim, 1, generator)

    def _split(self, tokens):
        """-> (special, img, budget_token or None)."""
        s = self.num_special_tokens
        if self.budget_token:
            return tokens[:, :s], tokens[:, s:-1], tokens[:, -1:]
        return tokens[:, :s], tokens[:, s:], None

    def _gate(self, img, budget_token, train, generator):
        current_budget = threshold = None
        if self.budget_token == "learnable":
            threshold = torch.sigmoid(self.budget_token_gate(budget_token))
        elif self.budget_token:
            current_budget = batch_mean(budget_token)  # the whole batch's (reference quirk)
        return self.residual_gate(img, budget=current_budget, threshold=threshold, train=train,
                                  generator=generator)

    def _with_budget(self, special, img, budget_token):
        parts = [special, img] + ([budget_token] if self.budget_token else [])
        return torch.cat(parts, dim=1)

    def _add_input(self, y, special, img, mask, budget_token):
        if not self.add_input:
            return y
        pad = [torch.zeros_like(special), (1.0 - mask) * img]
        if self.budget_token:
            pad.append(torch.zeros_like(budget_token))
        return y + torch.cat(pad, dim=1)

    def _attn(self, x, train, generator):
        """The attention sublayer (attention dropout inside) before the
        dropout on its output (JAX :165-171)."""
        return self.self_attention(x, train=train, generator=generator)

    def _drop(self, x, train, generator):
        return dropout(x, self.dropout, generator, train=train)

    def plain_forward(self, tokens, mask=None, train: bool = False, generator=None):
        m = 1.0 if mask is None else mask
        x = m * self._attn(m * self.ln_1(tokens), train, generator)
        x = self._drop(x, train, generator) + tokens
        return x + self.mlp(m * self.ln_2(x))

    def forward(self, tokens, train: bool = False, generator=None):
        """-> (tokens, mask or None); mask is (B, N_img, 1)."""
        if self.skip == "attention":
            special, img, _ = self._split(tokens)
            mask = self._gate(img, None, train, generator)
            x = self._attn(self.ln_1(torch.cat([special, mask * img], dim=1)), train, generator)
            x = self._drop(x, train, generator) + tokens
            return self.mlp(self.ln_2(x)), mask  # literal: final residual dropped
        if self.skip == "mlp":
            x = self._drop(self._attn(self.ln_1(tokens), train, generator), train,
                           generator) + tokens
            special, img, budget_token = self._split(x)
            mask = self._gate(img, budget_token, train, generator)
            y = self.mlp(self.ln_2(self._with_budget(special, mask * img, budget_token)))
            return self._add_input(y, special, img, mask, budget_token), mask
        if self.skip == "attention+mlp":
            special, img, budget_token = self._split(tokens)
            mask = self._gate(img, budget_token, train, generator)
            ones = torch.ones((mask.shape[0], self.num_special_tokens, 1), dtype=mask.dtype,
                              device=mask.device)
            fwd_mask = self._with_budget(ones, mask, ones[:, :1])
            y = self.plain_forward(self._with_budget(special, mask * img, budget_token),
                                   fwd_mask, train, generator)
            return self._add_input(y, special, img, mask, budget_token), mask
        return self.plain_forward(tokens, None, train, generator), None


class ResidualViTEncoder(nn.Module):
    """Pos-emb (budget token excluded) + gated blocks + final LN (reference
    residualvit.py:278-348). With ``early_exit_classes`` each layer also
    gets an LN -> Dense exit head on the class token (eeresidualvit.py:75-76)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int, hidden_dim: int,
                 mlp_dim: int, residual_layers=None, add_input: bool = False,
                 num_class_tokens: int = 1, num_registers: int = 0, gate_type: str = "gumbel",
                 gate_temp: float = 1.0, gate_bias: float = 10.0,
                 gate_threshold: Union[float, str] = 0.5, budget_token: Any = False,
                 early_exit_classes: Optional[int] = None, generator=None,
                 noise_layer: Optional[int] = None, noise_type: str = "gaussian",
                 dropout: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.noise_layer = noise_layer
        self.noise_type = noise_type
        self.num_class_tokens = num_class_tokens
        self.budget_token = budget_token
        self.early_exits = early_exit_classes is not None
        self.pos_embedding = nn.Parameter(torch.empty(1, seq_length, hidden_dim))
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)
        residual_layers = residual_layers or ["attention+mlp"] * num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", ResidualViTBlock(
                num_heads, hidden_dim, mlp_dim, temp=gate_temp, add_input=add_input,
                num_class_tokens=num_class_tokens, num_registers=num_registers,
                skip=residual_layers[i], gate_type=gate_type, gate_bias=gate_bias,
                gate_threshold=gate_threshold, budget_token=budget_token, generator=generator,
                dropout=dropout, attention_dropout=attention_dropout))
            if self.early_exits:
                self.add_module(f"early_exit_heads_{i}_ln", LayerNorm(hidden_dim, 1e-5))
                self.add_module(f"early_exit_heads_{i}_head",
                                _dense(hidden_dim, early_exit_classes, generator))
        self.ln = LayerNorm(hidden_dim, 1e-5)

    def forward(self, tokens, train: bool = False, generator=None, noise_value=None,
                noise_rng=None):
        """-> (tokens after the final LN, early exits (a list, empty without
        exit heads), masks)."""
        if self.budget_token:
            tokens = torch.cat([tokens[:, :-1] + self.pos_embedding, tokens[:, -1:]], dim=1)
        else:
            tokens = tokens + self.pos_embedding
        tokens = dropout(tokens, self.dropout, generator, train=train)
        spec = noise_spec(self.noise_layer, self.noise_type, noise_value, noise_rng)
        masks, exits = {}, []
        for i in range(self.num_layers):
            tokens = inject_noise(tokens, i, spec)
            tokens, mask = getattr(self, f"layers_{i}")(tokens, train, generator)
            if mask is not None:
                masks[f"layer_{i}"] = mask
            if self.early_exits:
                cls = getattr(self, f"early_exit_heads_{i}_ln")(tokens[:, :self.num_class_tokens])
                exits.append(getattr(self, f"early_exit_heads_{i}_head")(cls).squeeze(1))
        return self.ln(tokens), exits, masks


class ResidualVisionTransformer(nn.Module):
    """ResidualViT classifier. Returns (logits, aux) with aux['masks'] and
    aux['current_budget'] ((B,) budgets)."""

    early_exits = False
    # 'learnable' allocates learnable_budget_token_2 too (the early-exit and
    # EncDec references, :217-219)
    both_budget_tokens = False

    def __init__(self, image_size: int, patch_size: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, num_classes: int = 1000,
                 representation_size: Optional[int] = None, num_registers: int = 0,
                 residual_layers=None, add_input: bool = False, num_class_tokens: int = 1,
                 gate_type: str = "gumbel", gate_temp: float = 1.0, gate_bias: float = 10.0,
                 gate_threshold: Union[float, str] = 0.5, add_budget_token: Any = False,
                 budget_interval: tuple = (0, 1), noise_layer: Optional[int] = None,
                 noise_type: str = "gaussian", generator: torch.Generator | None = None):
        super().__init__()
        # constructor parity with the JAX module: there is no representation head
        del representation_size
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
        self.num_registers = num_registers
        self.num_class_tokens = num_class_tokens
        self.residual_layers = list(residual_layers) if residual_layers else None
        self.add_input = add_input
        self.gate_type = gate_type
        self.gate_temp = gate_temp
        self.gate_bias = gate_bias
        self.gate_threshold = gate_threshold
        self.add_budget_token = add_budget_token
        self.budget_interval = tuple(budget_interval)

        self.conv_proj = PatchEmbed(hidden_dim, patch_size, generator=generator)
        self.class_tokens = nn.Parameter(torch.zeros(1, num_class_tokens, hidden_dim))
        if num_registers > 0:
            self.register_tokens = nn.Parameter(torch.zeros(1, num_registers, hidden_dim))
        seq_length = (image_size // patch_size) ** 2 + num_class_tokens + num_registers
        self.encoder = ResidualViTEncoder(
            seq_length, num_layers, num_heads, hidden_dim, mlp_dim, self.residual_layers,
            add_input, num_class_tokens, num_registers, gate_type, gate_temp, gate_bias,
            gate_threshold, add_budget_token,
            early_exit_classes=num_classes if self.early_exits else None, generator=generator,
            noise_layer=noise_layer, noise_type=noise_type, dropout=dropout,
            attention_dropout=attention_dropout)
        learnable = add_budget_token in ("learnable", "learnable_interpolate")
        if learnable:
            self.learnable_budget_token_1 = nn.Parameter(torch.empty(1, 1, hidden_dim))
            nn.init.normal_(self.learnable_budget_token_1, std=1.0, generator=generator)
        if add_budget_token == "learnable_interpolate" or (learnable and self.both_budget_tokens):
            self.learnable_budget_token_2 = nn.Parameter(torch.empty(1, 1, hidden_dim))
            nn.init.normal_(self.learnable_budget_token_2, std=1.0, generator=generator)
        self.head = Dense(hidden_dim, num_classes)  # zero init

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> [class tokens, registers, patches]."""
        n = x.shape[0]
        pieces = [self.class_tokens.expand(n, -1, -1)]
        if self.num_registers > 0:
            pieces.append(self.register_tokens.expand(n, -1, -1))
        return torch.cat(pieces + [self.conv_proj(x)], dim=1)

    def _budget_token(self, budget_vec: torch.Tensor) -> torch.Tensor:
        """(B,) budgets -> (B, 1, D) budget token (residualvit.py:552-585)."""
        b = budget_vec[:, None, None]
        if self.add_budget_token == "learnable":
            return self.learnable_budget_token_1 * b
        if self.add_budget_token == "learnable_interpolate":
            return self.learnable_budget_token_1 * b + self.learnable_budget_token_2 * (1.0 - b)
        return torch.zeros(budget_vec.shape[0], 1, self.hidden_dim, device=b.device) + b

    def _current_budget(self, budget, n: int, train: bool, generator, device) -> torch.Tensor:
        """The aux budget: (n,) per sample (drawn under ``train`` when no
        budget is given)."""
        if train and budget is None:
            return sample_budgets(self, n, generator, device)
        if budget is None:
            raise ValueError("Budget not set. Call set_budget() (or pass budget=) before "
                             "evaluating this model.")
        return torch.broadcast_to(torch.as_tensor(budget, dtype=torch.float32, device=device),
                                  (n,))

    def forward(self, x: torch.Tensor, budget=None, train: bool = False,
                generator: torch.Generator | None = None, noise_value=None,
                noise_rng: torch.Generator | None = None):
        """(outputs, aux). ``train=True`` draws the budgets (when ``budget``
        is None), the gumbel gates' noise and the dropout masks from
        ``generator``; the NoiseBlock draws from ``noise_rng``."""
        tokens = self.embed(x)
        n = tokens.shape[0]
        current_budget = None
        if self.add_budget_token:
            current_budget = self._current_budget(budget, n, train, generator, x.device)
            budget_vec = torch.broadcast_to(current_budget, (n,))
            tokens = torch.cat([tokens, self._budget_token(budget_vec)], dim=1)
        tokens, exits, masks = self.encoder(tokens, train, generator, noise_value, noise_rng)
        logits = self.head(tokens[:, :self.num_class_tokens].sum(dim=1))
        aux = {"masks": masks}
        if current_budget is not None:
            aux["current_budget"] = current_budget
        return self._outputs(tokens, logits, exits, masks, train, generator), aux

    def _outputs(self, tokens, logits, exits, masks, train, generator):
        """The primary output from the final tokens, the logits, the early
        exits and the gate masks: the logits, or the tuple of exits and
        logits of an early-exit model (``train`` / ``generator`` for a
        decoder's dropout)."""
        return tuple(exits) + (logits,) if self.early_exits else logits
