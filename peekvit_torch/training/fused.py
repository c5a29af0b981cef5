"""Fused mixed-precision training paths for the plain ViT and the gated
ResidualViT (counterpart of peekvit_tpu/training/fused.py).

The attention sublayer runs forward and backward through the trainable
block over CUDA kernels (ops/cuda/fused_attention_vjp.py); the MLP half,
the weight-gradient products and the optimizer stay plain PyTorch, as the
JAX package leaves them to XLA. Master params stay fp32; the forward casts
them to the compute dtype and their gradients flow back through the cast
in fp32.

``residualvit_forward_trainable`` runs the masked block
(``masked_attention_block_trainable``) the same way, the sigmoid gates in
fp32 plain torch and their gradients flowing back through the block's
mask cotangent.

On the card the kernels take head dims 32 and 64 at any token count
(``attn_softmax_fwd`` / ``_bwd`` take the key-tiled kernels past the
wgmma kernels' 256 tokens), so every shipped training config runs here;
``Trainer`` holds a model's shapes to the kernels' limits at
construction (``training.trainer.fused_train_limit``).

``merged=True`` runs each layer through the merged layer VJP
(``layer_block_trainable``, ops/cuda/fused_layer_vjp.py: the whole layer
forward and backward on CUDA kernels, every weight gradient included) and
``merged="hybrid"`` through its merged forward with a torch backward
(``layer_block_hybrid``); the JAX package keeps both as measured
negatives of the split path (its default, ``merged="auto"``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from peekvit_torch.inference import _classify, _embed, _layer_ids, _layer_norm
from peekvit_torch.models.adapters import live_params
from peekvit_torch.models.residualvit import sample_budgets
from peekvit_torch.ops.global_batch import batch_mean
from peekvit_torch.ops.cuda.fused_attention_vjp import (
    attention_block_trainable,
    attention_block_trainable_ref,
    masked_attention_block_trainable,
    masked_attention_block_trainable_ref,
)
from peekvit_torch.ops.cuda.fused_layer_vjp import (
    layer_block_hybrid,
    layer_block_hybrid_ref,
    layer_block_trainable,
    layer_block_trainable_ref,
)

__all__ = ["make_fused_train_step", "residual_forward_fn", "residualvit_forward_trainable",
           "sample_budgets", "trainable_forward_fn", "vit_forward_trainable"]


def vit_forward_trainable(params, images, *, patch_size: int, num_heads: int,
                          num_class_tokens: int = 1, num_registers: int = 0,
                          ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                          remat: bool = False, merged="auto", save_qkv="auto",
                          plain: bool = False) -> torch.Tensor:
    """Differentiable forward of a plain ViT from its live param tree
    (``models.adapters.live_params``). images: (B, H, W, 3). Returns fp32
    logits. No dropout paths: the reference ViT configs train with 0.0.

    - ``merged`` (fused.py:80-95): ``"auto"`` / False the split path
      (the attention block + an eager MLP), True the merged layer VJP,
      ``"hybrid"`` the merged forward with a torch backward. On the card
      the merged layers take bf16 only (fp32 is ROADMAP.md port queue B
      item 15).
    - ``save_qkv="auto"`` means ``not remat`` (fused.py:97-105): the
      backward reads the forward's qkv instead of recomputing it.
    - ``remat=True`` checkpoints each split-path layer
      (``torch.utils.checkpoint``, non-reentrant): the backward re-runs the
      layer's forward and then the recompute backward. The merged
      backward already recomputes the layer, so it is a no-op there.
    - The split MLP is LN -> fc1 -> tanh-gelu -> fc2 -> residual, as
      fused.py:116-121 (``jax.nn.gelu``'s default is the tanh form; the
      model's own MLP, ops/mlp.py, keeps erf like linen).
    - ``plain=True`` runs the blocks on their plain versions whatever the
      device: the reference the kernels are held against on the card.
    """
    if merged not in ("auto", False, True, "hybrid"):
        raise ValueError(f"merged must be 'auto', False, True or 'hybrid', got {merged!r}")
    if merged == "auto":
        merged = False  # the split path, JAX's measured best
    if merged and images.is_cuda and compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the merged layer's CUDA kernels take bf16 only; fp32 on the card is ROADMAP.md "
            "port queue B item 15 (fp32 on CUDA)")
    if save_qkv == "auto":
        save_qkv = not remat

    def cast(t):
        return t.to(compute_dtype)

    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])

    if merged:
        if merged == "hybrid":
            merged_block = layer_block_hybrid_ref if plain else layer_block_hybrid
        else:
            merged_block = layer_block_trainable_ref if plain else layer_block_trainable
        for i in _layer_ids(enc):
            lp = enc[f"layers_{i}"]
            at, mlp = lp["self_attention"], lp["mlp"]
            tokens = merged_block(
                tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
                cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
                cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]),
                cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                cast(mlp["fc1_kernel"]), cast(mlp["fc1_bias"]),
                cast(mlp["fc2_kernel"]), cast(mlp["fc2_bias"]), num_heads, ln_eps)
        return _classify(params, tokens, num_class_tokens, cast, ln_eps)

    block = attention_block_trainable_ref if plain else attention_block_trainable

    def layer(tokens, lp):
        at = lp["self_attention"]
        tokens = block(
            tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
            cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
            cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]),
            num_heads, ln_eps, save_qkv)
        mlp = lp["mlp"]
        z = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]), ln_eps)
        z = F.gelu(z @ cast(mlp["fc1_kernel"]) + cast(mlp["fc1_bias"]), approximate="tanh")
        return tokens + (z @ cast(mlp["fc2_kernel"]) + cast(mlp["fc2_bias"]))

    for i in _layer_ids(enc):
        lp = enc[f"layers_{i}"]
        tokens = (checkpoint(layer, tokens, lp, use_reentrant=False) if remat
                  else layer(tokens, lp))
    return _classify(params, tokens, num_class_tokens, cast, ln_eps)


def trainable_forward_fn(model, **kwargs):
    """``vit_forward_trainable`` bound to a VisionTransformer's shape
    arguments; ``kwargs`` are its keyword options."""
    return functools.partial(
        vit_forward_trainable, patch_size=model.patch_size, num_heads=model.num_heads,
        num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
        ln_eps=model.ln_eps, **kwargs)


def residualvit_forward_trainable(params, images, budget_vec, *, patch_size: int,
                                  num_heads: int, num_class_tokens: int = 1,
                                  num_registers: int = 0, gate_temp: float = 1.0,
                                  gate_bias: float = 0.0, budget_token="learnable",
                                  compute_dtype=torch.bfloat16, save_qkv: bool = True,
                                  plain: bool = False):
    """Differentiable forward of a ResidualViT with sigmoid gates and the
    'attention+mlp' skip on every layer, from its live param tree
    (peekvit_tpu/training/fused.py:174-270). images: (B, H, W, 3);
    budget_vec: (B,) per-sample budgets (the caller draws them:
    ``sample_budgets``). Returns (fp32 logits, aux) with aux["masks"] (fp32
    (B, N_img, 1) per layer) and aux["current_budget"] = budget_vec, so the
    LossCompose regularizers apply unchanged.

    - The budget token is the last token: ``learnable`` (embedding *
      budget), ``learnable_interpolate`` or, for any other truthy mode, the
      budget as a constant fill; the pos-embedding skips it.
    - Each layer's gate runs in fp32 on the image tokens:
      relu(sigmoid(logits / temp + bias) - threshold), the threshold
      sigmoid(budget_token_gate(budget token)) under ``learnable``, else
      1 - the mean of the WHOLE batch's budget token (a reference quirk;
      over the data column under data parallelism, JAX's ``pmean_axis``).
      ``learnable_interpolate`` gates as the module does (the block has no
      ``budget_token_gate``; the JAX fused forward reads one and raises).
    - The attention sublayer is ``masked_attention_block_trainable`` at LN
      eps 1e-6 with fwd_mask = [1 (special tokens), mask, 1 (budget)]; the
      MLP half is tokens + fc2(tanh-gelu(fc1(LN2(tokens) * fwd_mask))) at
      eps 1e-6 in eager torch (``jax.nn.gelu``'s default tanh form); the
      classifier LN is at 1e-5.
    - ``plain=True`` runs the block on its plain versions whatever the
      device: the reference the kernels are held against on the card.
    """
    block = masked_attention_block_trainable_ref if plain else masked_attention_block_trainable

    def cast(t):
        return t.to(compute_dtype)

    c = num_class_tokens
    tokens, d = _embed(params, images, patch_size, c, num_registers, cast)
    b = tokens.shape[0]
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])  # budget token excluded

    bvec = budget_vec.float().reshape(b, 1, 1)
    if budget_token == "learnable":
        btok = cast(params["learnable_budget_token_1"]) * bvec.to(compute_dtype)
    elif budget_token == "learnable_interpolate":
        btok = (cast(params["learnable_budget_token_1"]) * bvec.to(compute_dtype)
                + cast(params["learnable_budget_token_2"]) * (1.0 - bvec).to(compute_dtype))
    else:
        btok = bvec.to(compute_dtype)
    tokens = torch.cat([tokens, btok.expand(b, 1, d)], dim=1)
    s = c + num_registers
    ones = torch.ones((b, s, 1), dtype=compute_dtype, device=tokens.device)

    masks = {}
    for i in _layer_ids(enc):
        lp = enc[f"layers_{i}"]
        img = tokens[:, s:-1]
        gp = lp["residual_gate"]["projection"]
        sig = torch.sigmoid((img.float() @ gp["kernel"].float() + gp["bias"].float())
                            / gate_temp + gate_bias)
        if budget_token == "learnable":
            bg = lp["budget_token_gate"]
            thr = torch.sigmoid(tokens[:, -1:].float() @ bg["kernel"].float()
                                + bg["bias"].float())
            mask = torch.relu(sig - thr)
        else:
            mask = torch.relu(sig - (1.0 - batch_mean(tokens[:, -1:].float())))
        masks[f"layer_{i}"] = mask
        mask_c = mask.to(compute_dtype)
        fwd_mask = torch.cat([ones, mask_c, ones[:, :1]], dim=1)
        tokens = torch.cat([tokens[:, :s], mask_c * img, tokens[:, -1:]], dim=1)

        at, mlp = lp["self_attention"], lp["mlp"]
        tokens = block(
            tokens, fwd_mask, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
            cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
            cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]), num_heads, 1e-6, save_qkv)
        z = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                        1e-6) * fwd_mask
        z = F.gelu(z @ cast(mlp["fc1_kernel"]) + cast(mlp["fc1_bias"]), approximate="tanh")
        tokens = tokens + (z @ cast(mlp["fc2_kernel"]) + cast(mlp["fc2_bias"]))

    logits = _classify(params, tokens, c, cast, ln_eps=1e-5)
    return logits, {"masks": masks, "current_budget": budget_vec}


def residual_forward_fn(model, **kwargs):
    """``residualvit_forward_trainable`` bound to a ResidualViT's shape and
    gate arguments; ``kwargs`` are its keyword options."""
    return functools.partial(
        residualvit_forward_trainable, patch_size=model.patch_size, num_heads=model.num_heads,
        num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
        gate_temp=model.gate_temp, gate_bias=model.gate_bias,
        budget_token=model.add_budget_token, **kwargs)


def make_fused_train_step(model, optimizer: torch.optim.Optimizer,
                          compute_dtype=torch.bfloat16, remat: bool = False,
                          merged="auto", save_qkv="auto"):
    """``step(x, y) -> loss`` for a plain ViT on the fused path: forward,
    mean cross-entropy, backward, ``optimizer.step()``. The model's
    parameters (those ``optimizer`` holds) are updated in place, where the
    JAX step returns new params and opt state. ``merged``, ``remat`` and
    ``save_qkv`` as :func:`vit_forward_trainable`."""
    params = live_params(model)
    fwd = trainable_forward_fn(model, compute_dtype=compute_dtype, remat=remat,
                               merged=merged, save_qkv=save_qkv)

    def step(x, y):
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(fwd(params, x).float(), y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
