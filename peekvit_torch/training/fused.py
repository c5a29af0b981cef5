"""Fused mixed-precision training path for the plain ViT (counterpart of
peekvit_tpu/training/fused.py:35-171).

The attention sublayer runs forward and backward through the trainable
block over CUDA kernels (ops/cuda/fused_attention_vjp.py); the MLP half,
the weight-gradient products and the optimizer stay plain PyTorch, as the
JAX package leaves them to XLA. Master params stay fp32; the forward casts
them to the compute dtype and their gradients flow back through the cast
in fp32.

Only the SPLIT path is ported (attention kernel + eager MLP, the JAX
default and its measured best). The merged layer VJP (``merged=True``) and
``"hybrid"`` are the JAX package's measured negatives and raise
``NotImplementedError`` (ROADMAP.md port queue B item 14).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from peekvit_torch.inference import _classify, _embed, _layer_ids, _layer_norm
from peekvit_torch.models.adapters import live_params
from peekvit_torch.ops.cuda.fused_attention_vjp import (
    attention_block_trainable,
    attention_block_trainable_ref,
)


def vit_forward_trainable(params, images, *, patch_size: int, num_heads: int,
                          num_class_tokens: int = 1, num_registers: int = 0,
                          ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                          remat: bool = False, merged="auto", save_qkv="auto",
                          plain: bool = False) -> torch.Tensor:
    """Differentiable forward of a plain ViT from its live param tree
    (``models.adapters.live_params``). images: (B, H, W, 3). Returns fp32
    logits. No dropout paths: the reference ViT configs train with 0.0.

    - ``save_qkv="auto"`` means ``not remat`` (fused.py:97-105): the
      backward reads the forward's qkv instead of recomputing it.
    - ``remat=True`` checkpoints each layer
      (``torch.utils.checkpoint``, non-reentrant): the backward re-runs the
      layer's forward and then the recompute backward.
    - The MLP is LN -> fc1 -> tanh-gelu -> fc2 -> residual, as fused.py:116-121
      (``jax.nn.gelu``'s default is the tanh form; the model's own MLP,
      ops/mlp.py, keeps erf like linen).
    - ``plain=True`` runs the attention block on its plain versions
      whatever the device: the reference the kernels are held against on
      the card.
    """
    if merged not in ("auto", False):
        raise NotImplementedError(
            f"merged={merged!r} (the merged layer VJP, fused_layer_vjp.py) is not ported: "
            "ROADMAP.md port queue B item 14; the split path (merged='auto') is")
    if save_qkv == "auto":
        save_qkv = not remat
    block = attention_block_trainable_ref if plain else attention_block_trainable

    def cast(t):
        return t.to(compute_dtype)

    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])

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


def make_fused_train_step(model, optimizer: torch.optim.Optimizer,
                          compute_dtype=torch.bfloat16, remat: bool = False,
                          merged="auto", save_qkv="auto"):
    """``step(x, y) -> loss`` for a plain ViT on the fused path: forward,
    mean cross-entropy, backward, ``optimizer.step()``. The model's
    parameters (those ``optimizer`` holds) are updated in place, where the
    JAX step returns new params and opt state."""
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
