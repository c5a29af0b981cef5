"""Fused eval engine for the plain ViT (counterpart of
peekvit_tpu/inference.py: the plain-ViT part of ``prepare_engine_params``,
``vit_forward_fused``, ``_encoder_stack`` and ``InferenceEngine``).

The engine reads the model's weights into a param tree in the JAX
grammar, folds the LN affines into the qkv/fc1 weights and the
pos-embedding into the embed bias once, stacks the layers, and runs::

    _embed_posfolded -> encoder_layers_one_call (the CUDA kernels) -> _classify

The patch-embed matmul, the class-token LayerNorm and the head are work
the JAX package leaves to XLA; here they are plain torch ops.

Usage::

    model = build_model("vit", args)            # on the card
    engine = InferenceEngine(model)             # bf16, the CUDA kernels
    logits = engine(images)                     # NHWC -> (B, classes) fp32
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from peekvit_torch.models.adapters import module_params, tree_map
from peekvit_torch.models.registry import resolve_device
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.ops.cuda.fused_attention import (
    encoder_layers_one_call,
    encoder_layers_one_call_ref,
    fold_ln_into_weights,
    fused_attention_block,
    fused_layer_block_folded,
)
from peekvit_torch.ops.patch_embed import extract_patches as _patchify


def _layer_norm(x, scale, bias, eps):
    """Two-pass LayerNorm in fp32, rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _embed(params, images, patch_size, num_class_tokens, num_registers, cast):
    """Conv patch-embed as matmul + [cls, registers, patches] layout.
    Returns (tokens, d)."""
    x = cast(images)
    wconv = cast(params["conv_proj"]["kernel"])
    d = wconv.shape[-1]
    tokens = _patchify(x, patch_size) @ wconv.reshape(-1, d) + cast(params["conv_proj"]["bias"])
    b = tokens.shape[0]
    pieces = [cast(params["class_tokens"]).reshape(1, -1, d).expand(b, num_class_tokens, d)]
    if num_registers:
        pieces.append(cast(params["register_tokens"]).reshape(1, -1, d).expand(b, num_registers, d))
    pieces.append(tokens)
    return torch.cat(pieces, dim=1), d


def _embed_posfolded(params, images, patch_size, cast):
    """Embed with pos-embedding + conv bias pre-folded into build-time
    constants (prepare_engine_params fold_ln=True)."""
    x = cast(images)
    wconv = cast(params["conv_proj"]["kernel"])
    d = wconv.shape[-1]
    img = _patchify(x, patch_size) @ wconv.reshape(-1, d) + cast(params["_embed_img_bias"])
    spec = cast(params["_embed_special"])
    spec = spec.expand((img.shape[0],) + tuple(spec.shape[1:]))
    return torch.cat([spec, img], dim=1), d


def _classify(params, tokens, num_class_tokens, cast, ln_eps=1e-5):
    """Final LN of the class tokens -> SUM of class tokens -> head, fp32."""
    enc = params["encoder"]
    cls = _layer_norm(tokens[:, :num_class_tokens], cast(enc["ln"]["scale"]),
                      cast(enc["ln"]["bias"]), ln_eps)
    cls = cls.sum(dim=1)
    logits = cls @ cast(params["head"]["kernel"]) + cast(params["head"]["bias"])
    return logits.float()


def _layer_ids(enc):
    return sorted(int(k.split("_")[1]) for k in enc if k.startswith("layers_"))


def prepare_engine_params(params: dict, compute_dtype=None, fold_ln: bool = False) -> dict:
    """Engine-side param preparation, once at construction (plain ViT):

    - fp32 leaves are cast to ``compute_dtype``; 1-D vectors become (1, k);
    - ``fold_ln=True`` folds every layer's LN affines into its qkv and fc1
      weights in fp32 from the original weights (``_folded_qkv`` /
      ``_folded_fc1``, then cast), stacks the layers for the one-call
      encoder (``encoder._stacked_layers``), and folds the pos-embedding
      and conv bias into ``_embed_special`` / ``_embed_img_bias``.
    """
    def visit(t):
        if compute_dtype is not None and t.dtype == torch.float32:
            t = t.to(compute_dtype)
        if t.dim() == 1 and t.shape[0] > 1:
            t = t.reshape(1, -1)
        return t

    out = tree_map(visit, params)
    if not (fold_ln and "encoder" in params):
        return out
    cdt = compute_dtype or torch.float32
    enc = params["encoder"]
    ids = _layer_ids(enc)
    for i in ids:
        sp = enc[f"layers_{i}"]
        at, mlp = sp["self_attention"], sp["mlp"]
        wq, bq = fold_ln_into_weights(sp["ln_1"]["scale"], sp["ln_1"]["bias"],
                                      at["in_proj_kernel"], at["in_proj_bias"])
        w1, b1 = fold_ln_into_weights(sp["ln_2"]["scale"], sp["ln_2"]["bias"],
                                      mlp["fc1_kernel"], mlp["fc1_bias"])
        out["encoder"][f"layers_{i}"]["_folded_qkv"] = {"kernel": wq.to(cdt), "bias": bq.to(cdt)}
        out["encoder"][f"layers_{i}"]["_folded_fc1"] = {"kernel": w1.to(cdt), "bias": b1.to(cdt)}
    if ids:
        layers = [out["encoder"][f"layers_{i}"] for i in ids]

        def stack(get):
            return torch.stack([get(lp) for lp in layers]).contiguous()

        out["encoder"]["_stacked_layers"] = {
            "wqkv": stack(lambda lp: lp["_folded_qkv"]["kernel"]),
            "bqkv": stack(lambda lp: lp["_folded_qkv"]["bias"]),
            "wo": stack(lambda lp: lp["self_attention"]["out_proj_kernel"]),
            "bo": stack(lambda lp: lp["self_attention"]["out_proj_bias"]),
            "w1": stack(lambda lp: lp["_folded_fc1"]["kernel"]),
            "b1": stack(lambda lp: lp["_folded_fc1"]["bias"]),
            "w2": stack(lambda lp: lp["mlp"]["fc2_kernel"]),
            "b2": stack(lambda lp: lp["mlp"]["fc2_bias"]),
        }
    if "class_tokens" in params and "conv_proj" in params:
        d = params["conv_proj"]["kernel"].shape[-1]
        pos = enc["pos_embedding"].float()
        spec = [params["class_tokens"].float().reshape(1, -1, d)]
        if "register_tokens" in params:
            spec.append(params["register_tokens"].float().reshape(1, -1, d))
        spec = torch.cat(spec, dim=1)
        ns = spec.shape[1]
        bias = params["conv_proj"]["bias"].float().reshape(1, 1, d)
        out["_embed_special"] = (spec + pos[:, :ns]).to(cdt)
        out["_embed_img_bias"] = (bias + pos[:, ns:]).to(cdt)
    return out


def _encoder_stack(enc, tokens, num_heads, ln_eps, cast, fused_mlp=True):
    """The plain pre-LN encoder stack over the kernels: the one-call stack
    when ``_stacked_layers`` is present (``prepare_engine_params`` with
    ``fold_ln=True``), else one folded layer call per layer with the LN
    affines folded here; ``fused_mlp=False`` takes the split path
    (fused_attention_block, then the eager MLP with tanh-gelu)."""
    ids = _layer_ids(enc)
    if not ids:
        return tokens
    if fused_mlp and "_stacked_layers" in enc:
        return encoder_layers_one_call(
            tokens, tree_map(cast, enc["_stacked_layers"]), num_heads, ln_eps)
    for i in ids:
        lp = enc[f"layers_{i}"]
        at, mlp = lp["self_attention"], lp["mlp"]
        if fused_mlp:
            wqkv, bqkv = fold_ln_into_weights(
                cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
                cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]))
            w1, b1 = fold_ln_into_weights(
                cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                cast(mlp["fc1_kernel"]), cast(mlp["fc1_bias"]))
            tokens = fused_layer_block_folded(
                tokens, wqkv, bqkv, cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]),
                w1, b1, cast(mlp["fc2_kernel"]), cast(mlp["fc2_bias"]), num_heads, ln_eps)
            continue
        tokens = fused_attention_block(
            tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
            cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
            cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]), num_heads, ln_eps)
        z = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]), ln_eps)
        z = F.gelu(z @ cast(mlp["fc1_kernel"]) + cast(mlp["fc1_bias"]), approximate="tanh")
        tokens = tokens + (z @ cast(mlp["fc2_kernel"]) + cast(mlp["fc2_bias"]))
    return tokens


def _vit_forward(params, images, encoder: Callable, *, patch_size, num_class_tokens,
                 num_registers, ln_eps, compute_dtype):
    def cast(t):
        return t.to(compute_dtype)

    if "_embed_special" in params:
        tokens, _ = _embed_posfolded(params, images, patch_size, cast)
    else:
        tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
        tokens = tokens + cast(params["encoder"]["pos_embedding"])
    tokens = encoder(params["encoder"], tokens, cast)
    return _classify(params, tokens, num_class_tokens, cast, ln_eps)


def vit_forward_fused(params, images, *, patch_size: int, num_heads: int,
                      num_class_tokens: int = 1, num_registers: int = 0,
                      ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                      fused_mlp: bool = True) -> torch.Tensor:
    """Eval forward of a plain ViT from its param tree over the kernels.
    images: (B, H, W, 3). Returns fp32 logits."""
    return _vit_forward(
        params, images,
        lambda enc, tokens, cast: _encoder_stack(enc, tokens, num_heads, ln_eps, cast,
                                                 fused_mlp),
        patch_size=patch_size, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype)


def vit_forward_plain(params, images, *, patch_size: int, num_heads: int,
                      num_class_tokens: int = 1, num_registers: int = 0,
                      ln_eps: float = 1e-5, compute_dtype=torch.float32) -> torch.Tensor:
    """The same forward with the encoder on the kernels' plain versions,
    whatever the device: the reference a check holds the engine against on
    the card. Needs params prepared with ``fold_ln=True``."""
    return _vit_forward(
        params, images,
        lambda enc, tokens, cast: encoder_layers_one_call_ref(
            tokens, tree_map(cast, enc["_stacked_layers"]), num_heads, ln_eps),
        patch_size=patch_size, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype)


class InferenceEngine:
    """Fused eval forward bound to a built plain ViT.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU. On the
    card the kernels take bf16 only."""

    def __init__(self, model, compute_dtype=torch.bfloat16, device="cuda",
                 quantized: bool = False, max_budget: Optional[float] = None,
                 mesh: Any = None, compact: Any = None, ee_outputs: bool = False,
                 recon_outputs: bool = False, routed: Any = None):
        if not isinstance(model, VisionTransformer):
            raise NotImplementedError(
                f"the port's engine serves the plain VisionTransformer; "
                f"{type(model).__name__} is ROADMAP.md port queue A items 4-7")
        not_ported = {
            "quantized=": (quantized, "item 6 (int8)"),
            "max_budget=": (max_budget is not None, "item 5 (RankViT)"),
            "mesh=": (mesh is not None, "item 9 (parallel and serving)"),
            "compact=": (compact is not None, "item 4 (ResidualViT compaction)"),
            "ee_outputs=": (ee_outputs, "item 4 (ResidualViT)"),
            "recon_outputs=": (recon_outputs, "items 4 and 7 (EncDec / MAE)"),
            "routed=": (routed is not None, "item 7 (MoE)"),
        }
        for name, (used, item) in not_ported.items():
            if used:
                raise NotImplementedError(
                    f"{name} is not ported yet: ROADMAP.md port queue A {item}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA kernels take bf16 only; an fp32 engine on the card is "
                "ROADMAP.md port queue B item 15 (fp32 on CUDA)")
        self._forward = dict(
            patch_size=model.patch_size, num_heads=model.num_heads,
            num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
            ln_eps=model.ln_eps, compute_dtype=compute_dtype)
        params = tree_map(lambda t: t.to(self.device), module_params(model))
        self.params = prepare_engine_params(params, compute_dtype, fold_ln=True)

    def __call__(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) numpy array or tensor. Returns fp32 logits
        on the engine's device."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(self.device, torch.float32)
        with torch.inference_mode():
            return vit_forward_fused(self.params, images, **self._forward)
