"""Fused eval engines for the plain ViT, the ResidualViT family (EncDec
included), RankViT, A-ViT, MAE, MoE, PCT and RankPCT, in bf16 and (ViT,
ResidualViT, RankViT, MoE) int8 (counterpart of peekvit_tpu/inference.py:
``prepare_engine_params``, ``vit_forward_fused``, ``_encoder_stack``,
``maevit_forward_fused``, ``residualvit_forward_fused`` with its ``recon``
branch, ``rankvit_forward_fused``, ``rankvit_forward_padded``,
``adavit_forward_fused``, ``moevit_forward_fused`` with
``_routed_moe_mlp``, the int8 forwards and calibration,
``prepare_pct_engine_params``, ``pct_forward_fused``,
``rankpct_forward_fused`` and ``InferenceEngine``).

For a plain ViT the engine reads the model's weights into a param tree in
the JAX grammar, folds the LN affines into the qkv/fc1 weights and the
pos-embedding into the embed bias once, stacks the layers, and runs::

    _embed_posfolded -> encoder_layers_one_call (the CUDA kernels) -> _classify

For a ResidualViT (sigmoid gates, 'attention+mlp' on every layer, a
budget token: the shipped configuration) it runs, per layer, the gate and
then the masked layer on the kernels (``residualvit_forward_fused``);
``compact=`` gathers the top tokens by gate value first, so the layers run
on fewer tokens. The patch-embed matmul, the gates, top-k and gather, the
budget token, the class-token LayerNorm and the heads are work the JAX
package leaves to XLA; here they are plain torch ops.

For a RankViT the engine drops tokens physically: at each ranked layer the
top ``ceil(n * budget)`` image tokens by fp32 norm are gathered and every
later layer runs on fewer tokens (``rankvit_forward_fused``: the folded
layer from 128 tokens up, the split sublayers below). ``max_budget=``
keeps one set of shapes for every budget up to it
(``rankvit_forward_padded``): the buffer keeps ``ceil(n * max_budget)``
tokens, the tail past the budget's count is zeroed and excluded as keys by
the key-masked folded layer.

``recon_outputs=True`` serves the reconstruction decoders. An EncDec
ResidualViT's decoder runs after the masked layers on the final-LN image
tokens with the last gate mask (the plain folded layer, 7 launches per
layer, at the decoder's head dim: 48 at the shipped widths); an MAE runs
its whole sequence through both plain stacks (``maevit_forward_fused``, no
shuffle at eval).

For an A-ViT the ACT carry (cumulative halting, remainder, active mask)
runs in torch in fp32 and each layer runs ``avit_layer_block`` on the
kernels (``adavit_forward_fused``).

For a PCT the engine embeds the point clouds with the gather-free ARPE
kernel (``ops/cuda/pct_embed.arpe_tokens``: kNN threshold by bisection,
masked max, both BatchNorms folded at build), runs the plain folded stack
(the ViT's kernels at head dim 32), mean-pools and runs the BatchNorm
head in fp32 torch (``pct_forward_fused``). A RankPCT drops tokens
physically before each ranking layer (``rankpct_forward_fused``).

For an MoE ViT each layer whose two sublayers have one expert runs the
folded layer on the kernels; a sublayer with one expert beside a gated
one runs ``fused_attention_block`` / ``fused_mlp_block``; a gated
sublayer takes its fp32 top-1 gate and runs every expert densely in torch
with the one-hot combine, as XLA in JAX (``moevit_forward_fused``), or,
under ``routed=``, each token's own MLP expert by a capacity dispatch
(``_routed_moe_mlp``). Its int8 engine runs the experts' linears on the
s8 GEMM (``ops/cuda/quant_blocks.quant_experts``, ``moevit_forward_quant``).

A model built with a NoiseBlock (``build_model(noise_args={"layer",
"noise_type"})``) gets its noise on the engine path too, at the point in
the token stream where its module puts it: ``engine(images,
noise_value=, noise_rng=)`` injects it before block ``noise_layer`` in
the ViT, RankViT (at or before the first ranked layer), ResidualViT and
MoE forwards and their int8 and plain twins (``ops/noise.inject_noise``,
the ``noise=`` argument of each forward); the ViT stack then runs per
layer instead of the one-call chain. The draw runs on the engine's
device.

``quantized=True`` (ViT, RankViT, the ResidualViT family and MoE) serves int8
w8a8: the weights quantized per output column at build
(``quantize_vit_params``, ``quantize_residualvit_params``, optionally
after SmoothQuant and with static activation caps from calibration
images), every layer the int8 layer of ``ops/cuda/quant_blocks.py``
(``vit_forward_quant``, ``rankvit_forward_quant``,
``rankvit_forward_padded_quant``, ``residualvit_forward_quant``).

Usage::

    model = build_model("vit", args)            # on the card
    engine = InferenceEngine(model)             # bf16, the CUDA kernels
    logits = engine(images)                     # NHWC -> (B, classes) fp32

    engine = InferenceEngine(build_model("residualvit", args), compact=0.75)
    logits = engine(images, budget=0.5)

    engine = InferenceEngine(build_model("rankvit", args), max_budget=0.75)
    logits = engine(images, budget=0.5)

    engine = InferenceEngine(model, quantized=True, calib_images=calib,
                             calib_static_caps=True)

    engine = InferenceEngine(build_model("adavit", args))
    logits = engine(images)

    engine = InferenceEngine(build_model("encdecresidualvit", args), recon_outputs=True)
    logits, recon, mask_image = engine(images, budget=0.5)

    logits, recon = InferenceEngine(build_model("maevit", args), recon_outputs=True)(images)

    engine = InferenceEngine(build_model("moevit", args), routed=2.0)
    logits = engine(images)

    model = build_model("vit", args, noise_args={"layer": 6, "noise_type": "gaussian"})
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = InferenceEngine(model)(images, noise_value=10.0, noise_rng=gen)  # 10 dB

    engine = InferenceEngine(build_model("pct", args))
    logits = engine(points)                     # (B, N, 3) -> (B, classes) fp32

    model = build_model("rankpct", args)
    model.enable_ranking(True)                  # read when the engine is built
    logits = InferenceEngine(model)(points, budget=0.5)
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from peekvit_torch.models.adapters import module_params, module_state, tree_map
from peekvit_torch.models.adavit import AdaptiveVisionTransformer
from peekvit_torch.models.eeresidualvit import EEResidualVisionTransformer
from peekvit_torch.models.encdecresidualvit import ResidualVisionTransformerWithDecoder
from peekvit_torch.models.maevit import MAEVisionTransformer
from peekvit_torch.models.moevit import VisionTransformerMoE, combine
from peekvit_torch.models.pct import PointCloudTransformer
from peekvit_torch.models.rankpct import RankPointCloudTransformer
from peekvit_torch.models.rankvit import RankVisionTransformer
from peekvit_torch.models.registry import resolve_device
from peekvit_torch.models.residualvit import ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.ops.cuda.fused_attention import (
    avit_layer_block,
    avit_layer_block_ref,
    encoder_layers_one_call,
    encoder_layers_one_call_ref,
    fold_ln_into_weights,
    fused_attention_block,
    fused_attention_block_ref,
    fused_layer_block_folded,
    fused_layer_block_folded_ref,
    fused_mlp_block,
    fused_mlp_block_ref,
    keymasked_layer_block_folded,
    keymasked_layer_block_folded_ref,
    masked_attention_block,
    masked_attention_block_ref,
    masked_layer_block,
    masked_layer_block_ref,
    masked_mlp_block,
    masked_mlp_block_ref,
)
from peekvit_torch.ops.attention import attention_core
from peekvit_torch.ops.global_batch import batch_mean
from peekvit_torch.ops.noise import NoiseSpec, default_generator, inject_noise
from peekvit_torch.ops.cuda.pct_embed import arpe_tokens, arpe_tokens_ref
from peekvit_torch.ops.cuda.quant_blocks import (
    kernel_layout,
    quant_attention_block,
    quant_attention_block_ref,
    quant_keymasked_layer_block,
    quant_keymasked_layer_block_ref,
    quant_layer_block,
    quant_layer_block_ref,
    quant_masked_layer_block,
    quant_masked_layer_block_ref,
    quant_experts,
    quant_experts_ref,
    quant_mlp_block,
    quant_mlp_block_ref,
    quantize_linear,
)
from peekvit_torch.ops.patch_embed import extract_patches as _patchify
from peekvit_torch.ops.patch_embed import mask_image as _mask_image
from peekvit_torch.ops.patch_embed import unpatchify_cmajor as _unpatchify_cmajor


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


# Gate subtrees stay fp32 whatever the compute dtype: thresholding a gate
# (or an MoE gate's argmax) is discontinuous, so the engine's gate
# arithmetic is fp32 on purpose (JAX inference.py:159-172).
_FP32_SUBTREES = frozenset({"residual_gate", "budget_token_gate", "gating_network"})
# int8 dequant scales stay fp32 too (JAX FP_LEAVES, inference.py:160)
_FP32_LEAVES = frozenset({"sqkv", "so", "s1", "s2"})
_S8_LEAVES = ("wqkv_q", "wo_q", "w1_q", "w2_q")


def _prepare_tree(tree: dict, compute_dtype, keep_fp32: bool = False) -> dict:
    out = {}
    for key, t in tree.items():
        if isinstance(t, dict):
            out[key] = _prepare_tree(t, compute_dtype, keep_fp32 or key in _FP32_SUBTREES)
            continue
        if (compute_dtype is not None and not keep_fp32 and key not in _FP32_LEAVES
                and t.dtype == torch.float32):
            t = t.to(compute_dtype)
        if t.dim() == 1 and t.shape[0] > 1:
            t = t.reshape(1, -1)
        out[key] = t
    return out


def prepare_engine_params(params: dict, compute_dtype=None, fold_ln: bool = False) -> dict:
    """Engine-side param preparation, once at construction:

    - fp32 leaves are cast to ``compute_dtype``, except the gate subtrees
      (``residual_gate``, ``budget_token_gate``, MoE's ``gating_network``)
      and the int8 dequant scales (``sqkv``, ``so``, ``s1``, ``s2``),
      which stay fp32; 1-D vectors become (1, k);
    - a quantized tree (``quantize_vit_params``, or
      ``quantize_moevit_params`` with the int8 leaves under
      ``self_attention`` / ``mlp``) gets each int8 kernel, and each
      expert's of a stack, as the (in, out) view of an (out, in) copy
      (``kernel_layout``: the layout the s8 GEMM reads), made here once;
      its LN affines are neither folded nor stacked (the int8 layer
      applies them);
    - ``fold_ln=True`` (plain ViT, RankViT, MAE: a ResidualViT's row masks
      do not commute with a folded LN bias) folds every layer's LN affines into
      its qkv and fc1 weights in fp32 from the original weights
      (``_folded_qkv`` / ``_folded_fc1``, then cast) and stacks the layers for
      the one-call encoder (``_stacked_layers``), in ``encoder`` and in
      MAE's ``decoder_blocks`` (the same plain stack); an MoE layer is
      folded from its ``experts_0`` where both sublayers have one expert,
      and an MoE encoder is not stacked (JAX inference.py:186-218); it folds the
      pos-embedding and conv bias into ``_embed_special`` /
      ``_embed_img_bias``. MAE's top-level ``pos_embedding`` covers the
      patches only, so there ``_embed_special`` is the class and register
      tokens alone (JAX inference.py:180-254).
    """
    out = _prepare_tree(params, compute_dtype)
    enc = params.get("encoder", {})
    ids = _layer_ids(enc)
    quantized = any("wqkv_q" in node for i in ids for node in _int8_nodes(enc[f"layers_{i}"]))
    for i in ids if quantized else ():
        for node in _int8_nodes(out["encoder"][f"layers_{i}"]):
            for key in _S8_LEAVES:
                if key in node:
                    node[key] = kernel_layout(node[key])
    if not (fold_ln and "encoder" in params):
        return out
    cdt = compute_dtype or torch.float32
    for sub in ("encoder", "decoder_blocks") if not quantized else ():
        if sub in params:
            _fold_and_stack(params[sub], out[sub], cdt)
    if "class_tokens" in params and "conv_proj" in params:
        d = params["conv_proj"]["kernel"].shape[-1]
        spec = [params["class_tokens"].float().reshape(1, -1, d)]
        if "register_tokens" in params:
            spec.append(params["register_tokens"].float().reshape(1, -1, d))
        spec = torch.cat(spec, dim=1)
        ns = spec.shape[1]
        bias = params["conv_proj"]["bias"].float().reshape(1, 1, d)
        if "pos_embedding" in params:  # MAE: patches only, the special tokens take none
            out["_embed_special"] = spec.to(cdt)
            out["_embed_img_bias"] = (bias + params["pos_embedding"].float()).to(cdt)
        else:
            pos = enc["pos_embedding"].float()
            out["_embed_special"] = (spec + pos[:, :ns]).to(cdt)
            out["_embed_img_bias"] = (bias + pos[:, ns:]).to(cdt)
    return out


def _int8_nodes(lp: dict) -> tuple:
    """The dicts of a quantized layer that may hold int8 kernels: the layer
    itself (ViT, ResidualViT) and its ``self_attention`` / ``mlp`` (MoE)."""
    return (lp, lp.get("self_attention", {}), lp.get("mlp", {}))


def _single_expert_view(lp: dict) -> dict:
    """An MoE layer whose sublayers have one expert each, as a plain layer:
    ``self_attention`` / ``mlp`` are their ``experts_0``."""
    return dict(lp, self_attention=lp["self_attention"]["experts_0"],
                mlp=lp["mlp"]["experts_0"])


def _fold_and_stack(stack_in: dict, stack_out: dict, cdt) -> None:
    """Fold each layer of a plain pre-LN stack (``stack_in``, the original
    weights) into ``stack_out``'s ``_folded_qkv`` / ``_folded_fc1``, and
    stack the layers into ``stack_out["_stacked_layers"]``. An MoE layer
    folds from its ``experts_0`` where both sublayers have one expert, and
    an MoE stack is not stacked."""
    ids = _layer_ids(stack_in)
    moe = any("out_proj_kernel" not in stack_in[f"layers_{i}"]["self_attention"] for i in ids)
    for i in ids:
        sp, op = stack_in[f"layers_{i}"], stack_out[f"layers_{i}"]
        if moe:
            if "experts_0" not in sp["self_attention"] or "experts_0" not in sp["mlp"]:
                continue  # a multi-expert sublayer: the layer is not fused whole
            sp = _single_expert_view(sp)
        at, mlp = sp["self_attention"], sp["mlp"]
        wq, bq = fold_ln_into_weights(sp["ln_1"]["scale"], sp["ln_1"]["bias"],
                                      at["in_proj_kernel"], at["in_proj_bias"])
        w1, b1 = fold_ln_into_weights(sp["ln_2"]["scale"], sp["ln_2"]["bias"],
                                      mlp["fc1_kernel"], mlp["fc1_bias"])
        op["_folded_qkv"] = {"kernel": wq.to(cdt), "bias": bq.to(cdt)}
        op["_folded_fc1"] = {"kernel": w1.to(cdt), "bias": b1.to(cdt)}
    if not ids or moe:
        return
    layers = [stack_out[f"layers_{i}"] for i in ids]

    def stack(get):
        return torch.stack([get(lp) for lp in layers]).contiguous()

    stack_out["_stacked_layers"] = {
        "wqkv": stack(lambda lp: lp["_folded_qkv"]["kernel"]),
        "bqkv": stack(lambda lp: lp["_folded_qkv"]["bias"]),
        "wo": stack(lambda lp: lp["self_attention"]["out_proj_kernel"]),
        "bo": stack(lambda lp: lp["self_attention"]["out_proj_bias"]),
        "w1": stack(lambda lp: lp["_folded_fc1"]["kernel"]),
        "b1": stack(lambda lp: lp["_folded_fc1"]["bias"]),
        "w2": stack(lambda lp: lp["mlp"]["fc2_kernel"]),
        "b2": stack(lambda lp: lp["mlp"]["fc2_bias"]),
    }


def _folded_weights(lp, cast):
    """A layer's (wqkv, bqkv, wo, bo, w1, b1, w2, b2) with the LN affines
    folded into qkv and fc1: the prepared ``_folded_qkv``/``_folded_fc1``
    where present, else folded here from the cast weights."""
    at, mlp = lp["self_attention"], lp["mlp"]
    if "_folded_qkv" in lp:
        wqkv, bqkv = cast(lp["_folded_qkv"]["kernel"]), cast(lp["_folded_qkv"]["bias"])
        w1, b1 = cast(lp["_folded_fc1"]["kernel"]), cast(lp["_folded_fc1"]["bias"])
    else:
        wqkv, bqkv = fold_ln_into_weights(
            cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
            cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]))
        w1, b1 = fold_ln_into_weights(
            cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
            cast(mlp["fc1_kernel"]), cast(mlp["fc1_bias"]))
    return (wqkv, bqkv, cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]), w1, b1,
            cast(mlp["fc2_kernel"]), cast(mlp["fc2_bias"]))


def _encoder_stack(enc, tokens, num_heads, ln_eps, cast, fused_mlp=True, plain=False,
                   noise: Optional[NoiseSpec] = None):
    """The plain pre-LN encoder stack over the kernels: the one-call stack
    when ``_stacked_layers`` is present (``prepare_engine_params`` with
    ``fold_ln=True``), else one folded layer call per layer with the LN
    affines folded here; ``fused_mlp=False`` takes the split path
    (fused_attention_block, then the eager MLP with tanh-gelu). ``plain``:
    the same on the kernels' plain versions, whatever the device.
    ``noise``: the NoiseBlock before block ``noise.layer``; the stack then
    leaves the one-call chain and runs per layer (JAX inference.py:361-379)."""
    ids = _layer_ids(enc)
    if not ids:
        return tokens
    if fused_mlp and "_stacked_layers" in enc and noise is None:
        one_call = encoder_layers_one_call_ref if plain else encoder_layers_one_call
        return one_call(tokens, tree_map(cast, enc["_stacked_layers"]), num_heads, ln_eps)
    for i in ids:
        tokens = inject_noise(tokens, i, noise)
        lp = enc[f"layers_{i}"]
        at, mlp = lp["self_attention"], lp["mlp"]
        if fused_mlp:
            layer = fused_layer_block_folded_ref if plain else fused_layer_block_folded
            tokens = layer(tokens, *_folded_weights(lp, cast), num_heads, ln_eps)
            continue
        tokens = (fused_attention_block_ref if plain else fused_attention_block)(
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
                      fused_mlp: bool = True, noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """Eval forward of a plain ViT from its param tree over the kernels.
    images: (B, H, W, 3). ``noise``: the NoiseBlock before block
    ``noise.layer`` (ops/noise.py; JAX inference.py:378), the stack then
    per layer. Returns fp32 logits."""
    return _vit_forward(
        params, images,
        lambda enc, tokens, cast: _encoder_stack(enc, tokens, num_heads, ln_eps, cast,
                                                 fused_mlp, noise=noise),
        patch_size=patch_size, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype)


def vit_forward_plain(params, images, *, patch_size: int, num_heads: int,
                      num_class_tokens: int = 1, num_registers: int = 0,
                      ln_eps: float = 1e-5, compute_dtype=torch.float32,
                      noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """The same forward with the encoder on the kernels' plain versions,
    whatever the device: the reference a check holds the engine against on
    the card. Needs params prepared with ``fold_ln=True``."""
    return _vit_forward(
        params, images,
        lambda enc, tokens, cast: _encoder_stack(enc, tokens, num_heads, ln_eps, cast,
                                                 plain=True, noise=noise),
        patch_size=patch_size, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype)


def _maevit_forward(params, images, *, plain: bool, patch_size: int, num_heads: int,
                    num_decoder_heads: int, num_class_tokens: int, num_registers: int,
                    ln_eps: float, compute_dtype, recon: bool):
    def cast(t):
        return t.to(compute_dtype)

    if "_embed_special" in params:
        tokens, _ = _embed_posfolded(params, images, patch_size, cast)
    else:  # the pos-embedding covers the patches only: added before the concat
        x = cast(images)
        wconv = cast(params["conv_proj"]["kernel"])
        d = wconv.shape[-1]
        img = (_patchify(x, patch_size) @ wconv.reshape(-1, d) + cast(params["conv_proj"]["bias"])
               + cast(params["pos_embedding"]))
        b = img.shape[0]
        pieces = [cast(params["class_tokens"]).reshape(1, -1, d).expand(b, num_class_tokens, d)]
        if num_registers:
            pieces.append(cast(params["register_tokens"]).reshape(1, -1, d)
                          .expand(b, num_registers, d))
        tokens = torch.cat(pieces + [img], dim=1)
    enc = params["encoder"]
    tokens = _encoder_stack(enc, tokens, num_heads, ln_eps, cast, plain=plain)
    # the final LN over ALL tokens: it feeds the head and the decoder
    tokens = _layer_norm(tokens, cast(enc["ln"]["scale"]), cast(enc["ln"]["bias"]), ln_eps)
    cls = tokens[:, :num_class_tokens].sum(dim=1)
    logits = (cls @ cast(params["head"]["kernel"]) + cast(params["head"]["bias"])).float()
    if not recon:
        return logits
    dec = tokens[:, num_class_tokens + num_registers:]
    if "decoder_embed" in params:
        dec = dec @ cast(params["decoder_embed"]["kernel"]) + cast(params["decoder_embed"]["bias"])
    dec = dec + cast(params["decoder_pos_embedding"])
    db = params["decoder_blocks"]
    dec = _encoder_stack(db, dec, num_decoder_heads, ln_eps, cast, plain=plain)
    dec = _layer_norm(dec, cast(db["ln"]["scale"]), cast(db["ln"]["bias"]), ln_eps)
    rec = dec @ cast(params["decoder_head"]["kernel"]) + cast(params["decoder_head"]["bias"])
    return logits, _unpatchify_cmajor(rec, patch_size).float()


def maevit_forward_fused(params, images, *, patch_size: int, num_heads: int,
                         num_decoder_heads: int, num_class_tokens: int = 1,
                         num_registers: int = 0, ln_eps: float = 1e-5,
                         compute_dtype=torch.bfloat16, recon: bool = False):
    """Eval forward of an MAE ViT (JAX ``maevit_forward_fused``,
    inference.py:445) from ``prepare_engine_params(fold_ln=True)``. No
    shuffle at eval: the full patch sequence runs through the encoder and
    the decoder, both on the plain folded stack (``encoder_layers_one_call``,
    7 launches per layer). The pos-embedding covers the patches only
    (``_embed_img_bias``); the final encoder LN runs over every token, as it
    feeds the head and the decoder; the logits come from the summed class
    tokens. With ``recon``: ``decoder_embed`` (where the widths differ),
    ``decoder_pos_embedding``, the decoder stack, its LN, ``decoder_head``
    and the channel-major unpatchify. images: (B, H, W, 3). Returns fp32
    logits, or ``(logits, reconstruction NHWC)``."""
    return _maevit_forward(
        params, images, plain=False, patch_size=patch_size, num_heads=num_heads,
        num_decoder_heads=num_decoder_heads, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype, recon=recon)


def maevit_forward_plain(params, images, *, patch_size: int, num_heads: int,
                         num_decoder_heads: int, num_class_tokens: int = 1,
                         num_registers: int = 0, ln_eps: float = 1e-5,
                         compute_dtype=torch.float32, recon: bool = False):
    """:func:`maevit_forward_fused` on the kernels' plain versions, whatever
    the device: the reference a check holds the engine against on the
    card."""
    return _maevit_forward(
        params, images, plain=True, patch_size=patch_size, num_heads=num_heads,
        num_decoder_heads=num_decoder_heads, num_class_tokens=num_class_tokens,
        num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype, recon=recon)


# Below this token count the JAX engine takes the split masked sublayers
# in place of the merged masked layer (JAX inference.py:306-310, :2312).
# It is a TPU speed threshold, but it decides which numerics run: the
# merged layer's one-pass LN with an fp32 mid residual, or the split
# sublayers' two-pass LN with a bf16 residual between them. Kept as JAX
# has it, so that the compacted forwards match; its H100 value is later
# speed work.
_MERGED_MIN_TOKENS = 128

_MASKED_KERNELS = (masked_layer_block, masked_attention_block, masked_mlp_block)
_MASKED_PLAIN = (masked_layer_block_ref, masked_attention_block_ref, masked_mlp_block_ref)


def _residual_layers(blocks, num_heads: int, compute_dtype):
    """The bf16 ResidualViT layer over ``blocks`` (masked_layer_block,
    masked_attention_block, masked_mlp_block or their plain twins) for
    :func:`_residual_forward`: the merged layer, else the split
    sublayers."""
    layer_block, attention_block, mlp_block = blocks

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, fwd_mask, lp, li, merged, ph_mult, ph_idx):
        at, mlp = lp["self_attention"], lp["mlp"]
        weights = (cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
                   cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
                   cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]),
                   cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                   cast(mlp["fc1_kernel"]), cast(mlp["fc1_bias"]),
                   cast(mlp["fc2_kernel"]), cast(mlp["fc2_bias"]))
        if merged:
            return layer_block(tokens, fwd_mask, *weights, num_heads, 1e-6, ph_mult, ph_idx)
        tokens = attention_block(tokens, fwd_mask, *weights[:6], num_heads, 1e-6, ph_mult,
                                 ph_idx)
        return mlp_block(tokens, fwd_mask, *weights[6:], 1e-6)

    return run


def _residual_forward(params, images, budget, run_layer, *, patch_size: int,
                      num_class_tokens: int = 1, num_registers: int = 0,
                      gate_temp: float = 1.0, gate_bias: float = 0.0,
                      budget_token: Any = "learnable", compute_dtype=torch.bfloat16,
                      early_exits: bool = False, compact_caps: Optional[tuple] = None,
                      masks: Optional[dict] = None, recon_plain: Optional[bool] = None,
                      decoder_num_heads: Optional[int] = None,
                      noise: Optional[NoiseSpec] = None):
    """The gates, the budget token, compaction and the early exits around
    ``run_layer(tokens, fwd_mask, layer params, layer position, merged,
    phantom_mult, phantom_idx)``, the bf16 (:func:`_residual_layers`) or
    the int8 (:func:`_quant_residual_layers`) layer. ``recon_plain`` not
    None: the EncDec decoder after the encoder (:func:`_residual_recon`),
    on the kernels' plain versions if True. ``noise``: the NoiseBlock
    before block ``noise.layer``, over the whole stream with the budget
    token, ahead of the gate (JAX inference.py:2249); the engine refuses
    it with compaction, whose phantom slot is not the module's layout."""

    def cast(t):
        return t.to(compute_dtype)

    c = num_class_tokens
    tokens, d = _embed(params, images, patch_size, c, num_registers, cast)
    b, dev = tokens.shape[0], tokens.device
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])  # budget token excluded

    bcast = torch.full((b, 1, 1), float(budget), dtype=torch.float32, device=dev).to(compute_dtype)
    if budget_token == "learnable":
        btok = cast(params["learnable_budget_token_1"]) * bcast
    elif budget_token == "learnable_interpolate":
        btok = (cast(params["learnable_budget_token_1"]) * bcast
                + cast(params["learnable_budget_token_2"]) * (1.0 - bcast))
    elif budget_token:
        btok = bcast
    else:
        raise NotImplementedError("the fused residualvit engine needs a budget token")
    btok = btok.expand(b, 1, d)
    s = c + num_registers  # special tokens at the front
    n_img_orig = tokens.shape[1] - s
    # Compaction carries one PHANTOM zero slot between the image tokens and
    # the budget token; its key's exp term is weighted by the dropped count
    # in the attention kernel, standing in for the removed gated-off tokens
    # (whose keys and values are the same bias terms).
    phantom = compact_caps is not None and min(compact_caps) < n_img_orig
    tail = 2 if phantom else 1
    pieces = [tokens, tokens.new_zeros((b, 1, d))] if phantom else [tokens]
    tokens = torch.cat(pieces + [btok], dim=1)
    ones = torch.ones((b, s, 1), dtype=compute_dtype, device=dev)
    zero = torch.zeros((b, 1, 1), dtype=compute_dtype, device=dev)
    exits = []

    for li, i in enumerate(_layer_ids(enc)):
        tokens = inject_noise(tokens, i, noise)
        lp = enc[f"layers_{i}"]
        # ---- gate, in fp32 (reference residualvit.py:58-69, 154-165)
        img = tokens[:, s:-tail]
        gp = lp["residual_gate"]["projection"]
        sig = torch.sigmoid((img.float() @ gp["kernel"].float() + gp["bias"].float())
                            / gate_temp + gate_bias)
        if budget_token == "learnable":
            bg = lp["budget_token_gate"]
            thr = torch.sigmoid(tokens[:, -1:].float() @ bg["kernel"].float()
                                + bg["bias"].float())
            mask = torch.relu(sig - thr)
        else:
            # the mean over the WHOLE batch's (evolving) budget token, a
            # reference quirk (residualvit.py:208) kept for parity
            cur_b = batch_mean(tokens[:, -1:].float())  # over the data column under dp
            mask = torch.relu(sig - (1.0 - cur_b))
        if masks is not None:
            masks[f"layer_{i}"] = mask  # fp32 (B, N_img, 1), what the module's aux holds
        if compact_caps is not None and compact_caps[li] < img.shape[1]:
            # keep the top-cap tokens by gate value in descending order,
            # ties by the lower index (jax.lax.top_k's order; torch.topk is
            # not stable); the surplus slots arrive with mask 0
            idx = torch.sort(mask[..., 0], dim=1, descending=True, stable=True).indices
            idx = idx[:, :compact_caps[li], None]
            img = torch.gather(img, 1, idx.expand(-1, -1, d))
            mask = torch.gather(mask, 1, idx)
        last_mask = mask  # fp32, what the decoder reads after the last layer
        mask = mask.to(compute_dtype)
        if phantom:
            # the phantom slot: mask 0 (a gated-off token), value carried
            fwd_mask = torch.cat([ones, mask, zero, ones[:, :1]], dim=1)
            tokens = torch.cat([tokens[:, :s], mask * img, tokens[:, -2:]], dim=1)
            ph_mult, ph_idx = float(n_img_orig - img.shape[1]), s + img.shape[1]
        else:
            fwd_mask = torch.cat([ones, mask, ones[:, :1]], dim=1)
            tokens = torch.cat([tokens[:, :s], mask * img, tokens[:, -1:]], dim=1)
            ph_mult, ph_idx = 0.0, -1

        merged = compact_caps is None or tokens.shape[1] >= _MERGED_MIN_TOKENS
        tokens = run_layer(tokens, fwd_mask, lp, li, merged, ph_mult, ph_idx)
        if early_exits:
            ln_p = enc[f"early_exit_heads_{i}_ln"]
            hd_p = enc[f"early_exit_heads_{i}_head"]
            cls = _layer_norm(tokens[:, :c], cast(ln_p["scale"]), cast(ln_p["bias"]), 1e-5)[:, 0]
            exits.append((cls @ cast(hd_p["kernel"]) + cast(hd_p["bias"])).float())

    if recon_plain is not None:
        return _residual_recon(params, tokens, last_mask, c, s, patch_size, recon_plain,
                               decoder_num_heads, compute_dtype)
    final = _classify(params, tokens, c, cast, ln_eps=1e-5)
    return tuple(exits) + (final,) if early_exits else final


def _residual_recon(params, tokens, last_mask, c: int, s: int, patch_size: int, plain: bool,
                    decoder_num_heads: int, compute_dtype):
    """The EncDec tail (JAX inference.py:2339-2367): the final LN over all
    tokens (it feeds the head and the decoder), the logits from the summed
    class tokens, then the decoder on the image tokens ``tokens[:, s:-1]``:
    ``decoder_embed`` where the widths differ, the mask token mixed in by
    m = sigmoid(last_mask * 100) in the compute dtype, the pos-embedding,
    the plain stack (LN eps 1e-5) on the unfolded weights, folded per layer
    (``_folded_weights``), its LN, the head and the channel-major
    unpatchify. Returns (fp32 logits, fp32 reconstruction NHWC, fp32 mask
    image (B, H, W, 1))."""

    def cast(t):
        return t.to(compute_dtype)

    enc = params["encoder"]
    tokens = _layer_norm(tokens, cast(enc["ln"]["scale"]), cast(enc["ln"]["bias"]), 1e-5)
    cls = tokens[:, :c].sum(dim=1)
    final = (cls @ cast(params["head"]["kernel"]) + cast(params["head"]["bias"])).float()
    dp = params["decoder"]
    img = tokens[:, s:-1]  # the special tokens and the budget token stripped
    if "decoder_embed" in params:
        img = img @ cast(params["decoder_embed"]["kernel"]) + cast(params["decoder_embed"]["bias"])
    m = torch.sigmoid(last_mask * 100.0).to(compute_dtype)
    dec = img * m + cast(dp["mask_token"]) * (1.0 - m) + cast(dp["pos_embedding"])
    dec = _encoder_stack(dp["encoder"], dec, decoder_num_heads, 1e-5, cast, plain=plain)
    dec = _layer_norm(dec, cast(dp["encoder"]["ln"]["scale"]),
                      cast(dp["encoder"]["ln"]["bias"]), 1e-5)
    rec = dec @ cast(dp["head"]["kernel"]) + cast(dp["head"]["bias"])
    return (final, _unpatchify_cmajor(rec, patch_size).float(),
            _mask_image(m.float(), patch_size))


def residualvit_forward_fused(params, images, budget: float, *, patch_size: int,
                              num_heads: int, num_class_tokens: int = 1,
                              num_registers: int = 0, gate_temp: float = 1.0,
                              gate_bias: float = 0.0, budget_token: Any = "learnable",
                              compute_dtype=torch.bfloat16, early_exits: bool = False,
                              compact_caps: Optional[tuple] = None,
                              masks: Optional[dict] = None, recon: bool = False,
                              decoder_num_heads: Optional[int] = None,
                              noise: Optional[NoiseSpec] = None):
    """ResidualViT eval forward (sigmoid gates, 'attention+mlp' skip, a
    budget token) over the masked-layer kernels (JAX
    ``residualvit_forward_fused``, inference.py:2141). images: (B, H, W, 3);
    ``params`` from ``prepare_engine_params`` (unfolded). Returns fp32
    logits, or with ``early_exits`` the tuple (exit_0, ..., exit_{L-1},
    final) of an early-exit model, or with ``recon`` (an EncDec model) the
    tuple (logits, reconstruction NHWC, mask image) of its decoder on the
    plain folded layer (``decoder_num_heads``, default ``num_heads``;
    JAX :2339-2367).

    Per layer: the gate in fp32 (Dense(1) on the image tokens, then the
    budget-token threshold), gated image tokens multiplied by their mask,
    then ``masked_layer_block`` (block LN eps 1e-6; the final LN 1e-5).

    ``compact_caps`` (one static image-token capacity per layer): after
    each gate the top ``cap`` tokens by gate value are gathered and the
    layers run on ``s + cap + 2`` tokens (special tokens, survivors and
    surplus slots with mask 0, the phantom slot, the budget token). Below
    ``_MERGED_MIN_TOKENS`` tokens the split masked sublayers run. Unlike
    the JAX engine, a layer that keeps every token gives the phantom key
    weight 0 (``phantom_idx`` is set whenever the phantom slot is there),
    so such layers match the exact path.

    ``masks``: if a dict is given, each layer's fp32 gate mask is stored in
    it under ``layer_{i}``, the grammar of the module's ``aux["masks"]``:
    (B, N_img, 1), or with compaction the gate's decision over the image
    slots the layer was given, before the top-``cap`` gather.

    ``noise``: the NoiseBlock before block ``noise.layer`` (ops/noise.py),
    the module's realization where both draw from one generator state."""
    return _residual_forward(
        params, images, budget, _residual_layers(_MASKED_KERNELS, num_heads, compute_dtype),
        patch_size=patch_size, num_class_tokens=num_class_tokens, num_registers=num_registers,
        gate_temp=gate_temp, gate_bias=gate_bias, budget_token=budget_token,
        compute_dtype=compute_dtype, early_exits=early_exits, compact_caps=compact_caps,
        masks=masks, recon_plain=False if recon else None,
        decoder_num_heads=decoder_num_heads or num_heads, noise=noise)


def residualvit_forward_plain(params, images, budget: float, *, patch_size: int,
                              num_heads: int, num_class_tokens: int = 1,
                              num_registers: int = 0, gate_temp: float = 1.0,
                              gate_bias: float = 0.0, budget_token: Any = "learnable",
                              compute_dtype=torch.float32, early_exits: bool = False,
                              compact_caps: Optional[tuple] = None,
                              masks: Optional[dict] = None, recon: bool = False,
                              decoder_num_heads: Optional[int] = None,
                              noise: Optional[NoiseSpec] = None):
    """The same forward with the masked layers (and the decoder's layers)
    on the kernels' plain versions, whatever the device: the reference a
    check holds the engine against on the card."""
    return _residual_forward(
        params, images, budget, _residual_layers(_MASKED_PLAIN, num_heads, compute_dtype),
        patch_size=patch_size, num_class_tokens=num_class_tokens, num_registers=num_registers,
        gate_temp=gate_temp, gate_bias=gate_bias, budget_token=budget_token,
        compute_dtype=compute_dtype, early_exits=early_exits, compact_caps=compact_caps,
        masks=masks, recon_plain=True if recon else None,
        decoder_num_heads=decoder_num_heads or num_heads, noise=noise)


# ---------------------------------------------------------------- RankViT

_RANK_KERNELS = (fused_layer_block_folded, fused_attention_block, fused_mlp_block,
                 keymasked_layer_block_folded)
_RANK_PLAIN = (fused_layer_block_folded_ref, fused_attention_block_ref, fused_mlp_block_ref,
               keymasked_layer_block_folded_ref)


def rank_schedule(n_img: int, ranked: tuple, budget: float,
                  max_budget: Optional[float] = None) -> dict:
    """{ranked layer id: (image tokens the buffer keeps, valid ones among
    them)} of a RankViT forward over ``n_img`` image tokens, ``ranked``
    the ranking layers in forward order.

    Exact drop (``max_budget`` None): each ranked layer keeps
    ``ceil(float32(n_alive) * float32(budget))`` tokens, all valid; none
    ranks at budget >= 1 (JAX inference.py:1161-1167, the float32 product
    as the linen ``_rank_update``). Padded drop: the buffer keeps
    ``keep_max = min(ceil(n * max_budget), n)`` of its n tokens whatever
    the budget, and the first ``ceil(float32(n_valid) * float32(budget))``
    of them are valid (:1261-1273)."""
    out = {}
    if max_budget is None:
        if budget >= 1.0:
            return out
        for i in ranked:
            n_img = int(np.ceil(np.float32(n_img) * np.float32(budget)))
            out[i] = (n_img, n_img)
        return out
    n_valid = np.float32(n_img)
    for i in ranked:
        keep_max = min(math.ceil(n_img * max_budget), n_img)
        n_valid = np.ceil(n_valid * np.float32(budget))
        out[i] = (keep_max, int(n_valid))
        n_img = keep_max
    return out


def _top_by_norm(img, k, valid=None):
    """(B, k) indices of the k image tokens of largest fp32 norm in
    descending order, ties to the lower index (``jax.lax.top_k``'s order:
    a stable sort; torch.topk is not stable); tokens where ``valid`` is 0
    rank last."""
    norms = torch.linalg.vector_norm(img.float(), dim=-1)
    if valid is not None:
        norms = torch.where(valid > 0, norms,
                            torch.full_like(norms, torch.finfo(torch.float32).min))
    return torch.sort(norms, dim=1, descending=True, stable=True).indices[:, :k]


def _rank_layers(blocks, num_heads: int, ln_eps: float, compute_dtype):
    """A RankViT layer over the bf16 blocks (fused_layer_block_folded,
    fused_attention_block, fused_mlp_block, keymasked_layer_block_folded or
    their plain twins) for :func:`_rank_forward`."""
    layer_block, attention_block, mlp_block, keymasked_block = blocks

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, lp, li, key_mask, merged):
        if key_mask is not None:
            return keymasked_block(tokens, key_mask, *_folded_weights(lp, cast), num_heads, ln_eps)
        if merged:
            return layer_block(tokens, *_folded_weights(lp, cast), num_heads, ln_eps)
        at, mlp = lp["self_attention"], lp["mlp"]
        tokens = attention_block(
            tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
            cast(at["in_proj_kernel"]), cast(at["in_proj_bias"]),
            cast(at["out_proj_kernel"]), cast(at["out_proj_bias"]), num_heads, ln_eps)
        return mlp_block(
            tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
            cast(mlp["fc1_kernel"]), cast(mlp["fc1_bias"]),
            cast(mlp["fc2_kernel"]), cast(mlp["fc2_bias"]), ln_eps)

    return run


def _rank_forward(params, images, budget, run_layer, *, patch_size: int, rankvit_layers: tuple,
                  max_budget: Optional[float] = None, num_class_tokens: int = 1,
                  ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                  kept_idx: Optional[dict] = None, kept_out: Optional[dict] = None,
                  fold_embed: bool = True, noise: Optional[NoiseSpec] = None):
    """The RankViT schedule, ranking and gather around ``run_layer(tokens,
    layer params, layer position, key mask or None, merged)``, the bf16
    (:func:`_rank_layers`) or the int8 (:func:`_quant_layers`)
    layer. ``fold_embed=False`` embeds unfolded (the JAX int8 forwards).
    ``noise``: the NoiseBlock before block ``noise.layer``, ahead of its
    rank update (JAX inference.py:1155-1160); the engine keeps it at or
    before the first ranked layer, where the layout is the module's."""

    def cast(t):
        return t.to(compute_dtype)

    c = num_class_tokens
    enc = params["encoder"]
    if fold_embed and "_embed_special" in params:
        tokens, d = _embed_posfolded(params, images, patch_size, cast)
    else:
        tokens, d = _embed(params, images, patch_size, c, 0, cast)
        tokens = tokens + cast(enc["pos_embedding"])
    b, dev = tokens.shape[0], tokens.device
    ids = _layer_ids(enc)
    schedule = rank_schedule(tokens.shape[1] - c, tuple(i for i in ids if i in rankvit_layers),
                             budget, max_budget)
    valid = key_mask = None
    for li, i in enumerate(ids):
        tokens = inject_noise(tokens, i, noise)
        if i in schedule:
            keep, n_valid = schedule[i]
            img = tokens[:, c:]
            if kept_idx is not None:
                idx = kept_idx[i]
                if tuple(idx.shape) != (b, keep):
                    raise ValueError(f"kept_idx[{i}] has shape {tuple(idx.shape)}, "
                                     f"want {(b, keep)}")
            else:
                idx = _top_by_norm(img, keep, valid)
            if kept_out is not None:
                kept_out[i] = idx
            img = torch.gather(img, 1, idx[..., None].expand(-1, -1, d))
            if max_budget is not None:
                # the tail past the budget's count: zeroed, excluded as keys
                # and ranked last from here on
                valid = (torch.arange(keep, device=dev) < n_valid).to(compute_dtype)
                img = img * valid[:, None]
                key_mask = torch.cat([torch.ones(c, dtype=compute_dtype, device=dev), valid])
                key_mask = key_mask.expand(b, 1, c + keep).contiguous()
            tokens = torch.cat([tokens[:, :c], img], dim=1)
        # the split sublayers below 128 tokens (JAX inference.py:1196-1210)
        merged = max_budget is not None or tokens.shape[1] >= _MERGED_MIN_TOKENS
        tokens = run_layer(tokens, enc[f"layers_{i}"], li, key_mask, merged)
    return _classify(params, tokens, c, cast, ln_eps)


def rankvit_forward_fused(params, images, *, budget: float, patch_size: int, num_heads: int,
                          rankvit_layers: tuple, num_class_tokens: int = 1,
                          ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                          kept_out: Optional[dict] = None,
                          noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """RankViT eval forward with the exact physical token drop (JAX
    ``rankvit_forward_fused``, inference.py:1118). images: (B, H, W, 3);
    ``params`` from ``prepare_engine_params(fold_ln=True)``. Returns fp32
    logits.

    At each ranked layer (none at budget >= 1) the top
    ``ceil(float32(n_alive) * float32(budget))`` image tokens by the fp32
    norm of the compute-dtype tokens are gathered in descending-norm order
    (``rank_schedule``); the class tokens stay. Each layer runs
    ``fused_layer_block_folded`` at 128 tokens or more and
    ``fused_attention_block`` + ``fused_mlp_block`` below: the JAX switch,
    kept because it picks the numerics (one-pass LN and an fp32 mid
    residual, or two-pass LN and a bf16 residual). ``kept_out``: if a
    dict is given, each ranked layer's (B, keep) gathered indices are
    stored in it under the layer id."""
    return _rank_forward(params, images, budget,
                         _rank_layers(_RANK_KERNELS, num_heads, ln_eps, compute_dtype),
                         patch_size=patch_size, rankvit_layers=rankvit_layers,
                         num_class_tokens=num_class_tokens, ln_eps=ln_eps,
                         compute_dtype=compute_dtype, kept_out=kept_out, noise=noise)


def rankvit_forward_plain(params, images, *, budget: float, patch_size: int, num_heads: int,
                          rankvit_layers: tuple, num_class_tokens: int = 1,
                          ln_eps: float = 1e-5, compute_dtype=torch.float32,
                          kept_idx: Optional[dict] = None,
                          kept_out: Optional[dict] = None,
                          noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """The same forward on the kernels' plain versions, whatever the device:
    the reference a check holds the engine against on the card.
    ``kept_idx`` ({layer id: (B, keep) indices}, a ``kept_out`` of the
    engine's forward) replaces the ranking, so that both gather the same
    tokens where a bf16 norm tie at the keep boundary would pick others."""
    return _rank_forward(params, images, budget,
                         _rank_layers(_RANK_PLAIN, num_heads, ln_eps, compute_dtype),
                         patch_size=patch_size, rankvit_layers=rankvit_layers,
                         num_class_tokens=num_class_tokens, ln_eps=ln_eps,
                         compute_dtype=compute_dtype, kept_idx=kept_idx,
                         kept_out=kept_out, noise=noise)


def rankvit_forward_padded(params, images, budget: float, *, max_budget: float,
                           patch_size: int, num_heads: int, rankvit_layers: tuple,
                           num_class_tokens: int = 1, ln_eps: float = 1e-5,
                           compute_dtype=torch.bfloat16,
                           kept_out: Optional[dict] = None,
                           noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """RankViT eval forward with the single-shape padded drop (JAX
    ``rankvit_forward_padded``, inference.py:1214): the shapes depend on
    ``max_budget`` alone, so every budget up to it runs the same launches
    on the same shapes (the eager analogue of JAX's one compile).

    Each ranked layer gathers the top ``keep_max = min(ceil(n *
    max_budget), n)`` tokens by fp32 norm, the tokens past
    ``ceil(float32(n_valid) * float32(budget))`` invalid
    (``rank_schedule``): their rows are zeroed, they rank with the
    float32-min norm from then on, and every later layer runs
    ``keymasked_layer_block_folded`` with them excluded as keys (the class
    tokens' key mask is 1). Layers before the first ranked one run
    ``fused_layer_block_folded``. Invalid rows are not re-zeroed after a
    layer; the key mask keeps them inert. ``kept_out`` as in
    :func:`rankvit_forward_fused`, the indices (B, keep_max)."""
    return _rank_forward(params, images, budget,
                         _rank_layers(_RANK_KERNELS, num_heads, ln_eps, compute_dtype),
                         patch_size=patch_size, rankvit_layers=rankvit_layers,
                         max_budget=max_budget, num_class_tokens=num_class_tokens,
                         ln_eps=ln_eps, compute_dtype=compute_dtype, kept_out=kept_out, noise=noise)


def rankvit_forward_padded_plain(params, images, budget: float, *, max_budget: float,
                                 patch_size: int, num_heads: int, rankvit_layers: tuple,
                                 num_class_tokens: int = 1, ln_eps: float = 1e-5,
                                 compute_dtype=torch.float32, kept_idx: Optional[dict] = None,
                                 kept_out: Optional[dict] = None,
                                 noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`rankvit_forward_padded` on the plain versions, ``kept_idx``
    as in :func:`rankvit_forward_plain`."""
    return _rank_forward(params, images, budget,
                         _rank_layers(_RANK_PLAIN, num_heads, ln_eps, compute_dtype),
                         patch_size=patch_size, rankvit_layers=rankvit_layers,
                         max_budget=max_budget, num_class_tokens=num_class_tokens,
                         ln_eps=ln_eps, compute_dtype=compute_dtype, kept_idx=kept_idx,
                         kept_out=kept_out, noise=noise)


# ------------------------------------------------------------ int8 (w8a8)


def quantize_vit_params(params: dict) -> dict:
    """Every layer's four linear weights to int8 with per-output-column
    fp32 scales (``quantize_linear``); the LNs, biases, embed and head stay
    as they are (JAX ``quantize_vit_params``, inference.py:688). The int8
    kernels keep JAX's (in, out) layout, so the tree compares 1:1 with
    JAX's; ``prepare_engine_params`` makes the kernel layout."""
    q = {"conv_proj": params["conv_proj"], "class_tokens": params["class_tokens"],
         "head": params["head"], "encoder": {"pos_embedding": params["encoder"]["pos_embedding"],
                                             "ln": params["encoder"]["ln"]}}
    if "register_tokens" in params:
        q["register_tokens"] = params["register_tokens"]
    for name, lp in params["encoder"].items():
        if not name.startswith("layers_"):
            continue
        at = lp["self_attention"]
        wqkv_q, sqkv = quantize_linear(at["in_proj_kernel"])
        wo_q, so = quantize_linear(at["out_proj_kernel"])
        w1_q, s1 = quantize_linear(lp["mlp"]["fc1_kernel"])
        w2_q, s2 = quantize_linear(lp["mlp"]["fc2_kernel"])
        q["encoder"][name] = {
            "ln_1": lp["ln_1"], "ln_2": lp["ln_2"],
            "wqkv_q": wqkv_q, "sqkv": sqkv, "bqkv": at["in_proj_bias"],
            "wo_q": wo_q, "so": so, "bo": at["out_proj_bias"],
            "w1_q": w1_q, "s1": s1, "b1": lp["mlp"]["fc1_bias"],
            "w2_q": w2_q, "s2": s2, "b2": lp["mlp"]["fc2_bias"],
        }
    return q


def _calibration_layers(params, images, *, patch_size, num_heads, num_class_tokens,
                        num_registers, ln_eps):
    """The fp32 eager forward the JAX calibrations mirror (two-pass LN,
    linen's attention core, tanh-gelu): yields each layer's params and its
    four quantized sites' inputs (ln1, attn, ln2, h)."""

    def cast(t):
        return t.float()

    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])
    for i in _layer_ids(enc):
        lp = enc[f"layers_{i}"]
        at, mlp = lp["self_attention"], lp["mlp"]
        ln1 = _layer_norm(tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]), ln_eps)
        qkv = ln1 @ cast(at["in_proj_kernel"]) + cast(at["in_proj_bias"])
        q, k, v = qkv.chunk(3, dim=-1)
        attn = attention_core(q, k, v, num_heads)
        tokens = tokens + attn @ cast(at["out_proj_kernel"]) + cast(at["out_proj_bias"])
        ln2 = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]), ln_eps)
        h = F.gelu(ln2 @ cast(mlp["fc1_kernel"]) + cast(mlp["fc1_bias"]), approximate="tanh")
        tokens = tokens + h @ cast(mlp["fc2_kernel"]) + cast(mlp["fc2_bias"])
        yield lp, (ln1, attn, ln2, h)


def _percentile(x: torch.Tensor, q: float) -> float:
    """numpy's (and jnp's) linear-interpolation percentile of |x|, on the
    host: torch.quantile refuses inputs above 2^24 elements."""
    return float(np.percentile(x.abs().float().cpu().numpy(), q))


def collect_activation_caps(params, images, *, patch_size: int, num_heads: int,
                            num_class_tokens: int = 1, num_registers: int = 0,
                            ln_eps: float = 1e-5, percentile: float = 99.9) -> tuple:
    """Static activation caps for the w8a8 engines (JAX
    ``collect_activation_caps``, inference.py:716): the ``percentile`` of
    |activation| at each layer's four quantized sites over a fp32 forward
    of ``images``, as ((attn_ln, attn_out), (mlp_ln, mlp_h)) per layer."""
    with torch.no_grad():
        return tuple(((_percentile(ln1, percentile), _percentile(attn, percentile)),
                      (_percentile(ln2, percentile), _percentile(h, percentile)))
                     for _, (ln1, attn, ln2, h) in _calibration_layers(
                         params, images, patch_size=patch_size, num_heads=num_heads,
                         num_class_tokens=num_class_tokens, num_registers=num_registers,
                         ln_eps=ln_eps))


def _smoothing_vec(act: torch.Tensor, w: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """s_j = max|act_j|^alpha / max|W_j,:|^(1 - alpha), clipped to [1e-2,
    1e4], fp32 (JAX ``_smoothing_vec``, inference.py:1002)."""
    a = act.float().reshape(-1, act.shape[-1]).abs().amax(0)
    wmax = w.float().abs().amax(1)
    s = a.clamp(min=1e-5) ** alpha / wmax.clamp(min=1e-5) ** (1.0 - alpha)
    return s.clamp(1e-2, 1e4)


def compute_smoothing_vectors(params, images, *, patch_size: int, num_heads: int,
                              num_class_tokens: int = 1, num_registers: int = 0,
                              ln_eps: float = 1e-5, alpha: float = 0.5) -> list:
    """SmoothQuant per-channel equalization vectors for each layer's two
    LN-output sites, [(s1, s2), ...] (JAX ``compute_smoothing_vectors``,
    inference.py:957)."""
    with torch.no_grad():
        return [(_smoothing_vec(ln1, lp["self_attention"]["in_proj_kernel"], alpha),
                 _smoothing_vec(ln2, lp["mlp"]["fc1_kernel"], alpha))
                for lp, (ln1, _, ln2, _) in _calibration_layers(
                    params, images, patch_size=patch_size, num_heads=num_heads,
                    num_class_tokens=num_class_tokens, num_registers=num_registers,
                    ln_eps=ln_eps)]


def smooth_vit_params(params: dict, smoothing) -> dict:
    """A fp32 copy of ``params`` with the equalization baked in: each LN's
    scale and bias divided by s, the next weight's rows multiplied by s
    (exact in real arithmetic; JAX ``smooth_vit_params``, inference.py:1011)."""
    params = tree_map(lambda t: t.float().clone(), params)
    enc = params["encoder"]
    for li, i in enumerate(_layer_ids(enc)):
        lp = enc[f"layers_{i}"]
        s1, s2 = (torch.as_tensor(s, dtype=torch.float32, device=lp["ln_1"]["scale"].device)
                  for s in smoothing[li])
        lp["ln_1"]["scale"] /= s1
        lp["ln_1"]["bias"] /= s1
        lp["self_attention"]["in_proj_kernel"] *= s1[:, None]
        lp["ln_2"]["scale"] /= s2
        lp["ln_2"]["bias"] /= s2
        lp["mlp"]["fc1_kernel"] *= s2[:, None]
    return params


def _quant_weights(lp, cast):
    """A quantized layer's 16 arguments in the int8 blocks' order."""
    return (cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]), lp["wqkv_q"], lp["sqkv"],
            cast(lp["bqkv"]), lp["wo_q"], lp["so"], cast(lp["bo"]), cast(lp["ln_2"]["scale"]),
            cast(lp["ln_2"]["bias"]), lp["w1_q"], lp["s1"], cast(lp["b1"]), lp["w2_q"],
            lp["s2"], cast(lp["b2"]))


_QUANT_KERNELS = (quant_layer_block, quant_attention_block, quant_mlp_block,
                  quant_keymasked_layer_block)
_QUANT_PLAIN = (quant_layer_block_ref, quant_attention_block_ref, quant_mlp_block_ref,
                quant_keymasked_layer_block_ref)


def _quant_layers(blocks, num_heads: int, ln_eps: float, compute_dtype, caps):
    """The int8 layer for :func:`_rank_forward` (and the ViT stack): the
    merged layer (key-masked under a key mask), else the split sublayers;
    ``caps`` one static pair of pairs per layer, or None."""
    layer_block, attention_block, mlp_block, keymasked_block = blocks

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, lp, li, key_mask, merged):
        w = _quant_weights(lp, cast)
        lcaps = caps[li] if caps else None
        if key_mask is not None:
            return keymasked_block(tokens, key_mask, *w, num_heads, ln_eps, lcaps)
        if merged:
            return layer_block(tokens, *w, num_heads, ln_eps, lcaps)
        tokens = attention_block(tokens, *w[:8], num_heads, ln_eps, lcaps[0] if lcaps else None)
        return mlp_block(tokens, *w[8:], ln_eps, lcaps[1] if lcaps else None)

    return run


def _vit_quant(blocks, params, images, *, patch_size, num_heads, num_class_tokens,
               num_registers, ln_eps, compute_dtype, caps, noise=None):
    run = _quant_layers(blocks, num_heads, ln_eps, compute_dtype, caps)

    def encoder(enc, tokens, cast):
        for li, i in enumerate(_layer_ids(enc)):
            tokens = run(inject_noise(tokens, i, noise), enc[f"layers_{i}"], li, None, True)
        return tokens

    return _vit_forward(params, images, encoder, patch_size=patch_size,
                        num_class_tokens=num_class_tokens, num_registers=num_registers,
                        ln_eps=ln_eps, compute_dtype=compute_dtype)


def vit_forward_quant(qparams, images, *, patch_size: int, num_heads: int,
                      num_class_tokens: int = 1, num_registers: int = 0, ln_eps: float = 1e-5,
                      compute_dtype=torch.bfloat16, caps=None,
                      noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """int8 (w8a8) eval forward of a plain ViT (JAX ``vit_forward_quant``,
    inference.py:1029) from ``prepare_engine_params(quantize_vit_params(
    ...), fold_ln=True)``: the folded embed, then ``quant_layer_block`` on
    every layer (the port has no VMEM guard: the merged layer at every
    width), ``caps`` per layer or None (dynamic scales), ``noise`` as in
    :func:`vit_forward_fused` (JAX :1072). Returns fp32 logits."""
    return _vit_quant(_QUANT_KERNELS, qparams, images, patch_size=patch_size,
                      num_heads=num_heads, num_class_tokens=num_class_tokens,
                      num_registers=num_registers, ln_eps=ln_eps, compute_dtype=compute_dtype,
                      caps=caps, noise=noise)


def vit_forward_quant_plain(qparams, images, *, patch_size: int, num_heads: int,
                            num_class_tokens: int = 1, num_registers: int = 0,
                            ln_eps: float = 1e-5, compute_dtype=torch.float32,
                            caps=None, noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`vit_forward_quant` on the kernels' plain versions, whatever
    the device."""
    return _vit_quant(_QUANT_PLAIN, qparams, images, patch_size=patch_size, num_heads=num_heads,
                      num_class_tokens=num_class_tokens, num_registers=num_registers,
                      ln_eps=ln_eps, compute_dtype=compute_dtype, caps=caps, noise=noise)


def _rank_quant(blocks, qparams, images, budget, *, num_heads, ln_eps, compute_dtype, caps,
                **kw):
    return _rank_forward(qparams, images, budget,
                         _quant_layers(blocks, num_heads, ln_eps, compute_dtype, caps),
                         ln_eps=ln_eps, compute_dtype=compute_dtype, fold_embed=False, **kw)


def rankvit_forward_quant(qparams, images, *, budget: float, patch_size: int, num_heads: int,
                          rankvit_layers: tuple, num_class_tokens: int = 1, ln_eps: float = 1e-5,
                          compute_dtype=torch.bfloat16, caps=None,
                          kept_out: Optional[dict] = None,
                          noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """int8 RankViT with the exact physical drop (JAX
    ``rankvit_forward_quant``, inference.py:1393): ``rankvit_forward_fused``'s
    schedule, ranking and gather, ``quant_layer_block`` from 128 tokens up
    and ``quant_attention_block`` + ``quant_mlp_block`` below. It embeds
    UNFOLDED (the conv bias, then the pos-embedding added in the compute
    dtype), as the JAX int8 RankViT forwards do: in bf16 that rounds
    otherwise than the folded embed."""
    return _rank_quant(_QUANT_KERNELS, qparams, images, budget, num_heads=num_heads,
                       ln_eps=ln_eps, compute_dtype=compute_dtype, caps=caps,
                       patch_size=patch_size, rankvit_layers=rankvit_layers,
                       num_class_tokens=num_class_tokens, kept_out=kept_out, noise=noise)


def rankvit_forward_quant_plain(qparams, images, *, budget: float, patch_size: int,
                                num_heads: int, rankvit_layers: tuple, num_class_tokens: int = 1,
                                ln_eps: float = 1e-5, compute_dtype=torch.float32, caps=None,
                                kept_idx: Optional[dict] = None,
                                kept_out: Optional[dict] = None,
                                noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`rankvit_forward_quant` on the plain versions, ``kept_idx`` as
    in :func:`rankvit_forward_plain`."""
    return _rank_quant(_QUANT_PLAIN, qparams, images, budget, num_heads=num_heads,
                       ln_eps=ln_eps, compute_dtype=compute_dtype, caps=caps,
                       patch_size=patch_size, rankvit_layers=rankvit_layers,
                       num_class_tokens=num_class_tokens, kept_idx=kept_idx,
                       kept_out=kept_out, noise=noise)


def rankvit_forward_padded_quant(qparams, images, budget: float, *, max_budget: float,
                                 patch_size: int, num_heads: int, rankvit_layers: tuple,
                                 num_class_tokens: int = 1, ln_eps: float = 1e-5,
                                 compute_dtype=torch.bfloat16, caps=None,
                                 kept_out: Optional[dict] = None,
                                 noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """int8 RankViT with the single-shape padded drop (JAX
    ``rankvit_forward_padded_quant``, inference.py:1313):
    ``rankvit_forward_padded``'s schedule, every layer the merged int8
    layer, ``quant_keymasked_layer_block`` from the first ranked layer on;
    the unfolded embed of :func:`rankvit_forward_quant`."""
    return _rank_quant(_QUANT_KERNELS, qparams, images, budget, num_heads=num_heads,
                       ln_eps=ln_eps, compute_dtype=compute_dtype, caps=caps,
                       patch_size=patch_size, rankvit_layers=rankvit_layers,
                       max_budget=max_budget, num_class_tokens=num_class_tokens,
                       kept_out=kept_out, noise=noise)


def rankvit_forward_padded_quant_plain(qparams, images, budget: float, *, max_budget: float,
                                       patch_size: int, num_heads: int, rankvit_layers: tuple,
                                       num_class_tokens: int = 1, ln_eps: float = 1e-5,
                                       compute_dtype=torch.float32, caps=None,
                                       kept_idx: Optional[dict] = None,
                                       kept_out: Optional[dict] = None,
                                       noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`rankvit_forward_padded_quant` on the plain versions."""
    return _rank_quant(_QUANT_PLAIN, qparams, images, budget, num_heads=num_heads,
                       ln_eps=ln_eps, compute_dtype=compute_dtype, caps=caps,
                       patch_size=patch_size, rankvit_layers=rankvit_layers,
                       max_budget=max_budget, num_class_tokens=num_class_tokens,
                       kept_idx=kept_idx, kept_out=kept_out, noise=noise)


# ------------------------------------------------------- ResidualViT int8 (w8a8)


def quantize_residualvit_params(params: dict) -> dict:
    """:func:`quantize_vit_params` for the ResidualViT family (JAX
    ``quantize_residualvit_params``, inference.py:1971): the four big
    matrices int8; the gate projections, the budget-token gates, the
    learnable budget tokens and the early-exit heads stay as they are."""
    q = quantize_vit_params(params)
    for name, lp in params["encoder"].items():
        if name.startswith("early_exit_heads_"):
            q["encoder"][name] = lp
        elif name.startswith("layers_"):
            q["encoder"][name]["residual_gate"] = lp["residual_gate"]
            if "budget_token_gate" in lp:
                q["encoder"][name]["budget_token_gate"] = lp["budget_token_gate"]
    for key in ("learnable_budget_token_1", "learnable_budget_token_2"):
        if key in params:
            q[key] = params[key]
    return q


def collect_residualvit_activation_stats(params, images, budget: float = 1.0, *,
                                         patch_size: int, num_heads: int,
                                         num_class_tokens: int = 1, num_registers: int = 0,
                                         gate_temp: float = 1.0, gate_bias: float = 0.0,
                                         budget_token: Any = "learnable",
                                         percentile: float = 99.9):
    """Calibration of the ResidualViT int8 engine (JAX
    ``collect_residualvit_activation_stats``, inference.py:768): an fp32
    eager forward with the gates and the masked LNs (two-pass, eps 1e-6),
    linen's attention core and tanh-gelu, at ``budget`` (1.0: masking only
    removes tokens, so full-budget statistics bound every sparser budget).
    Returns ``(caps, smoothing)``: per layer the ``percentile`` of
    |activation| at the four quantized sites, ((attn_ln, attn_out),
    (mlp_ln, mlp_h)), and the SmoothQuant vectors (s1, s2) of the two
    masked LN outputs."""

    def cast(t):
        return t.float()

    with torch.no_grad():
        c = num_class_tokens
        tokens, d = _embed(params, images, patch_size, c, num_registers, cast)
        b, dev = tokens.shape[0], tokens.device
        enc = params["encoder"]
        tokens = tokens + cast(enc["pos_embedding"])
        bcast = torch.full((b, 1, 1), float(budget), dtype=torch.float32, device=dev)
        if budget_token == "learnable":
            btok = cast(params["learnable_budget_token_1"]) * bcast
        elif budget_token == "learnable_interpolate":
            btok = (cast(params["learnable_budget_token_1"]) * bcast
                    + cast(params["learnable_budget_token_2"]) * (1.0 - bcast))
        else:
            btok = bcast
        tokens = torch.cat([tokens, btok.expand(b, 1, d)], dim=1)
        s = c + num_registers
        ones = torch.ones((b, s, 1), dtype=torch.float32, device=dev)
        caps, smoothing = [], []
        for i in _layer_ids(enc):
            lp = enc[f"layers_{i}"]
            at, mlp = lp["self_attention"], lp["mlp"]
            img = tokens[:, s:-1]
            gp = lp["residual_gate"]["projection"]
            sig = torch.sigmoid((img @ cast(gp["kernel"]) + cast(gp["bias"])) / gate_temp
                                + gate_bias)
            if budget_token == "learnable":
                bg = lp["budget_token_gate"]
                thr = torch.sigmoid(tokens[:, -1:] @ cast(bg["kernel"]) + cast(bg["bias"]))
                mask = torch.relu(sig - thr)
            else:
                mask = torch.relu(sig - (1.0 - tokens[:, -1:].mean()))
            fwd_mask = torch.cat([ones, mask, ones[:, :1]], dim=1)
            tokens = torch.cat([tokens[:, :s], mask * img, tokens[:, -1:]], dim=1)
            ln1 = _layer_norm(tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
                              1e-6) * fwd_mask
            qkv = ln1 @ cast(at["in_proj_kernel"]) + cast(at["in_proj_bias"])
            attn = attention_core(*qkv.chunk(3, dim=-1), num_heads)
            tokens = tokens + (attn @ cast(at["out_proj_kernel"])
                               + cast(at["out_proj_bias"])) * fwd_mask
            ln2 = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                              1e-6) * fwd_mask
            h = F.gelu(ln2 @ cast(mlp["fc1_kernel"]) + cast(mlp["fc1_bias"]), approximate="tanh")
            tokens = tokens + h @ cast(mlp["fc2_kernel"]) + cast(mlp["fc2_bias"])
            caps.append(((_percentile(ln1, percentile), _percentile(attn, percentile)),
                         (_percentile(ln2, percentile), _percentile(h, percentile))))
            smoothing.append((_smoothing_vec(ln1, at["in_proj_kernel"]),
                              _smoothing_vec(ln2, mlp["fc1_kernel"])))
    return tuple(caps), smoothing


# the classes whose quantized matmuls are exactly the four per-encoder-layer
# fake-quant sites, by class name (JAX inference.py:860-863)
_QAT_PLAIN_FAMILIES = ("VisionTransformer", "RankVisionTransformer")
_QAT_RESIDUAL_FAMILIES = ("ResidualVisionTransformer", "EEResidualVisionTransformer")


def _qat_family(module) -> str:
    """'plain' | 'residual', or ``NotImplementedError`` for every class
    outside the registry (decoders, expert stacks, ACT blocks and PCT
    quantize outside the four calibrated per-encoder-layer sites)."""
    name = type(module).__name__
    if name in _QAT_PLAIN_FAMILIES:
        return "plain"
    if name in _QAT_RESIDUAL_FAMILIES:
        return "residual"
    raise NotImplementedError(
        "calibrated qat ('static' / smoothed) supports exactly "
        f"{_QAT_PLAIN_FAMILIES + _QAT_RESIDUAL_FAMILIES}; got {name} (decoders / expert "
        "stacks / ACT blocks quantize outside the four calibrated per-encoder-layer sites)")


def _qat_inputs(model, images):
    """The model's weights (detached, on its device) and ``images`` there in
    fp32."""
    params = module_params(model)
    device = next(model.parameters()).device
    return params, torch.as_tensor(images).to(device, torch.float32)


def _qat_geometry(model, family: str, percentile: float) -> dict:
    geom = dict(patch_size=model.patch_size, num_heads=model.num_heads,
                num_class_tokens=getattr(model, "num_class_tokens", 1),
                num_registers=getattr(model, "num_registers", 0))
    if family == "residual":
        geom.update(gate_temp=model.gate_temp, gate_bias=model.gate_bias,
                    budget_token=model.add_budget_token, percentile=percentile)
    else:
        geom["ln_eps"] = getattr(model, "ln_eps", 1e-5)
    return geom


def collect_qat_caps(model, images, *, percentile: float = 99.9, budget: float = 1.0) -> tuple:
    """Static caps for ``Trainer(qat="static")`` on the unsmoothed weights
    (JAX ``collect_qat_caps``, inference.py:882): the plain ViT and RankViT
    through :func:`collect_activation_caps` at full token count, the
    ResidualViT family through :func:`collect_residualvit_activation_stats`
    at ``budget``. The engine's calibration-free static grid; to train
    against its default calibrated grid use :func:`collect_qat_calibration`."""
    family = _qat_family(model)
    params, images = _qat_inputs(model, images)
    geom = _qat_geometry(model, family, percentile)
    if family == "residual":
        return collect_residualvit_activation_stats(params, images, budget, **geom)[0]
    return collect_activation_caps(params, images, percentile=percentile, **geom)


def collect_qat_calibration(model, images, *, percentile: float = 99.9, budget: float = 1.0,
                            alpha: float = 0.5):
    """``(caps, smoothing)`` for ``Trainer(qat="static", qat_caps=,
    qat_smoothing=)``, in the order the engine calibrates (JAX
    ``collect_qat_calibration``, inference.py:918): the SmoothQuant
    vectors from the raw weights, then the caps collected on
    ``smooth_vit_params`` of them, so that the grid trained against is the
    grid ``InferenceEngine(quantized=True, calib_images=,
    calib_static_caps=True)`` serves."""
    family = _qat_family(model)
    params, images = _qat_inputs(model, images)
    geom = _qat_geometry(model, family, percentile)
    if family == "residual":
        _, smoothing = collect_residualvit_activation_stats(params, images, budget, **geom)
        caps, _ = collect_residualvit_activation_stats(
            smooth_vit_params(params, smoothing), images, budget, **geom)
        return caps, tuple(smoothing)
    smoothing = compute_smoothing_vectors(params, images, alpha=alpha, **geom)
    caps = collect_activation_caps(smooth_vit_params(params, smoothing), images,
                                   percentile=percentile, **geom)
    return caps, tuple(smoothing)


def _quant_residual_layers(layer_block, num_heads: int, compute_dtype, caps):
    """The int8 ResidualViT layer for :func:`_residual_forward`: the merged
    masked int8 layer on every layer (the int8 engine does not compact, so
    there is no phantom key and no split sublayer; the port has no VMEM
    guard), ``caps`` one static pair of pairs per layer, or None."""

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, fwd_mask, lp, li, merged, ph_mult, ph_idx):
        return layer_block(tokens, fwd_mask, *_quant_weights(lp, cast), num_heads, 1e-6,
                           caps[li] if caps else None)

    return run


def residualvit_forward_quant(qparams, images, budget: float, *, patch_size: int,
                              num_heads: int, num_class_tokens: int = 1,
                              num_registers: int = 0, gate_temp: float = 1.0,
                              gate_bias: float = 0.0, budget_token: Any = "learnable",
                              compute_dtype=torch.bfloat16, early_exits: bool = False,
                              caps=None, masks: Optional[dict] = None,
                              noise: Optional[NoiseSpec] = None):
    """int8 (w8a8) ResidualViT eval forward (JAX
    ``residualvit_forward_quant``, inference.py:1990) from
    ``prepare_engine_params(quantize_residualvit_params(...))``: the gates,
    budget token and early exits of :func:`residualvit_forward_fused` (fp32
    gates, fp exit heads, LN eps 1e-5), every layer
    ``quant_masked_layer_block`` (block LN eps 1e-6), no compaction.
    ``caps``: per layer ((attn_ln, attn_out), (mlp_ln, mlp_h)) static caps
    or None (dynamic scales); ``masks`` as in
    :func:`residualvit_forward_fused`."""
    return _residual_forward(
        qparams, images, budget,
        _quant_residual_layers(quant_masked_layer_block, num_heads, compute_dtype, caps),
        patch_size=patch_size, num_class_tokens=num_class_tokens, num_registers=num_registers,
        gate_temp=gate_temp, gate_bias=gate_bias, budget_token=budget_token,
        compute_dtype=compute_dtype, early_exits=early_exits, masks=masks, noise=noise)


def residualvit_forward_quant_plain(qparams, images, budget: float, *, patch_size: int,
                                    num_heads: int, num_class_tokens: int = 1,
                                    num_registers: int = 0, gate_temp: float = 1.0,
                                    gate_bias: float = 0.0, budget_token: Any = "learnable",
                                    compute_dtype=torch.float32, early_exits: bool = False,
                                    caps=None, masks: Optional[dict] = None,
                                    noise: Optional[NoiseSpec] = None):
    """:func:`residualvit_forward_quant` on the plain versions, whatever
    the device."""
    return _residual_forward(
        qparams, images, budget,
        _quant_residual_layers(quant_masked_layer_block_ref, num_heads, compute_dtype, caps),
        patch_size=patch_size, num_class_tokens=num_class_tokens, num_registers=num_registers,
        gate_temp=gate_temp, gate_bias=gate_bias, budget_token=budget_token,
        compute_dtype=compute_dtype, early_exits=early_exits, masks=masks, noise=noise)


# ------------------------------------------------------------------- A-ViT


def _adavit_forward(params, images, layer_block, *, patch_size: int, num_heads: int,
                    num_layers: int, num_class_tokens: int = 1, num_registers: int = 0,
                    act_eps: float = 0.01, gate_scale: float = 10.0, gate_center: float = 30.0,
                    ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                    active_in: Optional[list] = None, active_out: Optional[list] = None):
    def cast(t):
        return t.to(compute_dtype)

    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])
    bp = enc["blocks"]["block"]  # a leading (num_layers, ...) axis
    at, mlp = bp["self_attention"], bp["mlp"]
    b, n, _ = tokens.shape
    f32 = torch.float32
    out = tokens
    output = torch.zeros_like(tokens)
    c = torch.zeros((b, n), dtype=f32, device=tokens.device)
    R = torch.ones_like(c)
    active = torch.ones_like(c)
    threshold = 1.0 - act_eps
    for li in range(num_layers):
        a3 = active[..., None].to(compute_dtype)
        x_new = layer_block(
            out * a3, a3, cast(bp["ln_1"]["scale"][li]), cast(bp["ln_1"]["bias"][li]),
            cast(at["in_proj_kernel"][li]), cast(at["in_proj_bias"][li]),
            cast(at["out_proj_kernel"][li]), cast(at["out_proj_bias"][li]),
            cast(bp["ln_2"]["scale"][li]), cast(bp["ln_2"]["bias"][li]),
            cast(mlp["fc1_kernel"][li]), cast(mlp["fc1_bias"][li]),
            cast(mlp["fc2_kernel"][li]), cast(mlp["fc2_bias"][li]), num_heads, ln_eps)
        h = torch.sigmoid(x_new[:, :, 0].float() * gate_scale - gate_center)
        if li == num_layers - 1:  # every remaining token halts
            h = torch.ones_like(h)
        block_out = x_new * a3
        c = c + h
        above, below = (c > threshold).to(f32), (c < threshold).to(f32)
        if active_in is not None:
            above, below = active_in[li]
        if active_out is not None:
            active_out.append((above, below))
        reached = above * active
        delta1 = block_out * (R * reached)[..., None].to(compute_dtype)
        R = R - below * h
        delta2 = block_out * (h * below)[..., None].to(compute_dtype)
        active = below
        output = output + delta1 + delta2
        out = x_new
    return _classify({"encoder": enc, "head": params["head"]}, output, num_class_tokens, cast,
                     ln_eps)


def adavit_forward_fused(params, images, *, patch_size: int, num_heads: int, num_layers: int,
                         num_class_tokens: int = 1, num_registers: int = 0,
                         act_eps: float = 0.01, gate_scale: float = 10.0,
                         gate_center: float = 30.0, ln_eps: float = 1e-5,
                         compute_dtype=torch.bfloat16,
                         active_out: Optional[list] = None) -> torch.Tensor:
    """A-ViT eval forward (JAX ``adavit_forward_fused``, inference.py:1906)
    from ``prepare_engine_params`` (unfolded, the block's stacked weights
    sliced per layer). The ACT carry (cumulative halting c, remainder R,
    the active mask) runs in torch in fp32, the tokens and the output sum
    in the compute dtype; each layer is ``avit_layer_block`` on the
    kernels, fed the masked tokens and the active mask. Returns fp32
    logits.

    ``active_out``: if a list is given, each layer's halting decisions are
    appended to it as the fp32 (B, N) pair (c > 1 - eps, c < 1 - eps),
    for :func:`adavit_forward_plain`'s ``active_in``."""
    return _adavit_forward(params, images, avit_layer_block, patch_size=patch_size,
                           num_heads=num_heads, num_layers=num_layers,
                           num_class_tokens=num_class_tokens, num_registers=num_registers,
                           act_eps=act_eps, gate_scale=gate_scale, gate_center=gate_center,
                           ln_eps=ln_eps, compute_dtype=compute_dtype, active_out=active_out)


def adavit_forward_plain(params, images, *, patch_size: int, num_heads: int, num_layers: int,
                         num_class_tokens: int = 1, num_registers: int = 0,
                         act_eps: float = 0.01, gate_scale: float = 10.0,
                         gate_center: float = 30.0, ln_eps: float = 1e-5,
                         compute_dtype=torch.float32, active_in: Optional[list] = None,
                         active_out: Optional[list] = None) -> torch.Tensor:
    """:func:`adavit_forward_fused` on the plain versions, whatever the
    device. ``active_in`` (an ``active_out`` of the engine's forward)
    replaces the halting decisions layer by layer: c > 1 - eps is a hard
    threshold, so a token whose c lies within a rounding of it can halt at
    another depth in a bf16 run with sums in another order."""
    return _adavit_forward(params, images, avit_layer_block_ref, patch_size=patch_size,
                           num_heads=num_heads, num_layers=num_layers,
                           num_class_tokens=num_class_tokens, num_registers=num_registers,
                           act_eps=act_eps, gate_scale=gate_scale, gate_center=gate_center,
                           ln_eps=ln_eps, compute_dtype=compute_dtype, active_in=active_in,
                           active_out=active_out)


# --------------------------------------------------------------------- PCT


def _bn_eval(x, pr, st, eps: float = 1e-5):
    """Inference-mode BatchNorm from the running statistics, in fp32 (JAX
    ``_bn_eval``, inference.py:512): ((x - mean) * rsqrt(var + eps)) *
    scale + bias."""
    inv = torch.rsqrt(st["var"].float() + eps)
    return ((x.float() - st["mean"].float()) * inv * pr["scale"].float().reshape(-1)
            + pr["bias"].float().reshape(-1))


def prepare_pct_engine_params(params: dict, batch_stats: dict, compute_dtype=None) -> dict:
    """The PCT engine tree (JAX ``prepare_pct_engine_params``,
    inference.py:636): the blocks under ``encoder`` so that
    :func:`prepare_engine_params` folds and stacks them (``fold_ln=True``),
    ``embedder`` and ``head`` cast to ``compute_dtype`` with everything
    else (the head's weights are rounded there and lifted back to fp32 in
    the forward, as in JAX), ``_bn_stats`` the fp32 ``batch_stats``, and
    the ARPE pack ``embedder._arpe_kernel_pack`` folded in fp32 from the
    original weights: each BatchNorm's running affine into its Dense,
    W' = W * a, b' = (b - mean) * a + bias with a = rsqrt(var + 1e-5) *
    scale per output channel; wc = Wa' + Wb', wb = Wb' (the point and the
    difference halves of lin1's rows), unpadded."""
    tree = {"embedder": params["embedder"], "head": params["head"],
            "encoder": {k: v for k, v in params.items() if k.startswith("layers_")}}
    out = prepare_engine_params(tree, compute_dtype, fold_ln=True)

    def bn_fold(w, b, pr, bn):
        a = torch.rsqrt(bn["var"].float() + 1e-5) * pr["scale"].float().reshape(-1)
        return (w.float() * a[None, :],
                (b.float().reshape(-1) - bn["mean"].float()) * a + pr["bias"].float().reshape(-1))

    emb, ebs = params["embedder"], batch_stats["embedder"]
    w1, b1 = bn_fold(emb["lin1"]["kernel"], emb["lin1"]["bias"], emb["bn1"], ebs["bn1"])
    w2, b2 = bn_fold(emb["lin2"]["kernel"], emb["lin2"]["bias"], emb["bn2"], ebs["bn2"])
    c = w1.shape[0] // 2
    wa, wb = w1[:c], w1[c:]
    out["embedder"]["_arpe_kernel_pack"] = {
        "wc": (wa + wb).contiguous(), "wb": wb.contiguous(), "b1": b1.contiguous(),
        "w2": w2.contiguous(), "b2": b2.contiguous()}
    out["_bn_stats"] = tree_map(lambda t: t.float(), batch_stats)
    return out


def _pct_embed(params, points, num_points, compute_dtype, arpe):
    """ARPE tokens of (B, N, 3) points in the compute dtype, k =
    int(32 * num_points / 512)."""
    pack = params["embedder"]["_arpe_kernel_pack"]
    k = int(32 * num_points / 512)
    return arpe(points.float().contiguous(), pack["wc"], pack["wb"], pack["b1"], pack["w2"],
                pack["b2"], k, out_dtype=compute_dtype)


def _pct_head(params, pooled):
    """The classifier on the fp32 pooled tokens: lin1 -> BatchNorm (running
    statistics) -> exact gelu -> lin2, fp32 (JAX inference.py:562-568)."""
    hd, hbs = params["head"], params["_bn_stats"]["head"]
    z = pooled @ hd["lin1"]["kernel"].float() + hd["lin1"]["bias"].float().reshape(-1)
    z = F.gelu(_bn_eval(z, hd["bn1"], hbs["bn1"]), approximate="none")
    return (z @ hd["lin2"]["kernel"].float() + hd["lin2"]["bias"].float().reshape(-1)).float()


def _pct_forward(params, points, arpe, encoder: Callable, *, num_points: int, compute_dtype):
    def cast(t):
        return t.to(compute_dtype)

    tokens = encoder(params["encoder"], _pct_embed(params, points, num_points, compute_dtype,
                                                   arpe), cast)
    return _pct_head(params, tokens.float().mean(dim=1))


def pct_forward_fused(params, points, *, num_heads: int, num_points: int, ln_eps: float = 1e-5,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """PCT eval forward (JAX ``pct_forward_fused``, inference.py:521) from
    :func:`prepare_pct_engine_params`. points: (B, N, 3). The ARPE kernel
    (``arpe_tokens``, one launch) writes the tokens in the compute dtype,
    the blocks run the plain folded stack (``encoder_layers_one_call``, 7
    launches per layer), then the fp32 mean over all tokens and the
    BatchNorm head in torch. Returns fp32 logits."""
    return _pct_forward(
        params, points, arpe_tokens,
        lambda enc, tokens, cast: _encoder_stack(enc, tokens, num_heads, ln_eps, cast),
        num_points=num_points, compute_dtype=compute_dtype)


def pct_forward_plain(params, points, *, num_heads: int, num_points: int, ln_eps: float = 1e-5,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """:func:`pct_forward_fused` on the kernels' plain versions, whatever
    the device: the reference a check holds the engine against on the
    card."""
    return _pct_forward(
        params, points, arpe_tokens_ref,
        lambda enc, tokens, cast: encoder_layers_one_call_ref(
            tokens, tree_map(cast, enc["_stacked_layers"]), num_heads, ln_eps),
        num_points=num_points, compute_dtype=compute_dtype)


def _rankpct_forward(params, points, budget, arpe, layer_block, *, ranking: tuple,
                     num_heads: int, num_points: int, ln_eps: float, compute_dtype,
                     kept_idx: Optional[dict] = None, kept_out: Optional[dict] = None):
    def cast(t):
        return t.to(compute_dtype)

    tokens = _pct_embed(params, points, num_points, compute_dtype, arpe)
    enc = params["encoder"]
    b, alive, d = tokens.shape
    for i in _layer_ids(enc):
        if ranking[i] and budget is not None:
            n_keep = max(min(int(np.ceil(alive * float(budget))), alive), 1)
            if n_keep < alive:
                rest = tokens[:, 1:]
                if kept_idx is not None:
                    idx = kept_idx[i]
                    if tuple(idx.shape) != (b, n_keep - 1):
                        raise ValueError(f"kept_idx[{i}] has shape {tuple(idx.shape)}, "
                                         f"want {(b, n_keep - 1)}")
                else:
                    # the reference's tie-break: a stable argsort of -norms
                    norms = torch.linalg.vector_norm(rest.float(), dim=-1)
                    idx = torch.argsort(-norms, dim=-1, stable=True)[:, :n_keep - 1]
                if kept_out is not None:
                    kept_out[i] = idx
                kept = torch.gather(rest, 1, idx[..., None].expand(-1, -1, d))
                tokens = torch.cat([tokens[:, :1], kept], dim=1)
                alive = n_keep
        tokens = layer_block(tokens, *_folded_weights(enc[f"layers_{i}"], cast), num_heads, ln_eps)
    return _pct_head(params, tokens.float().sum(dim=1) / float(alive))


def rankpct_forward_fused(params, points, *, budget: Optional[float], ranking: tuple,
                          num_heads: int, num_points: int, ln_eps: float = 1e-5,
                          compute_dtype=torch.bfloat16,
                          kept_out: Optional[dict] = None) -> torch.Tensor:
    """RankPCT eval forward with the physical token drop (JAX
    ``rankpct_forward_fused``, inference.py:572). Before each layer whose
    ``ranking`` flag is set (none without a budget) the layer keeps
    ``n = max(min(ceil(alive * budget), alive), 1)`` tokens (the float64
    product, as JAX): position 0 and the ``n - 1`` others of largest fp32
    norm, gathered in descending-norm order (a stable argsort of -norms).
    Every layer runs ``fused_layer_block_folded`` at its width, down to
    the last (no 128-token switch to the split sublayers here, as in JAX),
    and the mean divides by the survivor count. ``kept_out``: if a dict is
    given, each dropping layer's (B, n - 1) indices into the previous
    tokens after position 0 are stored in it under the layer id. Returns
    fp32 logits."""
    return _rankpct_forward(params, points, budget, arpe_tokens, fused_layer_block_folded,
                            ranking=ranking, num_heads=num_heads, num_points=num_points,
                            ln_eps=ln_eps, compute_dtype=compute_dtype, kept_out=kept_out)


def rankpct_forward_plain(params, points, *, budget: Optional[float], ranking: tuple,
                          num_heads: int, num_points: int, ln_eps: float = 1e-5,
                          compute_dtype=torch.float32, kept_idx: Optional[dict] = None,
                          kept_out: Optional[dict] = None) -> torch.Tensor:
    """:func:`rankpct_forward_fused` on the plain versions, whatever the
    device. ``kept_idx`` (a ``kept_out`` of the engine's forward) replaces
    the ranking, so that both gather the same tokens where a bf16 norm tie
    at the keep boundary would pick others."""
    return _rankpct_forward(params, points, budget, arpe_tokens_ref, fused_layer_block_folded_ref,
                            ranking=ranking, num_heads=num_heads, num_points=num_points,
                            ln_eps=ln_eps, compute_dtype=compute_dtype, kept_idx=kept_idx,
                            kept_out=kept_out)


# --------------------------------------------------------------------- MoE


def _expert_choice(y, gp, key, expert_ids: Optional[dict], expert_out: Optional[dict]):
    """(B, N) expert index of each token of an MoE sublayer's input y:
    argmax of the fp32 gate scores (the eval gate, first maximal index), or
    ``expert_ids[key]`` when given; stored in ``expert_out[key]``. The gate
    product stays true fp32 on the card: torch leaves
    ``torch.backends.cuda.matmul.allow_tf32`` False, and the port does not
    turn it on (a TF32 product would move near-tied scores)."""
    if expert_ids is not None:
        eid = expert_ids[key]
    else:
        scores = y.float() @ gp["gate"]["kernel"].float() + gp["gate"]["bias"].float().reshape(-1)
        eid = scores.argmax(-1)
    if expert_out is not None:
        expert_out[key] = eid
    return eid


def _routed_moe_mlp(z, gating, experts, cast, capacity_factor: float, eid=None):
    """Top-1 routed MoE MLP (JAX ``_routed_moe_mlp``, inference.py:1481):
    each token runs its own expert only. Tokens sort by expert id
    (stable), each expert's segment gathers into an (E, cap) buffer with
    ``cap = ceil(T / E * capacity_factor)`` rows, the experts run as one
    batched product per weight (erf-gelu), and each token gathers its row
    back through the inverse permutation. Equal to the dense combine while
    no expert overflows; an overflow token (the latest in token order
    within its expert) contributes exactly zero. ``eid``: the tokens' (B,
    N) experts, else from the fp32 gate. Plain torch on every device, as
    XLA in JAX."""
    b, n, d = z.shape
    t = b * n
    e_total = experts["fc1_kernel"].shape[0]
    cap = int(np.ceil(t / e_total * capacity_factor))
    zf = z.reshape(t, d)
    if eid is None:
        eid = _expert_choice(zf, gating, None, None, None)
    eid = eid.reshape(t)
    order = torch.sort(eid, stable=True).indices
    counts = torch.bincount(eid, minlength=e_total)
    offsets = torch.cumsum(counts, 0) - counts
    cidx = torch.arange(cap, device=z.device)[None, :]
    slot_valid = cidx < counts[:, None]
    src = torch.where(slot_valid, offsets[:, None] + cidx, 0)
    buf = zf[order[src.reshape(-1)]]
    buf = torch.where(slot_valid.reshape(-1, 1), buf, 0).reshape(e_total, cap, d)
    h = F.gelu(torch.bmm(buf, cast(experts["fc1_kernel"])) + cast(experts["fc1_bias"])[:, None, :],
               approximate="none")
    out = torch.bmm(h, cast(experts["fc2_kernel"])) + cast(experts["fc2_bias"])[:, None, :]
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(t, device=z.device))
    rank = inv - offsets[eid]
    idx = (eid * cap + rank).clamp(0, e_total * cap - 1)
    combined = torch.where((rank < cap)[:, None], out.reshape(e_total * cap, d)[idx], 0)
    return combined.reshape(b, n, d).to(z.dtype)


def _moe_layers(blocks, num_heads: int, ln_eps: float, compute_dtype,
                routed_capacity: Optional[float], routed_min_experts: int):
    """An MoE layer over the bf16 blocks (``fused_layer_block_folded``,
    ``fused_attention_block``, ``fused_mlp_block`` or their plain twins)
    for :func:`_moe_forward`: the folded layer where both sublayers have
    one expert, else each sublayer on its own: one expert on its block, E
    experts densely in torch (linen's attention core, erf-gelu MLPs) with
    the one-hot combine, or routed (:func:`_routed_moe_mlp`)."""
    layer_block, attention_block, mlp_block = blocks

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, lp, choose, n_attn, n_mlp):
        if n_attn == 1 and n_mlp == 1:
            return layer_block(tokens, *_folded_weights(_single_expert_view(lp), cast),
                               num_heads, ln_eps)
        at, mlp = lp["self_attention"], lp["mlp"]
        d = tokens.shape[-1]
        if n_attn == 1:
            a0 = at["experts_0"]
            tokens = attention_block(
                tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]),
                cast(a0["in_proj_kernel"]), cast(a0["in_proj_bias"]),
                cast(a0["out_proj_kernel"]), cast(a0["out_proj_bias"]), num_heads, ln_eps)
        else:
            y = _layer_norm(tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]), ln_eps)
            eid = choose(y, at["gating_network"], "attn")
            ex, outs = at["experts"], []
            for e in range(n_attn):
                qkv = y @ cast(ex["in_proj_kernel"][e]) + cast(ex["in_proj_bias"][e])
                o = attention_core(*qkv.split(d, dim=-1), num_heads)
                outs.append(o @ cast(ex["out_proj_kernel"][e]) + cast(ex["out_proj_bias"][e]))
            tokens = tokens + combine(torch.stack(outs), F.one_hot(eid, n_attn).to(y.dtype))
        if n_mlp == 1:
            m0 = mlp["experts_0"]
            return mlp_block(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]),
                             cast(m0["fc1_kernel"]), cast(m0["fc1_bias"]),
                             cast(m0["fc2_kernel"]), cast(m0["fc2_bias"]), ln_eps)
        z = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]), ln_eps)
        eid = choose(z, mlp["gating_network"], "mlp")
        ex = mlp["experts"]
        if routed_capacity is not None and n_mlp >= routed_min_experts:
            # below routed_min_experts the dense layer is cheaper than the
            # dispatch (JAX inference.py:1674-1684)
            return tokens + _routed_moe_mlp(z, mlp["gating_network"], ex, cast,
                                            routed_capacity, eid)
        h = F.gelu(torch.einsum("bnd,edm->ebnm", z, cast(ex["fc1_kernel"]))
                   + cast(ex["fc1_bias"])[:, None, None, :], approximate="none")
        outs = (torch.einsum("ebnm,emd->ebnd", h, cast(ex["fc2_kernel"]))
                + cast(ex["fc2_bias"])[:, None, None, :])
        return tokens + combine(outs, F.one_hot(eid, n_mlp).to(z.dtype))

    return run


def _moe_quant_layers(blocks, num_heads: int, ln_eps: float, compute_dtype):
    """An int8 MoE layer over ``quant_layer_block``, ``quant_attention_block``,
    ``quant_mlp_block`` and ``quant_experts`` (or their plain twins) for
    :func:`_moe_forward`: single sublayers on the int8 blocks (dynamic
    scales), E experts each through ``quant_experts`` (the sublayer's
    input quantized once), erf-gelu in fp32, h in the compute dtype, the
    one-hot fp32 combine rounded to the tokens' dtype."""
    layer_block, attention_block, mlp_block, experts = blocks

    def cast(t):
        return t.to(compute_dtype)

    def run(tokens, lp, choose, n_attn, n_mlp):
        at, mlp = lp["self_attention"], lp["mlp"]
        if n_attn == 1 or n_mlp == 1:
            w = _quant_weights({**at, **mlp, "ln_1": lp["ln_1"], "ln_2": lp["ln_2"]}, cast)
        if n_attn == 1 and n_mlp == 1:
            return layer_block(tokens, *w, num_heads, ln_eps)
        d = tokens.shape[-1]
        if n_attn == 1:
            tokens = attention_block(tokens, *w[:8], num_heads, ln_eps)
        else:
            y = _layer_norm(tokens, cast(lp["ln_1"]["scale"]), cast(lp["ln_1"]["bias"]), ln_eps)
            eid = choose(y, at["gating_network"], "attn")
            outs = []
            for e, qkv in enumerate(experts(y, at["wqkv_q"], at["sqkv"], cast(at["bqkv"]))):
                o = attention_core(*cast(qkv).split(d, dim=-1), num_heads)
                outs += experts(o, at["wo_q"][e:e + 1], at["so"][e:e + 1], cast(at["bo"][e:e + 1]))
            tokens = tokens + combine(torch.stack(outs),
                                      F.one_hot(eid, n_attn).float()).to(tokens.dtype)
        if n_mlp == 1:
            return mlp_block(tokens, *w[8:], ln_eps)
        z = _layer_norm(tokens, cast(lp["ln_2"]["scale"]), cast(lp["ln_2"]["bias"]), ln_eps)
        eid = choose(z, mlp["gating_network"], "mlp")
        outs = []
        for e, h in enumerate(experts(z, mlp["w1_q"], mlp["s1"], cast(mlp["b1"]))):
            h = cast(F.gelu(h, approximate="none"))
            outs += experts(h, mlp["w2_q"][e:e + 1], mlp["s2"][e:e + 1], cast(mlp["b2"][e:e + 1]))
        return tokens + combine(torch.stack(outs), F.one_hot(eid, n_mlp).float()).to(tokens.dtype)

    return run


def _moe_forward(params, images, run_layer, *, patch_size: int, mlp_moes: tuple,
                 attn_moes: tuple, ln_eps: float, compute_dtype,
                 expert_ids: Optional[dict] = None, expert_out: Optional[dict] = None,
                 noise: Optional[NoiseSpec] = None):
    """The MoE ViT around ``run_layer`` (:func:`_moe_layers` or
    :func:`_moe_quant_layers`): the embed with the one class token and the
    pos-embedding, the layers, the final LN on token 0 alone, the head,
    fp32 logits (the model's classifier quirk, JAX inference.py:1696-1705).
    ``expert_ids`` / ``expert_out``: {(layer id, "attn" | "mlp"): (B, N)
    expert indices} read in place of the gates' argmax / written.
    ``noise``: the NoiseBlock before block ``noise.layer`` (JAX
    inference.py:1602)."""

    def cast(t):
        return t.to(compute_dtype)

    x = cast(images)
    wconv = cast(params["conv_proj"]["kernel"])
    d = wconv.shape[-1]
    tokens = _patchify(x, patch_size) @ wconv.reshape(-1, d) + cast(params["conv_proj"]["bias"])
    cls = cast(params["class_token"]).reshape(1, 1, d).expand(tokens.shape[0], 1, d)
    enc = params["encoder"]
    tokens = torch.cat([cls, tokens], dim=1) + cast(enc["pos_embedding"])
    for li, i in enumerate(_layer_ids(enc)):
        def choose(y, gp, sub, i=i):
            return _expert_choice(y, gp, (i, sub), expert_ids, expert_out)

        tokens = run_layer(inject_noise(tokens, i, noise), enc[f"layers_{i}"], choose,
                           attn_moes[li], mlp_moes[li])
    cls = _layer_norm(tokens[:, :1], cast(enc["ln"]["scale"]), cast(enc["ln"]["bias"]),
                      ln_eps)[:, 0]
    return (cls @ cast(params["head"]["kernel"]) + cast(params["head"]["bias"])).float()


_MOE_KERNELS = (fused_layer_block_folded, fused_attention_block, fused_mlp_block)
_MOE_PLAIN = (fused_layer_block_folded_ref, fused_attention_block_ref, fused_mlp_block_ref)
_MOE_QUANT_KERNELS = (quant_layer_block, quant_attention_block, quant_mlp_block, quant_experts)
_MOE_QUANT_PLAIN = (quant_layer_block_ref, quant_attention_block_ref, quant_mlp_block_ref,
                    quant_experts_ref)


def moevit_forward_fused(params, images, *, patch_size: int, num_heads: int, mlp_moes: tuple,
                         attn_moes: tuple, ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                         routed_capacity: Optional[float] = None, routed_min_experts: int = 3,
                         expert_out: Optional[dict] = None,
                         noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """Eval forward of the MoE ViT (JAX ``moevit_forward_fused``,
    inference.py:1541) from ``prepare_engine_params(fold_ln=True)``.
    images: (B, H, W, 3). Per layer: both sublayers with one expert, the
    folded layer (``fused_layer_block_folded``, 7 launches); else the
    attention on ``fused_attention_block`` (4) or E experts densely in
    torch with the one-hot combine, then the MLP on ``fused_mlp_block``
    (3) or E erf-gelu experts densely, or routed (``_routed_moe_mlp``)
    where ``routed_capacity`` is set and E >= ``routed_min_experts``. The
    gates argmax fp32 scores. The port has no VMEM budget: every
    single-expert sublayer takes the kernels. ``expert_out``: if a dict is
    given, each gate's (B, N) choices are stored in it under (layer id,
    "attn" | "mlp"). Returns fp32 logits."""
    return _moe_forward(params, images,
                        _moe_layers(_MOE_KERNELS, num_heads, ln_eps, compute_dtype,
                                    routed_capacity, routed_min_experts),
                        patch_size=patch_size, mlp_moes=mlp_moes, attn_moes=attn_moes,
                        ln_eps=ln_eps, compute_dtype=compute_dtype, expert_out=expert_out,
                        noise=noise)


def moevit_forward_plain(params, images, *, patch_size: int, num_heads: int, mlp_moes: tuple,
                         attn_moes: tuple, ln_eps: float = 1e-5, compute_dtype=torch.float32,
                         routed_capacity: Optional[float] = None, routed_min_experts: int = 3,
                         expert_ids: Optional[dict] = None,
                         expert_out: Optional[dict] = None,
                         noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`moevit_forward_fused` on the plain versions, whatever the
    device. ``expert_ids`` (an ``expert_out`` of the engine's forward)
    replaces the gates' choices, so that both run the same experts where a
    bf16 near-tie of two scores would pick another."""
    return _moe_forward(params, images,
                        _moe_layers(_MOE_PLAIN, num_heads, ln_eps, compute_dtype,
                                    routed_capacity, routed_min_experts),
                        patch_size=patch_size, mlp_moes=mlp_moes, attn_moes=attn_moes,
                        ln_eps=ln_eps, compute_dtype=compute_dtype, expert_ids=expert_ids,
                        expert_out=expert_out, noise=noise)


def quantize_moevit_params(params: dict) -> dict:
    """The int8 tree of an MoE ViT (JAX ``quantize_moevit_params``,
    inference.py:1715): every expert's four weights symmetric per output
    column (``quantize_linear``; a stack (E, in, out) per expert, with
    (E, 1, out) scales), under ``self_attention`` (``wqkv_q``, ``sqkv``,
    ``bqkv``, ``wo_q``, ``so``, ``bo``, and the ``gating_network`` of a
    multi-expert sublayer) and ``mlp`` (``w1_q`` ... ``b2``); the gates,
    LNs, embed and head stay as they are."""

    def q(w):
        if w.dim() == 2:
            return quantize_linear(w)
        return tuple(torch.stack(t) for t in zip(*(quantize_linear(we) for we in w)))

    enc = params["encoder"]
    out = {"conv_proj": params["conv_proj"], "class_token": params["class_token"],
           "head": params["head"], "encoder": {"pos_embedding": enc["pos_embedding"],
                                               "ln": enc["ln"]}}
    for name, lp in enc.items():
        if not name.startswith("layers_"):
            continue
        subs = {}
        for sub, names in (("self_attention", (("wqkv_q", "sqkv", "bqkv", "in_proj"),
                                               ("wo_q", "so", "bo", "out_proj"))),
                           ("mlp", (("w1_q", "s1", "b1", "fc1"), ("w2_q", "s2", "b2", "fc2")))):
            src = lp[sub].get("experts_0", lp[sub].get("experts"))
            node = subs[sub] = {}
            for wq_key, s_key, b_key, stem in names:
                node[wq_key], node[s_key] = q(src[f"{stem}_kernel"])
                node[b_key] = src[f"{stem}_bias"]
            if "gating_network" in lp[sub]:
                node["gating_network"] = lp[sub]["gating_network"]
        out["encoder"][name] = {"ln_1": lp["ln_1"], "ln_2": lp["ln_2"], **subs}
    return out


def moevit_forward_quant(qparams, images, *, patch_size: int, num_heads: int, mlp_moes: tuple,
                         attn_moes: tuple, ln_eps: float = 1e-5, compute_dtype=torch.bfloat16,
                         expert_out: Optional[dict] = None,
                         noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """int8 (w8a8) eval forward of the MoE ViT (JAX ``moevit_forward_quant``,
    inference.py:1770) from ``prepare_engine_params(quantize_moevit_params(
    ...))``, dynamic scales: both sublayers with one expert on
    ``quant_layer_block`` (9 launches), else ``quant_attention_block`` (5)
    or the experts through ``quant_experts`` (1 + 3 E launches), then
    ``quant_mlp_block`` (4) or the experts (1 + 3 E). ``expert_out`` as
    in :func:`moevit_forward_fused`. Returns fp32 logits."""
    return _moe_forward(qparams, images,
                        _moe_quant_layers(_MOE_QUANT_KERNELS, num_heads, ln_eps, compute_dtype),
                        patch_size=patch_size, mlp_moes=mlp_moes, attn_moes=attn_moes,
                        ln_eps=ln_eps, compute_dtype=compute_dtype, expert_out=expert_out,
                        noise=noise)


def moevit_forward_quant_plain(qparams, images, *, patch_size: int, num_heads: int,
                               mlp_moes: tuple, attn_moes: tuple, ln_eps: float = 1e-5,
                               compute_dtype=torch.float32, expert_ids: Optional[dict] = None,
                               expert_out: Optional[dict] = None,
                               noise: Optional[NoiseSpec] = None) -> torch.Tensor:
    """:func:`moevit_forward_quant` on the plain versions, whatever the
    device, ``expert_ids`` as in :func:`moevit_forward_plain`."""
    return _moe_forward(qparams, images,
                        _moe_quant_layers(_MOE_QUANT_PLAIN, num_heads, ln_eps, compute_dtype),
                        patch_size=patch_size, mlp_moes=mlp_moes, attn_moes=attn_moes,
                        ln_eps=ln_eps, compute_dtype=compute_dtype, expert_ids=expert_ids,
                        expert_out=expert_out, noise=noise)


def _model_axis(mesh) -> int:
    """A mesh's model axis size (1 without a mesh)."""
    return 1 if mesh is None else mesh.shape.get("model", 1)


class InferenceEngine:
    """Fused eval forward bound to a built plain ViT, ResidualViT (early-exit
    and EncDec included), RankViT, A-ViT, MAE, MoE, PCT or RankPCT.

    ``device`` defaults to the card and raises when there is none; pass
    ``device="cpu"`` to run the kernels' plain versions on the CPU. On the
    card the kernels take bf16 only.

    ResidualViT (the shipped mode: sigmoid gates, 'attention+mlp' on every
    layer, a budget token, ``add_input=False``): ``engine(images,
    budget=b)``, the budget 1.0 by default. ``ee_outputs=True`` (an
    early-exit model) returns the tuple of every exit and the final
    logits. ``compact=`` turns gate sparsity into less work: a float
    capacity for every layer, a per-layer schedule of fractions, or
    ``True`` for min(1, budget + ``compact_slack``) per budget; a capacity
    is ceil(c * N_img) rounded up to a multiple of 8, and one that covers
    every token runs the exact path.

    ``recon_outputs=True`` (an EncDec ResidualViT or an MAE, not int8, as
    in JAX): the EncDec engine returns (logits,
    reconstruction NHWC, mask image), its decoder on the plain folded
    layer after the masked encoder; the MAE engine (logits,
    reconstruction). Without it both return the logits. It raises on any
    other family, with ``quantized=``, with ``compact=`` (compaction loses
    the token positions the decoder needs) and under a tensor-parallel
    ``mesh=`` (queue A item 9).

    MAE: ``engine(images)`` (``maevit_forward_fused``: no shuffle at eval,
    the encoder and ``decoder_blocks`` on the plain folded stack); bf16
    eval only, ``quantized=`` and ``max_budget=`` raise.

    RankViT: ``engine(images, budget=b)``, the budget 1.0 by default. By
    default the exact physical drop (``rankvit_forward_fused``: the shapes
    shrink with the budget); ``max_budget=`` the padded drop
    (``rankvit_forward_padded``: one set of shapes for every budget up to
    ``max_budget``; a budget above it raises ``ValueError``).

    A-ViT: ``engine(images)`` (``adavit_forward_fused``: the ACT carry in
    torch, each layer on ``avit_layer_block``), bf16 only.

    MoE: ``engine(images)`` (``moevit_forward_fused``: single-expert
    sublayers on the kernels, the experts densely in torch with the
    fp32 one-hot gate). ``routed=True`` (capacity factor 2.0) or a float >
    0 routes the MLP experts of every layer with at least
    ``routed_min_experts`` of them (``_routed_moe_mlp``), bf16 only.
    ``quantized=True`` serves int8 (``quantize_moevit_params``,
    ``moevit_forward_quant``: dynamic scales; ``calib_images=`` raises).
    ``max_budget=`` raises.

    PCT: ``engine(points)``, points (B, N, 3) (``pct_forward_fused``).
    RankPCT: ``engine(points, budget=b)`` (``rankpct_forward_fused``, the
    physical drop): the ranking flags are read when the engine is built
    (call ``enable_ranking`` first); with ranking on, the budget is 1.0 by
    default; with none on, no layer ranks and the budget is ignored. Both
    are bf16 eval only, as in JAX: ``quantized=`` and ``max_budget=``
    raise, as do registers and a model without its BatchNorm statistics.

    ``quantized=True`` (ViT, RankViT and the ResidualViT family) serves
    int8 w8a8 (``vit_forward_quant``, ``rankvit_forward_quant``, with
    ``max_budget=`` ``rankvit_forward_padded_quant``,
    ``residualvit_forward_quant``, ``ee_outputs=`` included): weights
    quantized per output column at build, activations per row.
    ``calib_images=`` (NHWC) calibrates: SmoothQuant vectors baked into
    the weights before they are quantized, and with
    ``calib_static_caps=True`` static activation caps (the
    ``calib_percentile`` of |activation|) from the smoothed model, the JAX
    engine's recipe (JAX inference.py:2773-2804, :2845-2893); a
    ResidualViT calibrates on its own gated, masked forward
    (``collect_residualvit_activation_stats``) at budget 1.0.

    ``mesh=`` (``parallel.make_mesh``, built by every rank of the process
    group, and so is the engine; ``device`` names the mesh device's type).
    Each rank takes the whole batch, which the data axis size must divide
    (JAX's message), and returns the whole batch's outputs. A model axis
    > 1 serves tensor-parallel (``parallel/tp_serving.py``: the Megatron
    partials of ``ops/cuda/tp_blocks.py``, one all-reduce per sublayer):
    the bf16 plain ViT, RankViT's exact drop and the ResidualViT family,
    early exits included. A model axis of 1 serves data-parallel, what
    JAX's shard-mapped engine serves (inference.py:2444-2462): every family
    and mode above, each rank running the single-device forward on its rows
    and the outputs gathered over the data column
    (``parallel/data.over_data``); the ResidualViT budget token's
    whole-batch mean is averaged over the data column (JAX's ``pmean``),
    and the NoiseBlock draws over the global batch, so the outputs are
    the single-device engine's (JAX's shards each redraw their own rows'
    noise from the same key). A routed MoE sizes each rank's expert
    capacity from its own tokens, as JAX's shards do (ROADMAP queue C).

    A model with a NoiseBlock (``noise_layer``): ``engine(images,
    noise_value=, noise_rng=)`` (see :meth:`__call__`) on the ViT,
    ResidualViT-family, RankViT and MoE engines, bf16 and int8. As in JAX
    (inference.py:2526-2584) it raises with ``compact=``, on a RankViT
    whose noise layer comes after its first ranked layer, under a
    tensor-parallel mesh, and on the A-ViT engine (its noise sits inside
    the ACT loop: serve noise sweeps of an A-ViT from its module)."""

    def __init__(self, model, compute_dtype=torch.bfloat16, device="cuda",
                 quantized: bool = False, max_budget: Optional[float] = None,
                 calib_images: Any = None, calib_percentile: float = 99.9,
                 calib_static_caps: bool = False,
                 mesh: Any = None, compact: Any = None, compact_slack: float = 0.0,
                 ee_outputs: bool = False, recon_outputs: bool = False, routed: Any = None,
                 routed_min_experts: int = 3):
        # RankViT first: it is no VisionTransformer, and a plain-ViT path
        # would ignore its budget
        rank = isinstance(model, RankVisionTransformer)
        moe = isinstance(model, VisionTransformerMoE)
        self._routed = 2.0 if routed is True else (float(routed) if routed is not None else None)
        if routed is not None:
            if not moe:
                raise NotImplementedError(
                    "routed= (top-1 capacity dispatch) applies to VisionTransformerMoE engines "
                    "only")
            if quantized:
                raise NotImplementedError(
                    "routed= is bf16-only: the int8 MoE engine quantizes per expert stack and "
                    "has no routed dispatch variant (serve dense int8 or routed bf16)")
            if self._routed <= 0:
                raise ValueError("routed= capacity factor must be > 0")
        residual = isinstance(model, ResidualVisionTransformer)
        avit = isinstance(model, AdaptiveVisionTransformer)
        pct = isinstance(model, (PointCloudTransformer, RankPointCloudTransformer))
        mae = isinstance(model, MAEVisionTransformer)
        if not (rank or residual or avit or pct or mae or moe
                or isinstance(model, VisionTransformer)):
            raise NotImplementedError(
                f"the port's engine serves the plain VisionTransformer, the ResidualViT "
                f"family, RankViT, A-ViT, MAE, MoE, PCT and RankPCT, not "
                f"{type(model).__name__}")
        # the NoiseBlock of a model built with one (JAX inference.py:2532-2534)
        noise_layer = getattr(model, "noise_layer", None)
        self._noise = (None if noise_layer is None
                       else (int(noise_layer), getattr(model, "noise_type", "gaussian")))
        if recon_outputs and not (mae or isinstance(model, ResidualVisionTransformerWithDecoder)):
            raise NotImplementedError(
                "recon_outputs=True needs a model with a reconstruction decoder (MAE or "
                "EncDec-Residual)")
        if mae and (quantized or max_budget is not None):
            raise NotImplementedError(
                "the MAE engine is bf16 eval only (no quantized / max_budget modes; the model "
                "takes no budget)")
        if recon_outputs and quantized:
            raise NotImplementedError(
                "recon_outputs=True is bf16-only: the int8 residual path has no quantized "
                "decoder blocks")
        if avit and (quantized or max_budget is not None):
            raise NotImplementedError(
                "the A-ViT engine is bf16-only by design: int8 would quantize the "
                "halting-score inputs feeding the hard ACT threshold c > 1-eps (token depths "
                "flip against the module), and the avit-mode masked kernels have no quant "
                "variants")
        if pct and (quantized or max_budget is not None):
            raise NotImplementedError(
                "the PCT engine is bf16 eval only (no quantized / max_budget / noise modes)")
        if pct and model.num_registers:
            raise NotImplementedError(
                "PCT engine: num_registers > 0 not supported (the reference PCT config never "
                "sets it)")
        if moe and max_budget is not None:
            raise NotImplementedError("max_budget= (padded rank drop) does not apply to MoE")
        if moe and quantized and calib_images is not None:
            raise NotImplementedError(
                "calib_images=: the int8 MoE engine quantizes its activations per row, "
                "as JAX's, and takes no calibration")
        if max_budget is not None and not rank:
            raise NotImplementedError(
                "max_budget= (the single-shape padded drop) applies to RankViT models only "
                "(ROADMAP.md port queue A item 5)")
        if compact is not None:
            if not residual:
                raise NotImplementedError(
                    "compact= (token-compaction serving) applies to the ResidualViT family "
                    "- other families either have no gates or already drop physically (RankViT)")
            if quantized or recon_outputs or _model_axis(mesh) > 1:
                raise NotImplementedError(
                    "compact= is a bf16 single-program mode: int8 would redefine the "
                    "calibrated grid per capacity, the recon decoder needs token positions "
                    "compaction discards, and the TP partial kernels have no compacted "
                    "variants (serve those dense or data-parallel)")
            if noise_layer is not None:
                raise NotImplementedError(
                    "compact= changes the token layout under the NoiseBlock; run noise sweeps "
                    "on the exact masked engine")
        ranked = tuple(getattr(model, "rankvit_layers", ()) or ())
        if noise_layer is not None and ranked and noise_layer > min(ranked):
            raise NotImplementedError(
                "engine noise must precede the first ranked layer (the physical drop changes "
                "the token layout the NoiseBlock samples over); use the module for a later "
                "noise_layer")
        if avit and noise_layer is not None:
            raise NotImplementedError(
                "A-ViT applies noise inside the ACT loop on the carried tokens; use the module "
                "for A-ViT noise sweeps")
        if ee_outputs and not isinstance(model, EEResidualVisionTransformer):
            raise NotImplementedError("ee_outputs=True needs an EEResidualVisionTransformer")
        # a mesh with a model axis > 1 serves tensor-parallel; any other
        # data-parallel
        tp = _model_axis(mesh) > 1
        if recon_outputs and tp:
            raise NotImplementedError(
                "tensor-parallel serving (mesh model axis > 1) covers the bf16 plain/Rank "
                "VisionTransformer and ResidualViT-family engines; serve other families / modes "
                "data-parallel (make_mesh(n_model=1))")
        if residual:
            layers = model.residual_layers or ["attention+mlp"] * model.num_layers
            if (set(layers) != {"attention+mlp"} or model.gate_type != "sigmoid"
                    or model.add_input or not model.add_budget_token):
                raise NotImplementedError(
                    "fused ResidualViT engine supports the shipped-config mode: sigmoid gates, "
                    "attention+mlp skip, budget token, add_input=False (SURVEY.md section 7.6)")
        if tp and (avit or pct or mae or moe or quantized or max_budget is not None
                   or noise_layer is not None):
            raise NotImplementedError(
                "tensor-parallel serving (a mesh with a model axis > 1) covers the bf16 plain "
                "ViT, RankViT (exact drop) and ResidualViT-family engines; other families and "
                "modes (quantized=, max_budget=, a NoiseBlock) have no partial kernels: serve "
                "them on one device")
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device {mesh.device} is not on the engine's "
                                 f"device type {self.device.type!r}")
            self.device = mesh.device
        if self.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "the CUDA kernels take bf16 only; an fp32 engine on the card is "
                "ROADMAP.md port queue B item 15 (fp32 on CUDA)")
        self._module = model
        self._residual = residual
        # every budget-token mode but 'learnable' takes the whole batch's
        # budget-token mean (_residual_forward), so one image's outputs
        # depend on its batchmates: serving must not zero-pad such a batch
        # (JAX inference.py:2559-2567). The routed MoE's whole-batch
        # capacity couples a batch too; JAX does not mark it, nor does the
        # port (ROADMAP.md queue C)
        self._batch_coupled = bool(residual and model.add_budget_token
                                   not in (False, None, "learnable"))
        self._rank = rank
        self._avit = avit
        self._pct = pct
        self._moe = moe
        self._mae = mae
        self._quantized = bool(quantized)
        self.caps = None
        self._mesh = mesh
        self._dp = None if mesh is None or tp else mesh
        self._tp_make = None
        if tp:
            from peekvit_torch.parallel.tp_serving import tp_serving_engine

            self.params, self._tp_make = tp_serving_engine(
                model, mesh, compute_dtype=compute_dtype, ee_outputs=bool(ee_outputs))
            return
        if pct:
            params, stats = (tree_map(lambda t: t.to(self.device), tree)
                             for tree in module_state(model))
            if not all("bn1" in stats.get(sub, {}) for sub in ("embedder", "head")):
                raise NotImplementedError("PCT engine needs the model's batch_stats collection")
            self._forward = dict(num_heads=model.num_heads, num_points=model.num_points,
                                 ln_eps=1e-5, compute_dtype=compute_dtype)
            # RankPCT: the ranking flags as they are now (JAX reads them at
            # engine build); None for a PCT
            self._ranking = (tuple(model.ranking_enabled or (False,) * model.num_layers)
                             if isinstance(model, RankPointCloudTransformer) else None)
            self.params = prepare_pct_engine_params(params, stats, compute_dtype)
            return
        params = tree_map(lambda t: t.to(self.device), module_params(model))
        if moe:
            self._forward = dict(patch_size=model.patch_size, num_heads=model.num_heads,
                                 mlp_moes=model.mlp_moes, attn_moes=model.attn_moes,
                                 ln_eps=1e-5, compute_dtype=compute_dtype)
            if quantized:
                with torch.no_grad():
                    self.params = prepare_engine_params(quantize_moevit_params(params),
                                                        compute_dtype)
                return
            self._forward.update(routed_capacity=self._routed,
                                 routed_min_experts=int(routed_min_experts))
            self.params = prepare_engine_params(params, compute_dtype, fold_ln=True)
            return
        if mae:
            # no shuffle at eval: the full sequence through both stacks
            self._forward = dict(
                patch_size=model.patch_size, num_heads=model.num_heads,
                num_decoder_heads=model.num_decoder_heads,
                num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
                ln_eps=1e-5, compute_dtype=compute_dtype, recon=bool(recon_outputs))
            self.params = prepare_engine_params(params, compute_dtype, fold_ln=True)
            return
        if quantized:
            params = self._quantize(params, calib_images, calib_percentile, calib_static_caps)
        if rank:
            self._forward = dict(
                patch_size=model.patch_size, num_heads=model.num_heads,
                rankvit_layers=model.rankvit_layers, num_class_tokens=model.num_class_tokens,
                ln_eps=model.ln_eps, compute_dtype=compute_dtype)
            self._max_budget = None if max_budget is None else float(max_budget)
            self.params = prepare_engine_params(params, compute_dtype, fold_ln=True)
            return
        if avit:
            self._forward = dict(
                patch_size=model.patch_size, num_heads=model.num_heads,
                num_layers=model.num_layers, num_class_tokens=model.num_class_tokens,
                num_registers=model.num_registers, act_eps=model.eps,
                gate_scale=model.gate_scale, gate_center=model.gate_center,
                ln_eps=model.ln_eps, compute_dtype=compute_dtype)
            self.params = prepare_engine_params(params, compute_dtype)
            return
        if not residual:
            self._forward = dict(
                patch_size=model.patch_size, num_heads=model.num_heads,
                num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
                ln_eps=model.ln_eps, compute_dtype=compute_dtype)
            self.params = prepare_engine_params(params, compute_dtype, fold_ln=True)
            return
        self._forward = dict(
            patch_size=model.patch_size, num_heads=model.num_heads,
            num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
            gate_temp=model.gate_temp, gate_bias=model.gate_bias,
            budget_token=model.add_budget_token, compute_dtype=compute_dtype,
            early_exits=bool(ee_outputs))
        if recon_outputs:
            self._forward.update(recon=True, decoder_num_heads=model.decoder_num_heads)
        self.params = prepare_engine_params(params, compute_dtype)
        self._compact_auto = compact is True
        self._compact_slack = float(compact_slack)
        self._compact_caps_by_budget: dict = {}  # compact=True: budget -> capacities
        self._compact_caps = (None if compact is None or self._compact_auto
                              else self._compact_caps_for(compact))

    def _quantize(self, params, calib_images, percentile, static_caps):
        """The int8 tree of ``params``, calibrated on ``calib_images`` when
        given (on the engine's device, in fp32); sets ``self.caps``. Static
        caps skip the per-row absmax but clip activations the calibration
        set never saw: opt-in, as in JAX."""
        module = self._module
        if calib_images is not None:
            if isinstance(calib_images, np.ndarray):
                calib_images = torch.from_numpy(calib_images)
            calib = calib_images.to(self.device, torch.float32)
            geom = dict(patch_size=module.patch_size, num_heads=module.num_heads,
                        num_class_tokens=module.num_class_tokens,
                        num_registers=module.num_registers)
            if self._residual:
                # the gated, masked forward's own statistics, on the raw
                # weights, then again on the smoothed ones for the caps
                geom.update(gate_temp=module.gate_temp, gate_bias=module.gate_bias,
                            budget_token=module.add_budget_token, percentile=percentile)
                _, smoothing = collect_residualvit_activation_stats(params, calib, **geom)
                params = smooth_vit_params(params, smoothing)
                if static_caps:
                    self.caps, _ = collect_residualvit_activation_stats(params, calib, **geom)
            else:
                geom["ln_eps"] = module.ln_eps
                params = smooth_vit_params(params,
                                           compute_smoothing_vectors(params, calib, **geom))
                if static_caps:
                    self.caps = collect_activation_caps(params, calib, percentile=percentile,
                                                        **geom)
        with torch.no_grad():
            return (quantize_residualvit_params if self._residual else quantize_vit_params)(
                params)

    def _compact_caps_for(self, capacity):
        """Per-layer image-token capacities for ``compact`` mode:
        ceil(capacity * N_img) rounded up to a multiple of 8, clamped to
        N_img. ``capacity`` is one fraction for every layer or a per-layer
        schedule (a layer whose capacity exceeds the current compacted
        width leaves it: the buffer never grows back). Returns None when
        every capacity covers every token: the exact masked path runs."""
        module = self._module
        n_img = (module.image_size // module.patch_size) ** 2

        def one(c):
            return min(n_img, max(8, -8 * (-math.ceil(float(c) * n_img) // 8)))

        if isinstance(capacity, (tuple, list)):
            if len(capacity) != module.num_layers:
                raise ValueError(f"compact= schedule has {len(capacity)} entries for a "
                                 f"{module.num_layers}-layer model")
            caps = tuple(one(c) for c in capacity)
            return None if all(c >= n_img for c in caps) else caps
        cap = one(capacity)
        return None if cap >= n_img else (cap,) * module.num_layers

    def compact_caps(self, budget: float = 1.0) -> Optional[tuple]:
        """The capacities a ``budget`` request runs with (None: exact path)."""
        if not self._compact_auto:
            return self._compact_caps
        if budget not in self._compact_caps_by_budget:
            self._compact_caps_by_budget[budget] = self._compact_caps_for(
                min(1.0, budget + self._compact_slack))
        return self._compact_caps_by_budget[budget]

    def __call__(self, images, budget: Optional[float] = None, noise_value=None,
                 noise_rng: Optional[torch.Generator] = None):
        """images: (B, H, W, 3), or point clouds (B, N, 3) for PCT and
        RankPCT, numpy array or tensor. Returns fp32 logits on the engine's
        device (for ``ee_outputs``, the tuple of exits and final logits;
        for ``recon_outputs``, the logits and the decoder's fp32 images).
        ``budget`` (ResidualViT, RankViT and a RankPCT with ranking on,
        default 1.0) is ignored by a plain ViT, by A-ViT, by MAE and by
        PCT, as in the JAX engine.

        A model built with a NoiseBlock (``noise_layer``) takes
        ``noise_value`` (snr in dB or drop probability; default the 0.0
        sentinel) and ``noise_rng`` (a ``torch.Generator`` on the engine's
        device; default one seeded 0, JAX's ``key(0)``), and injects the
        noise before block ``noise_layer`` as its module does. An engine
        without one raises on ``noise_value`` (JAX inference.py:2930-2934)."""
        noise = None
        if self._noise is not None:
            noise = NoiseSpec(self._noise[0], self._noise[1],
                              0.0 if noise_value is None else noise_value,
                              noise_rng if noise_rng is not None
                              else default_generator(self.device))
        elif noise_value is not None:
            raise ValueError("engine was built without a noise layer (build_model(noise_args=...) "
                             "or noise_layer=); noise_value= has no effect here")
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(self.device, torch.float32)
        with torch.inference_mode():
            if self._tp_make is not None:
                if self._residual:
                    b = 1.0 if budget is None else float(budget)
                    return self._tp_make(None)(self.params, images, b)
                b = None if not self._rank or budget is None else float(budget)
                return self._tp_make(b)(self.params, images)
            fwd, kw, operand = self._resolve(budget, noise)
            if self._dp is not None:
                from peekvit_torch.parallel.data import over_data

                fwd = over_data(self._dp, fwd)
            if operand is None:
                return fwd(self.params, images, **kw)
            return fwd(self.params, images, operand, **kw)

    def _resolve(self, budget: Optional[float], noise: Optional[NoiseSpec] = None) -> tuple:
        """What a call at ``budget`` runs: ``(forward, keywords, operand)``.
        The engine computes ``forward(params, images, **keywords)``, or
        ``forward(params, images, operand, **keywords)`` where the operand
        (the budget of a ResidualViT or of the padded RankViT) is not None.
        ``__call__`` and the serving bundles (``serving.py``) both resolve
        here, so a bundle runs what its engine runs. Not for a
        tensor-parallel engine."""
        if self._pct:
            if self._ranking is None:
                return pct_forward_fused, dict(self._forward), None
            b = (None if not any(self._ranking)
                 else 1.0 if budget is None else float(budget))
            return (rankpct_forward_fused, dict(self._forward, budget=b, ranking=self._ranking),
                    None)
        q = dict(caps=self.caps) if self._quantized else {}
        if self._rank:
            b = 1.0 if budget is None else float(budget)
            if self._max_budget is None:
                fwd = rankvit_forward_quant if self._quantized else rankvit_forward_fused
                return fwd, dict(self._forward, budget=b, noise=noise, **q), None
            if b > self._max_budget + 1e-9:
                raise ValueError(f"budget {b} exceeds the engine's static max_budget "
                                 f"{self._max_budget}")
            fwd = rankvit_forward_padded_quant if self._quantized else rankvit_forward_padded
            return fwd, dict(self._forward, max_budget=self._max_budget, noise=noise, **q), b
        if self._moe:
            fwd = moevit_forward_quant if self._quantized else moevit_forward_fused
            return fwd, dict(self._forward, noise=noise), None
        if self._avit:
            return adavit_forward_fused, dict(self._forward), None
        if self._mae:
            return maevit_forward_fused, dict(self._forward), None
        if not self._residual:
            fwd = vit_forward_quant if self._quantized else vit_forward_fused
            return fwd, dict(self._forward, noise=noise, **q), None
        b = 1.0 if budget is None else float(budget)
        if self._quantized:
            return residualvit_forward_quant, dict(self._forward, noise=noise, **q), b
        return (residualvit_forward_fused,
                dict(self._forward, noise=noise, compact_caps=self.compact_caps(b)), b)
