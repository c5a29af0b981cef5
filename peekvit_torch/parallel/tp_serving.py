"""Tensor-parallel serving of the plain ViT, RankViT and ResidualViT
engines over ``torch.distributed`` (counterpart of
peekvit_tpu/parallel/tp_serving.py).

One forward's work is split over the mesh's model axis the Megatron way:
each rank holds a head slice of every layer's attention and a column /
row slice of its MLP, runs the partial sublayers of
``ops/cuda/tp_blocks.py`` on the full token stream (which every rank of a
model row holds), and one all-reduce over the model row completes each
sublayer; bias and residual are added once, in fp32, after it. Embed,
gates, the RankViT drop and the classifier are cheap and run on every
rank, on bit-identical inputs: the all-reduced sums are the same on every
rank of a row, so every rank keeps the same tokens and computes the same
masks with no further collective. The data axis splits the batch: a rank
serves its data slice and the logits are all-gathered over its data
column, so every rank takes the whole batch and returns the whole
batch's logits, as JAX's global-in, global-out ``shard_map`` does.

Where JAX runs one program over a device mesh, each rank here is one
process (``parallel/mesh.py``). The caller builds the process group and
so picks the backend: NCCL across cards, or gloo, which also takes CUDA
tensors for ``all_reduce`` (several ranks may share one card that way).
The data axis's gather is ``parallel/data.over_data``'s all-reduce of a
zero-filled buffer, which gloo takes on the card too.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from peekvit_torch.inference import (
    _classify,
    _embed,
    _embed_posfolded,
    _layer_ids,
    _layer_norm,
    _top_by_norm,
    prepare_engine_params,
)
from peekvit_torch.models.adapters import module_params, tree_map
from peekvit_torch.models.rankvit import RankVisionTransformer
from peekvit_torch.models.residualvit import ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.ops.cuda.tp_blocks import (
    tp_attention_partial,
    tp_masked_attention_partial,
    tp_masked_mlp_partial,
    tp_mlp_partial,
)
from peekvit_torch.parallel.data import over_data
from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS


def _check_split(n_model: int, num_heads: int, mlp_dim: int) -> None:
    if n_model < 2:
        raise ValueError(f"tensor-parallel serving needs n_model >= 2 (got {n_model})")
    if num_heads % n_model:
        raise ValueError(f"num_heads={num_heads} must be divisible by the model-axis size "
                         f"{n_model} (head-sharded attention)")
    if mlp_dim % n_model:
        raise ValueError(f"mlp_dim={mlp_dim} must be divisible by the model-axis size "
                         f"{n_model} (column-parallel fc1)")


def _qkv_shards(w, n_model: int, d: int):
    """(S, rows, 3·dl): shard s's columns ``[q_s | k_s | v_s]`` of a packed
    (rows, 3D) qkv kernel or bias (head-major packing: a shard's heads are
    contiguous columns of each of q, k and v)."""
    dl = d // n_model
    return torch.stack([torch.cat([w[:, c * d + s * dl:c * d + (s + 1) * dl] for c in range(3)],
                                  dim=1) for s in range(n_model)])


def _append_shards(tp: dict, n_model: int, d: int, wqkv, bqkv, wo, w1, b1, w2) -> None:
    """One layer's Megatron slices, appended to ``tp``'s per-layer lists:
    column slices of qkv (head-grouped) and fc1, row slices of the
    out-projection and fc2, each (S, ...)."""
    tp["wqkv"].append(_qkv_shards(wqkv, n_model, d))
    tp["bqkv"].append(_qkv_shards(bqkv, n_model, d))
    tp["wo"].append(torch.stack(wo.chunk(n_model, dim=0)))
    tp["w1"].append(torch.stack(w1.chunk(n_model, dim=1)))
    tp["b1"].append(torch.stack(b1.chunk(n_model, dim=1)))
    tp["w2"].append(torch.stack(w2.chunk(n_model, dim=0)))


def _stack_shards(per_layer: dict) -> dict:
    """{name: [per-layer (S, ...)]} -> {name: (S, L, ...)}."""
    return {k: torch.stack(v, dim=1).contiguous() for k, v in per_layer.items()}


def prepare_tp_serving_params(params: dict, n_model: int, num_heads: int,
                              compute_dtype=torch.bfloat16) -> dict:
    """Slice a plain-ViT (or RankViT) param tree into Megatron serving
    shards, after the single-device preparation (``prepare_engine_params
    (fold_ln=True)``: the cast, (1, k) biases, LN folded into qkv / fc1,
    the pos-embedding folded into the embed constants).

    Returns ``{"shared": ..., "tp": ...}`` in the JAX tree's keys and
    layouts: ``tp`` holds ``wqkv`` (S, L, D, 3·dl), ``bqkv`` (S, L, 1, 3·dl),
    ``wo`` (S, L, dl, D), ``w1`` (S, L, D, M/S), ``b1`` (S, L, 1, M/S), ``w2``
    (S, L, M/S, D) with S = n_model shards; ``shared`` the embed constants,
    the final LN, the head and the out-projection / fc2 biases stacked
    (L, 1, D), added once after the all-reduce."""
    prep = prepare_engine_params(params, compute_dtype, fold_ln=True)
    enc = prep["encoder"]
    ids = _layer_ids(enc)
    d = prep["conv_proj"]["kernel"].shape[-1]
    _check_split(n_model, num_heads, enc[f"layers_{ids[0]}"]["mlp"]["fc2_kernel"].shape[0])
    tp = {k: [] for k in ("wqkv", "bqkv", "wo", "w1", "b1", "w2")}
    bo, b2 = [], []
    for i in ids:
        lp = enc[f"layers_{i}"]
        fq, f1 = lp["_folded_qkv"], lp["_folded_fc1"]
        at, mlp = lp["self_attention"], lp["mlp"]
        _append_shards(tp, n_model, d, fq["kernel"], fq["bias"], at["out_proj_kernel"],
                       f1["kernel"], f1["bias"], mlp["fc2_kernel"])
        bo.append(at["out_proj_bias"])
        b2.append(mlp["fc2_bias"])
    shared = {
        "conv_proj": prep["conv_proj"],
        "_embed_special": prep["_embed_special"],
        "_embed_img_bias": prep["_embed_img_bias"],
        "encoder": {"ln": enc["ln"]},
        "head": prep["head"],
        "bo": torch.stack(bo),
        "b2": torch.stack(b2),
    }
    return {"shared": shared, "tp": _stack_shards(tp)}


def prepare_tp_residual_serving_params(params: dict, n_model: int, num_heads: int,
                                       compute_dtype=torch.bfloat16,
                                       early_exits: bool = False) -> dict:
    """Slice a ResidualViT-family param tree into Megatron serving shards.
    The LN stays unfolded (the gate mask multiplies the affined LN output,
    which does not commute with a folded bias), as in the single-device
    masked engine.

    ``tp`` as :func:`prepare_tp_serving_params`, from the unfolded in_proj
    and fc1. ``shared``: the embed weights (conv, class tokens, registers,
    pos-embedding), per-layer LN affines ``ln1s``/``ln1b``/``ln2s``/``ln2b``
    (L, 1, D), the fp32 gate projections ``gk`` (L, D, 1) / ``gb`` (L, 1)
    (``bgk``/``bgb`` for a learnable budget token), ``bo``/``b2`` (L, 1, D),
    the learnable budget tokens, the final LN and head, and with
    ``early_exits`` the exit heads ``ee_lns``/``ee_lnb``/``ee_hk``/``ee_hb``."""
    prep = prepare_engine_params(params, compute_dtype)
    enc = prep["encoder"]
    ids = _layer_ids(enc)
    d = prep["conv_proj"]["kernel"].shape[-1]
    _check_split(n_model, num_heads, enc[f"layers_{ids[0]}"]["mlp"]["fc1_kernel"].shape[-1])
    tp = {k: [] for k in ("wqkv", "bqkv", "wo", "w1", "b1", "w2")}
    sh = {k: [] for k in ("ln1s", "ln1b", "ln2s", "ln2b", "gk", "gb", "bo", "b2")}
    has_btg = "budget_token_gate" in enc[f"layers_{ids[0]}"]
    if has_btg:
        sh["bgk"], sh["bgb"] = [], []
    if early_exits:
        sh.update({k: [] for k in ("ee_lns", "ee_lnb", "ee_hk", "ee_hb")})
    for i in ids:
        lp = enc[f"layers_{i}"]
        at, mlp = lp["self_attention"], lp["mlp"]
        _append_shards(tp, n_model, d, at["in_proj_kernel"], at["in_proj_bias"],
                       at["out_proj_kernel"], mlp["fc1_kernel"], mlp["fc1_bias"],
                       mlp["fc2_kernel"])
        gp = lp["residual_gate"]["projection"]
        leaves = {"ln1s": lp["ln_1"]["scale"], "ln1b": lp["ln_1"]["bias"],
                  "ln2s": lp["ln_2"]["scale"], "ln2b": lp["ln_2"]["bias"],
                  "gk": gp["kernel"], "gb": gp["bias"],
                  "bo": at["out_proj_bias"], "b2": mlp["fc2_bias"]}
        if has_btg:
            leaves.update(bgk=lp["budget_token_gate"]["kernel"],
                          bgb=lp["budget_token_gate"]["bias"])
        if early_exits:
            ln_p, hd_p = enc[f"early_exit_heads_{i}_ln"], enc[f"early_exit_heads_{i}_head"]
            leaves.update(ee_lns=ln_p["scale"], ee_lnb=ln_p["bias"], ee_hk=hd_p["kernel"],
                          ee_hb=hd_p["bias"])
        for k, v in leaves.items():
            sh[k].append(v)
    shared = {
        "conv_proj": prep["conv_proj"],
        "class_tokens": prep["class_tokens"],
        "encoder": {"ln": enc["ln"], "pos_embedding": enc["pos_embedding"]},
        "head": prep["head"],
    }
    for key in ("register_tokens", "learnable_budget_token_1", "learnable_budget_token_2"):
        if key in prep:
            shared[key] = prep[key]
    shared.update({k: torch.stack(v) for k, v in sh.items()})
    return {"shared": shared, "tp": _stack_shards(tp)}


def place_tp_serving_params(prepared: dict, mesh) -> dict:
    """This rank's part of a prepared tree, on the mesh's device: its model
    shard of every ``tp`` leaf ((L, ...): the leading shard axis taken at
    ``mesh.model_index``) and the whole ``shared`` tree."""
    dev = mesh.device
    return {"shared": tree_map(lambda t: t.to(dev), prepared["shared"]),
            "tp": {k: v[mesh.model_index].to(dev).contiguous()
                   for k, v in prepared["tp"].items()}}


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t


def make_tp_vit_forward(mesh, *, num_heads: int, patch_size: int, num_class_tokens: int = 1,
                        ln_eps: float = 1e-5, compute_dtype=torch.bfloat16, rank_layers=(),
                        budget: Optional[float] = None, kept_out: Optional[dict] = None):
    """The TP serving forward of a plain ViT: ``fn(placed, images)`` ->
    fp32 logits of the whole batch (placed: :func:`place_tp_serving_params`
    of :func:`prepare_tp_serving_params`). ``rank_layers`` and ``budget``
    add the RankViT exact drop: before each ranked layer the top
    ``ceil(float32(n_alive) * float32(budget))`` image tokens by fp32 norm
    are gathered (ties to the lower index, JAX ``top_k``'s order), on
    every rank alike; no drop at budget None or >= 1. ``kept_out``: if a
    dict is given, each ranked layer's (B, keep) gathered indices of this
    rank's data slice are stored in it under the layer position, as
    ``rankvit_forward_fused``'s ``kept_out``."""
    heads_local = num_heads // mesh.shape[MODEL_AXIS]
    group = mesh.model_group
    rank_layers = tuple(rank_layers or ())
    c = num_class_tokens

    def cast(t):
        return t.to(compute_dtype)

    def shard_fn(placed, images):
        shared, tp = placed["shared"], placed["tp"]
        tokens, d = _embed_posfolded(shared, images, patch_size, cast)
        for li in range(shared["bo"].shape[0]):
            if li in rank_layers and budget is not None and budget < 1.0:
                img = tokens[:, c:]
                keep = int(np.ceil(np.float32(img.shape[1]) * np.float32(budget)))
                idx = _top_by_norm(img, keep)
                if kept_out is not None:
                    kept_out[li] = idx
                img = torch.gather(img, 1, idx[..., None].expand(-1, -1, d))
                tokens = torch.cat([tokens[:, :c], img], dim=1)
            pa = _all_reduce(tp_attention_partial(tokens, tp["wqkv"][li], tp["bqkv"][li],
                                                  tp["wo"][li], heads_local, ln_eps), group)
            tokens = (tokens.float() + pa + shared["bo"][li].float()).to(compute_dtype)
            pm = _all_reduce(tp_mlp_partial(tokens, tp["w1"][li], tp["b1"][li], tp["w2"][li],
                                            ln_eps), group)
            tokens = (tokens.float() + pm + shared["b2"][li].float()).to(compute_dtype)
        return _classify(shared, tokens, c, cast, ln_eps)

    return over_data(mesh, shard_fn)


def make_tp_residual_forward(mesh, *, num_heads: int, patch_size: int,
                             num_class_tokens: int = 1, num_registers: int = 0,
                             gate_temp: float = 1.0, gate_bias: float = 0.0,
                             budget_token: Any = "learnable", compute_dtype=torch.bfloat16,
                             early_exits: bool = False):
    """The TP serving forward of a ResidualViT in the shipped-config mode
    (sigmoid gates, 'attention+mlp' skip, a budget token):
    ``fn(placed, images, budget)`` -> fp32 logits of the whole batch, or
    with ``early_exits`` the tuple (exit_0, ..., exit_{L-1}, final). The
    gates run in fp32 on every rank; the two sublayers are the masked
    partials, each completed by one all-reduce: ``(psum + bo) * mask + x``
    after attention, ``psum + b2 + x`` after the MLP (its output is not
    masked). The constant budget-token modes threshold by the mean budget
    token of the WHOLE batch (reference residualvit.py:208), so under a
    data axis the mean is all-reduced over the data column."""
    heads_local = num_heads // mesh.shape[MODEL_AXIS]
    group = mesh.model_group
    n_data = mesh.shape[DATA_AXIS]
    c = num_class_tokens
    s = c + num_registers
    f32 = torch.float32

    def cast(t):
        return t.to(compute_dtype)

    def shard_fn(placed, images, budget):
        shared, tp = placed["shared"], placed["tp"]
        tokens, d = _embed(shared, images, patch_size, c, num_registers, cast)
        b, dev = tokens.shape[0], tokens.device
        tokens = tokens + cast(shared["encoder"]["pos_embedding"])
        bcast = torch.full((b, 1, 1), float(budget), dtype=f32, device=dev).to(compute_dtype)
        if budget_token == "learnable":
            btok = cast(shared["learnable_budget_token_1"]) * bcast
        elif budget_token == "learnable_interpolate":
            btok = (cast(shared["learnable_budget_token_1"]) * bcast
                    + cast(shared["learnable_budget_token_2"]) * (1.0 - bcast))
        else:
            btok = bcast
        tokens = torch.cat([tokens, btok.expand(b, 1, d)], dim=1)
        ones = torch.ones((b, s, 1), dtype=f32, device=dev)
        exits = []
        for li in range(shared["bo"].shape[0]):
            # ---- the gate, fp32, identical on every rank of the row
            img = tokens[:, s:-1]
            sig = torch.sigmoid((img.float() @ shared["gk"][li].float()
                                 + shared["gb"][li].float()) / gate_temp + gate_bias)
            if budget_token == "learnable":
                thr = torch.sigmoid(tokens[:, -1:].float() @ shared["bgk"][li].float()
                                    + shared["bgb"][li].float())
                mask = torch.relu(sig - thr)
            else:
                cur_b = tokens[:, -1:].float().mean().reshape(1)
                if n_data > 1:
                    cur_b = _all_reduce(cur_b, mesh.data_group) / n_data
                mask = torch.relu(sig - (1.0 - cur_b))
            fwd_mask = torch.cat([ones, mask, ones[:, :1]], dim=1)  # fp32
            fwd_c = fwd_mask.to(compute_dtype)
            tokens = torch.cat([tokens[:, :s], mask.to(compute_dtype) * img, tokens[:, -1:]],
                               dim=1)
            pa = _all_reduce(tp_masked_attention_partial(
                tokens, fwd_c, cast(shared["ln1s"][li]), cast(shared["ln1b"][li]),
                tp["wqkv"][li], tp["bqkv"][li], tp["wo"][li], heads_local, 1e-6), group)
            tokens = ((pa + shared["bo"][li].float()) * fwd_mask + tokens.float()).to(
                compute_dtype)
            pm = _all_reduce(tp_masked_mlp_partial(
                tokens, fwd_c, cast(shared["ln2s"][li]), cast(shared["ln2b"][li]),
                tp["w1"][li], tp["b1"][li], tp["w2"][li], 1e-6), group)
            tokens = (pm + shared["b2"][li].float() + tokens.float()).to(compute_dtype)
            if early_exits:
                cls = _layer_norm(tokens[:, :c], cast(shared["ee_lns"][li]),
                                  cast(shared["ee_lnb"][li]), 1e-5)[:, 0]
                exits.append((cls @ cast(shared["ee_hk"][li])
                              + cast(shared["ee_hb"][li][0])).float())
        final = _classify(shared, tokens, c, cast, 1e-5)
        return tuple(exits) + (final,) if early_exits else final

    return over_data(mesh, shard_fn)


def tp_serving_engine(model, mesh, *, compute_dtype=torch.bfloat16, ee_outputs: bool = False):
    """(placed params, make_fn) for TP serving of a built model on this
    rank: a plain ViT, a RankViT (exact drop) or a ResidualViT-family model
    in its shipped-config mode (early exits included). ``make_fn(budget)``
    returns the forward: a plain ViT's and RankViT's ``fn(placed, images)``
    (RankViT: one per budget), a ResidualViT's ``fn(placed, images,
    budget)`` for any budget. Used by ``InferenceEngine`` when its mesh has
    a model axis > 1; exposed for direct use."""
    residual = isinstance(model, ResidualVisionTransformer)
    rank = isinstance(model, RankVisionTransformer)
    if not (residual or rank or type(model) is VisionTransformer):
        raise NotImplementedError(
            "tensor-parallel serving covers the plain / Rank VisionTransformer and the "
            f"ResidualViT family; {type(model).__name__} has no partial kernels")
    n_model = mesh.shape[MODEL_AXIS]
    params = tree_map(lambda t: t.to(mesh.device), module_params(model))
    if residual:
        layers = model.residual_layers or ["attention+mlp"] * model.num_layers
        if (set(layers) != {"attention+mlp"} or model.gate_type != "sigmoid"
                or model.add_input or not model.add_budget_token):
            raise NotImplementedError(
                "TP ResidualViT serving supports the shipped-config mode (sigmoid gates, "
                "attention+mlp skip, budget token, add_input=False), as the single-device "
                "engine")
        placed = place_tp_serving_params(prepare_tp_residual_serving_params(
            params, n_model, model.num_heads, compute_dtype, early_exits=ee_outputs), mesh)
        fwd = make_tp_residual_forward(
            mesh, num_heads=model.num_heads, patch_size=model.patch_size,
            num_class_tokens=model.num_class_tokens, num_registers=model.num_registers,
            gate_temp=model.gate_temp, gate_bias=model.gate_bias,
            budget_token=model.add_budget_token, compute_dtype=compute_dtype,
            early_exits=ee_outputs)
        return placed, lambda budget: fwd
    placed = place_tp_serving_params(
        prepare_tp_serving_params(params, n_model, model.num_heads, compute_dtype), mesh)
    rank_layers = tuple(getattr(model, "rankvit_layers", ()) or ())

    def make_fn(budget: Optional[float]):
        return make_tp_vit_forward(
            mesh, num_heads=model.num_heads, patch_size=model.patch_size,
            num_class_tokens=model.num_class_tokens, ln_eps=model.ln_eps,
            compute_dtype=compute_dtype, rank_layers=rank_layers, budget=budget)

    return placed, make_fn
