"""Weights between the JAX package's param tree and the port's modules
(counterpart of peekvit_tpu/models/adapters.py).

The port's modules keep the JAX names and layouts, so a JAX tree path
joined by dots is a state_dict key and no array needs a transpose: the
(P*P*C, D) patch kernel, the (in, out) dense kernels and the packed
(D, 3D) qkv kernel cross as they are. Arrays are numpy on both sides.

A model with BatchNorm (PCT, RankPCT) also carries JAX's ``batch_stats``
collection: the running ``mean`` / ``var`` of each BatchNorm are the
module's buffers, beside its ``scale`` / ``bias`` parameters, under the
same paths.

Pretrained weights (JAX adapters.py:25-301): torchvision- and
timm-grammar ViT state dicts are renamed into the reference's torch
grammar (``adapt_torch_key`` / ``adapt_timm_key``), then mapped onto the
JAX tree's paths and layouts (``convert_torch_state_dict``: the OIHW
patch conv flattened to (P*P*C, D), every dense kernel transposed to
(in, out); a head of another class count is zeroed), then merged into a
model leaf by leaf where path and shape match (``transfer_params``, the
``load_state_dict(strict=False)`` of the reference). Only local ``.pth``
files load: a hub name raises.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree: dict, prefix: str = "", sep: str = ".") -> dict:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + sep, sep))
        else:
            flat[path] = value
    return flat


def _nest(items) -> dict:
    """(dotted key, leaf) pairs -> a nested dict."""
    tree: dict = {}
    for key, value in items:
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def module_params(model: nn.Module) -> dict:
    """The module's weights as a nested dict in the JAX tree's grammar, of
    detached tensors on the module's device."""
    return _nest((key, value.detach()) for key, value in model.state_dict().items())


def live_params(model: nn.Module) -> dict:
    """The module's parameters as a nested dict in the JAX tree's grammar,
    live: the leaves are the module's own ``nn.Parameter``s, not detached
    copies, so gradients taken through the tree reach the model (what a
    train step needs; :func:`module_params` is for read-only use)."""
    return _nest(model.named_parameters())


def tree_leaves(tree: dict) -> list:
    """(path, leaf) pairs of a nested dict, paths joined by "/" (the JAX
    package's parameter names)."""
    return list(_flatten(tree, sep="/").items())


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def module_state(model: nn.Module) -> tuple[dict, dict]:
    """(params, batch_stats): the module's parameters and its buffers (the
    BatchNorm running statistics; empty for a model without) as two nested
    dicts of detached tensors in the JAX tree's grammar."""
    buffers = {key for key, _ in model.named_buffers()}
    items = model.state_dict().items()
    return (_nest((k, v.detach()) for k, v in items if k not in buffers),
            _nest((k, v.detach()) for k, v in items if k in buffers))


def params_from_jax(model: nn.Module, tree: dict, batch_stats: dict | None = None) -> nn.Module:
    """Load a JAX param tree (nested dicts of numpy arrays, or anything
    ``np.asarray`` takes), and for a model with BatchNorm its
    ``batch_stats`` collection, into ``model`` in place. Strict: every key
    of the two trees together must match the model's and every shape
    agree. Returns the model."""
    flat = _flatten(tree)
    stats = _flatten(batch_stats or {})
    if set(flat) & set(stats):
        raise KeyError(f"keys in both params and batch_stats: {sorted(set(flat) & set(stats))}")
    flat.update(stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(f"param tree does not match the model: missing {missing}, "
                       f"unexpected {unexpected}")
    loaded = {}
    for key, value in flat.items():
        arr = np.asarray(value, dtype=np.float32)
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"{key}: shape {arr.shape} != model {tuple(own[key].shape)}")
        loaded[key] = torch.tensor(arr)
    model.load_state_dict(loaded)
    return model


def params_to_jax(model: nn.Module):
    """The inverse of :func:`params_from_jax`: the model's weights as a
    nested dict of fp32 numpy arrays in the JAX tree's grammar; for a
    model with BatchNorm the pair (params, batch_stats)."""
    params, stats = (tree_map(lambda t: t.float().cpu().numpy(), tree)
                     for tree in module_state(model))
    return (params, stats) if stats else params


def load_tree(model: nn.Module, tree: dict) -> nn.Module:
    """Load a nested dict holding every leaf of the model (numpy arrays or
    tensors; ``transfer_params``'s merged tree) into ``model`` in place,
    each leaf cast to the model's dtype. Returns the model."""
    own = model.state_dict()
    loaded = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
              .to(own[k].dtype) for k, v in _flatten(tree).items()}
    model.load_state_dict(loaded)
    return model


# --------------------------------------------------------------- key renamers


def adapt_torch_key(p: str) -> str:
    """torchvision ViT key -> the reference's torch key (JAX adapters.py:31)."""
    p = (p.replace("mlp.0", "mlp.fc1").replace("mlp.3", "mlp.fc2")
         .replace("heads.head", "head").replace("mlp.linear_1", "mlp.fc1")
         .replace("mlp.linear_2", "mlp.fc2"))
    if p.count("self_attention") == 1:
        p = p.replace("self_attention", "self_attention.self_attention")
    if p == "class_token":
        return "class_tokens"
    return re.sub(r"encoder_layer_(\d+)", r"\1", p)


def adapt_timm_key(p: str) -> str:
    """timm ViT key -> the reference's torch key (JAX adapters.py:48)."""
    p = p.replace("norm1", "ln_1").replace("norm2", "ln_2")
    p = p.replace("attn.qkv.bias", "self_attention.self_attention.in_proj_bias")
    p = p.replace("attn.qkv.weight", "self_attention.self_attention.in_proj_weight")
    p = p.replace("attn.proj.bias", "self_attention.self_attention.out_proj.bias")
    p = p.replace("attn.proj.weight", "self_attention.self_attention.out_proj.weight")
    p = p.replace("patch_embed.proj.bias", "conv_proj.bias")
    p = p.replace("patch_embed.proj.weight", "conv_proj.weight")
    p = p.replace("cls_token", "class_tokens")
    p = p.replace("pos_embed", "encoder.pos_embedding")
    p = p.replace("norm.weight", "encoder.ln.weight")
    p = p.replace("norm.bias", "encoder.ln.bias")
    return re.sub(r"blocks\.(\d+)", r"encoder.layers.\1", p)


def _torch_key_to_path_and_transform(key: str, arr: np.ndarray):
    """A reference-grammar torch key -> (the JAX tree path, the array in
    its layout) (JAX adapters.py:68)."""
    parts = key.split(".")
    # encoder.layers.N -> encoder/layers_N
    out: list[str] = []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    # the reference nests SelfAttention.self_attention (nn.MultiheadAttention);
    # the tree holds the projections on SelfAttention itself
    parts = [p for j, p in enumerate(out)
             if not (p == "self_attention" and j + 1 < len(out)
                     and out[j + 1] == "self_attention")]
    leaf, prefix = parts[-1], tuple(parts[:-1])

    if parts[0] == "conv_proj":  # OIHW (D, C, P, P) -> (P*P*C, D)
        if leaf == "weight":
            d, c, p, _ = arr.shape
            return ("conv_proj", "kernel"), arr.transpose(2, 3, 1, 0).reshape(p * p * c, d)
        return ("conv_proj", "bias"), arr
    if leaf in ("class_tokens", "register_tokens", "pos_embedding",
                "learnable_budget_token_1", "learnable_budget_token_2",
                "mask_token", "threshold"):
        return tuple(parts), arr
    if len(parts) >= 2 and parts[-2].startswith("ln"):  # LayerNorm: weight -> scale
        return prefix + ("scale" if leaf == "weight" else "bias",), arr
    if leaf == "in_proj_weight":
        return prefix + ("in_proj_kernel",), arr.T
    if leaf == "in_proj_bias":
        return prefix + ("in_proj_bias",), arr
    if len(parts) >= 2 and parts[-2] == "out_proj":
        if leaf == "weight":
            return prefix[:-1] + ("out_proj_kernel",), arr.T
        return prefix[:-1] + ("out_proj_bias",), arr
    if len(parts) >= 2 and parts[-2] in ("fc1", "fc2"):  # flattened fc1_kernel names
        fc = parts[-2]
        if leaf == "weight":
            return prefix[:-1] + (f"{fc}_kernel",), arr.T
        return prefix[:-1] + (f"{fc}_bias",), arr
    if leaf == "weight":  # the head, gate projections, exit heads
        if arr.ndim == 2:
            return prefix + ("kernel",), arr.T
        return prefix + ("weight",), arr
    return tuple(parts), arr


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def convert_torch_state_dict(state_dict: dict, num_classes: Optional[int] = None) -> dict:
    """A reference-grammar torch state dict -> a nested dict of numpy arrays
    in the JAX tree's grammar (JAX adapters.py:152). Where ``num_classes``
    differs from the checkpoint's head, the head is zeros."""
    sd = {k: _to_numpy(v) for k, v in state_dict.items()}
    if num_classes is not None and "head.weight" in sd:
        old = sd["head.weight"].shape
        if old[0] != num_classes:
            sd["head.weight"] = np.zeros((num_classes, old[1]), dtype=np.float32)
            sd["head.bias"] = np.zeros((num_classes,), dtype=np.float32)
    tree: dict = {}
    for key, arr in sd.items():
        path, value = _torch_key_to_path_and_transform(key, arr)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree


def transfer_params(src, dst):
    """Copy every ``src`` leaf whose path and shape ``dst`` has (JAX
    adapters.py:191). Returns (merged tree, missing paths, loaded paths),
    paths joined by "/"."""
    missing, loaded = [], []

    def rec(s, d, path):
        if not isinstance(d, dict):
            if s is not None and tuple(getattr(s, "shape", ())) == tuple(d.shape):
                loaded.append("/".join(path))
                return s
            missing.append("/".join(path))
            return d
        return {k: rec(s.get(k) if isinstance(s, dict) else None, dv, path + [k])
                for k, dv in d.items()}

    return rec(src, dst, []), missing, loaded


def adapt_torch_state_dict(torch_state_dict: dict, num_classes: int) -> dict:
    """torchvision grammar -> the JAX tree (JAX adapters.py:217)."""
    return convert_torch_state_dict({adapt_torch_key(k): v for k, v in torch_state_dict.items()},
                                    num_classes=num_classes)


def adapt_timm_state_dict(timm_state_dict: dict, num_classes: int) -> dict:
    """timm grammar -> the JAX tree (JAX adapters.py:223)."""
    return convert_torch_state_dict({adapt_timm_key(k): v for k, v in timm_state_dict.items()},
                                    num_classes=num_classes)


def load_pretrained(model: nn.Module, torch_pretrained_weights=None,
                    timm_pretrained_weights=None) -> nn.Module:
    """Merge a local torchvision (``torch_pretrained_weights``) or timm
    ``.pth`` into a built model, non-strict (JAX adapters.py:232): the
    leaves the file lacks keep their values, and are printed. A name that
    is not a local file (a hub entry) raises: nothing is downloaded."""
    assert not (torch_pretrained_weights and timm_pretrained_weights), (
        "You cannot load weights from both torch and timm at the same time.")
    spec = torch_pretrained_weights or timm_pretrained_weights
    if not os.path.exists(str(spec)):
        raise FileNotFoundError(
            f"Pretrained weights {spec!r} is not a local file. Hub downloads are "
            "unavailable (no network egress); place the .pth locally.")
    sd = torch.load(spec, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    adapt = adapt_torch_state_dict if torch_pretrained_weights else adapt_timm_state_dict
    src = adapt(sd, num_classes=model.num_classes)
    merged, missing, _ = transfer_params(src, module_params(model))
    if missing:
        print("Some parameters are not present in the checkpoint and keep their init "
              "values:", missing[:10], "..." if len(missing) > 10 else "")
    return load_tree(model, merged)


def from_vit_to_residual_vit(vit_checkpoint: str, model_args: Optional[dict] = None,
                             device="cuda") -> nn.Module:
    """A ResidualViT initialised from a plain-ViT checkpoint (JAX
    adapters.py:274): the leaves both share, the rest as built."""
    from peekvit_torch.models.registry import build_model
    from peekvit_torch.utils.checkpoint import load_state

    src = load_state(vit_checkpoint, device=device)
    res = build_model("residualvit", model_args if model_args is not None
                      else dict(src.model_args), device=device)
    merged, missing, _ = transfer_params(module_params(src), module_params(res))
    if missing:
        print("Randomly initialized (not in ViT checkpoint):", missing)
    return load_tree(res, merged)


def from_vit_to_eeresidual_vit(vit_checkpoint: str, residual_vit_args: dict,
                               device="cuda") -> tuple:
    """An early-exit ResidualViT from a plain-ViT checkpoint and its
    arguments (JAX adapters.py:289)."""
    from peekvit_torch.models.registry import build_model
    from peekvit_torch.utils.checkpoint import load_state

    src = load_state(vit_checkpoint, device=device)
    args = {**src.model_args, **residual_vit_args}
    res = build_model("eeresidualvit", args, device=device)
    merged, missing, _ = transfer_params(module_params(src), module_params(res))
    if missing:
        print("Randomly initialized (not in ViT checkpoint):", missing)
    return load_tree(res, merged), args
