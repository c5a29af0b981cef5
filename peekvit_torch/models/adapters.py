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
"""

from __future__ import annotations

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
