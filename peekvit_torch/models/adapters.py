"""Weights between the JAX package's param tree and the port's modules
(counterpart of peekvit_tpu/models/adapters.py).

The port's modules keep the JAX names and layouts, so a JAX tree path
joined by dots is a state_dict key and no array needs a transpose: the
(P*P*C, D) patch kernel, the (in, out) dense kernels and the packed
(D, 3D) qkv kernel cross as they are. Arrays are numpy on both sides.
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


def params_from_jax(model: nn.Module, tree: dict) -> nn.Module:
    """Load a JAX param tree (nested dicts of numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place. Strict: every key must
    match and every shape agree. Returns the model."""
    flat = _flatten(tree)
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


def params_to_jax(model: nn.Module) -> dict:
    """The inverse of :func:`params_from_jax`: the model's weights as a
    nested dict of fp32 numpy arrays in the JAX tree's grammar."""
    return tree_map(lambda t: t.float().cpu().numpy(), module_params(model))
