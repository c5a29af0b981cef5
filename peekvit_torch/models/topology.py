"""Model surgery (counterpart of peekvit_tpu/models/topology.py).

Surgery rebuilds the model with ``build_model`` from its recorded
``model_class`` / ``model_args`` / ``noise_args`` at the new geometry and
moves the old weights across by path, as the JAX package re-keys its
tree. Freezing is a mask over the parameter tree (the optimizer's
``param_mask``), as JAX's optax mask.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from peekvit_torch.models.adapters import load_tree, module_params, transfer_params

# per-layer configuration lists that shrink with the layer stack
_PER_LAYER = ("residual_layers", "rankvit_layers", "mlp_moes", "attn_moes")


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _rebuild(model: nn.Module, **changes) -> nn.Module:
    """The model rebuilt with ``changes`` to its constructor arguments
    (weights freshly drawn); ``model_args`` records the changes it held,
    and ``num_layers`` / ``num_registers``, as JAX's ``_rebuild``."""
    from peekvit_torch.models.registry import build_model

    args = dict(model.model_args)
    recorded = {k: v for k, v in changes.items()
                if k in args or k in ("num_layers", "num_registers")}
    out = build_model(model.model_class, {**args, **changes}, model.noise_args,
                      device=_device(model))
    out.model_args = {**args, **recorded}
    return out


def remove_layers_and_stitch(model: nn.Module, layers_to_remove: List[int]) -> nn.Module:
    """The model without the encoder blocks ``layers_to_remove``, the rest
    renumbered (JAX topology.py:29): ``residual_layers``, ``mlp_moes`` and
    ``attn_moes`` keep the kept layers' entries, ``rankvit_layers`` the
    kept ranked layers at their new indices."""
    drop = set(layers_to_remove)
    keep = [i for i in range(model.num_layers) if i not in drop]
    changes = {"num_layers": len(keep)}
    for attr in _PER_LAYER:
        val = getattr(model, attr, None)
        if isinstance(val, (list, tuple)):
            changes[attr] = ([keep.index(i) for i in val if i in keep]
                             if attr == "rankvit_layers" else [val[i] for i in keep])
    out = _rebuild(model, **changes)
    old = module_params(model)
    enc = {k: v for k, v in old["encoder"].items() if not k.startswith("layers_")}
    for new_i, old_i in enumerate(keep):
        enc[f"layers_{new_i}"] = old["encoder"][f"layers_{old_i}"]
    return load_tree(out, {**old, "encoder": enc})


def reinit_class_tokens(model: nn.Module, seed: int = 0) -> nn.Module:
    """Every parameter whose path holds 'class' redrawn from normal(0, 0.02)
    by a ``torch.Generator`` seeded ``seed``, in place (JAX
    topology.py:54)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if any("class" in part for part in name.split(".")):
                p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype) * 0.02)
    return model


def _tree(params) -> dict:
    return module_params(params) if isinstance(params, nn.Module) else params


def _mask(params, keep) -> dict:
    def rec(tree, path):
        if not isinstance(tree, dict):
            return keep(".".join(path))
        return {k: rec(v, path + [k]) for k, v in tree.items()}

    return rec(_tree(params), [])


def trainable_mask(params, params_list: List[str]) -> dict:
    """A tree of bools over a model's (or a tree's) parameters: True where
    the dotted path holds any of the substrings (JAX topology.py:73)."""
    return _mask(params, lambda name: any(s in name for s in params_list))


def train_only_these_params(params, params_list: List[str], verbose: bool = False):
    """(mask, trainable paths, frozen paths) (JAX topology.py:89)."""
    mask = trainable_mask(params, params_list)
    trainable, frozen = [], []

    def rec(m, path):
        if not isinstance(m, dict):
            (trainable if m else frozen).append(".".join(path))
            return
        for k, v in m.items():
            rec(v, path + [k])

    rec(mask, [])
    if verbose:
        print("Trainable parameters:", trainable)
        print("Frozen parameters:", frozen)
    return mask, trainable, frozen


def freeze_module(params, module_path: str) -> dict:
    """A mask that freezes everything under ``module_path`` (JAX
    topology.py:108)."""
    return _mask(params, lambda name: not name.startswith(module_path))


def add_register_tokens(model: nn.Module, num_registers: int, seed: int = 0) -> nn.Module:
    """A built ViT with ``num_registers`` register tokens (JAX
    topology.py:119): zero tokens, and ``pos_embedding`` extended by
    normal(0, 0.02) rows for their positions, between the class tokens and
    the patches."""
    out = _rebuild(model, num_registers=num_registers)
    params = module_params(model)
    pos = params["encoder"]["pos_embedding"]
    c = model.num_class_tokens
    gen = torch.Generator().manual_seed(seed)
    extra = (torch.randn((1, num_registers, model.hidden_dim), generator=gen) * 0.02).to(pos)
    params["register_tokens"] = torch.zeros((1, num_registers, model.hidden_dim)).to(pos)
    params["encoder"] = {**params["encoder"],
                         "pos_embedding": torch.cat([pos[:, :c], extra, pos[:, c:]], dim=1)}
    return load_tree(out, params)


def add_residual_gates(model: nn.Module, residual_gates_args: dict) -> nn.Module:
    """A plain ViT rebuilt as a ResidualViT with gates, the shared weights
    moved across (JAX topology.py:143)."""
    from peekvit_torch.models.registry import build_model

    args = dict(model.model_args)
    args.update({k: residual_gates_args[k]
                 for k in ("residual_layers", "gate_type", "add_input", "gate_temp")})
    res = build_model("residualvit", args, model.noise_args, device=_device(model))
    merged, missing, _ = transfer_params(module_params(model), module_params(res))
    if missing:
        print("Gate params randomly initialized:", missing[:8])
    return load_tree(res, merged)

