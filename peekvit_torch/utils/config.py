"""YAML configs (counterpart of peekvit_tpu/utils/config.py).

The same contract as the JAX package's, so the files under ``configs/``
drive the port unchanged:

- ``load_config(config_dir, config_name, overrides)``: the ``defaults``
  list (``- group: option``, ``- group: null``, ``- _self_``), group
  overrides ``group=option`` / ``group=null``, value overrides
  ``a.b.c=value`` (YAML-parsed), additions ``+a.b=v`` and deletions
  ``~a.b``;
- ``${a.b.c}`` interpolation (typed when the whole value is one) and
  ``${now:%F-%T}`` / ``${env:NAME}``;
- ``instantiate(node, **kw)`` for ``_target_`` nodes and
  ``save_config``.

``_target_`` strings: the configs name ``torch.optim.Adam`` and
friends for the optimizer, scheduler and loss, and ``peekvit.*`` for
the rest. :data:`TARGET_ALIASES` maps the former onto the port's specs
(``training.optim``) *before* anything is imported: the real
``torch.optim.Adam`` cannot be built without its parameters.
``peekvit.*`` maps to ``peekvit_torch.*``.
"""

from __future__ import annotations

import copy
import importlib
import os
import re
import time
from typing import Any, Dict, Iterable, Optional

import yaml


class ConfigNode(dict):
    """dict with attribute access; missing keys raise AttributeError."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(obj):
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


def to_plain(obj):
    """Nested ConfigNodes as plain dicts and lists."""
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    return obj


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


# ------------------------------------------------------------- interpolation

_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: dict, dotted: str):
    cur: Any = root
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list):
            cur = cur[int(part)]
        else:
            raise KeyError(f"Interpolation key '{dotted}' not found")
    return cur


def _resolve_expr(root: dict, expr: str):
    expr = expr.strip()
    if expr.startswith("now:"):
        return time.strftime(expr[4:] or "%Y-%m-%d-%H-%M-%S")
    if expr == "now":
        return time.strftime("%Y-%m-%d-%H-%M-%S")
    if expr.startswith("env:"):
        return os.environ.get(expr[4:], "")
    return _lookup(root, expr)


def _resolve_value(root: dict, value):
    if not isinstance(value, str):
        return value
    m = _INTERP.fullmatch(value)
    if m:  # a whole-string interpolation keeps the referenced type
        return _resolve_value(root, _resolve_expr(root, m.group(1)))

    def sub(match):
        out = _resolve_value(root, _resolve_expr(root, match.group(1)))
        return "" if out is None else str(out)

    out = _INTERP.sub(sub, value)
    # a substitution may itself hold ${...} (chained references)
    return _resolve_value(root, out) if _INTERP.search(out) else out


def resolve(cfg: dict) -> ConfigNode:
    """A copy of cfg with every ``${...}`` interpolation resolved."""

    def walk(node):
        if isinstance(node, dict):
            return ConfigNode({k: walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _resolve_value(cfg, node)

    return walk(cfg)


# ---------------------------------------------------------------- overrides


def _parse_value(text: str):
    if text == "":
        return ""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: dict, dotted: str, value):
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        nxt = cur.get(p) if isinstance(cur, dict) else None
        if not isinstance(nxt, dict):
            nxt = ConfigNode()
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _del_dotted(cfg: dict, dotted: str):
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.get(p, {})
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)


# ------------------------------------------------------------------ loading


def _load_yaml(path: str):
    """A dict, or None for a literal-null file (noise/no_noise.yaml)."""
    with open(path) as f:
        data = yaml.safe_load(f)
    return data if isinstance(data, dict) or data is None else {}


def _group_file(config_dir: str, group: str, option: str) -> str:
    path = os.path.join(config_dir, group, f"{option}.yaml")
    if not os.path.exists(path):
        group_dir = os.path.join(config_dir, group)
        avail = sorted(p[:-5] for p in os.listdir(group_dir)
                       if p.endswith(".yaml")) if os.path.isdir(group_dir) else []
        raise FileNotFoundError(
            f"Config group '{group}' has no option '{option}'. Available: {avail}")
    return path


def load_config(config_dir: str, config_name: str = "train_config",
                overrides: Iterable[str] = (),
                resolve_interpolations: bool = True) -> ConfigNode:
    """``{config_dir}/{config_name}.yaml`` with its defaults and the
    overrides, in hydra's order: the defaults list in order, ``_self_``
    where the primary config's own keys merge, then the overrides."""
    primary = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml")) or {}
    defaults = primary.pop("defaults", None) or []

    group_sel: Dict[str, Optional[str]] = {}
    order = []
    for entry in defaults:
        if entry == "_self_":
            order.append("_self_")
        elif isinstance(entry, dict):
            (group, option), = entry.items()
            group_sel[str(group)] = option
            order.append(str(group))
    if "_self_" not in order:
        order.append("_self_")

    value_overrides, deletions = [], []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            deletions.append(ov[1:])
            continue
        if ov.startswith("+"):
            ov = ov[1:]
        if "=" not in ov:
            raise ValueError(f"Override {ov!r} must be key=value")
        key, text = ov.split("=", 1)
        value = _parse_value(text)
        # a group override: a top-level key naming a config-group directory
        if "." not in key and (key in group_sel or (
                os.path.isdir(os.path.join(config_dir, key)) and isinstance(value, str))):
            group_sel[key] = value
            if key not in order:
                order.insert(max(0, len(order) - 1), key)
        else:
            value_overrides.append((key, value))

    cfg: dict = ConfigNode()
    for item in order:
        if item == "_self_":
            _deep_merge(cfg, _wrap(primary))
            continue
        option = group_sel.get(item)
        cfg[item] = (None if option is None
                     else _wrap(_load_yaml(_group_file(config_dir, item, str(option)))))

    for key, value in value_overrides:
        _set_dotted(cfg, key, _wrap(value))
    for key in deletions:
        _del_dotted(cfg, key)

    return resolve(cfg) if resolve_interpolations else _wrap(cfg)


def save_config(cfg: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(to_plain(cfg), f, sort_keys=False)


# -------------------------------------------------------------- instantiate

# the torch names the configs give the optimizer, scheduler and losses,
# onto the port's specs (the JAX table, pointed at peekvit_torch)
TARGET_ALIASES = {
    "torch.optim.Adam": "peekvit_torch.training.optim.Adam",
    "torch.optim.AdamW": "peekvit_torch.training.optim.AdamW",
    "torch.optim.SGD": "peekvit_torch.training.optim.SGD",
    "torch.optim.lr_scheduler.CosineAnnealingLR":
        "peekvit_torch.training.optim.CosineAnnealingLR",
    "torch.nn.CrossEntropyLoss": "peekvit_torch.training.optim.CrossEntropyLoss",
    "torch.nn.MSELoss": "peekvit_torch.training.optim.MSELossMain",
}


def resolve_target(target: str):
    """The object a ``_target_`` names: the alias table first, then
    ``peekvit.*`` as ``peekvit_torch.*``."""
    target = TARGET_ALIASES.get(target, target)
    if target.startswith("peekvit."):
        target = "peekvit_torch." + target[len("peekvit."):]
    module_path, _, name = target.rpartition(".")
    return getattr(importlib.import_module(module_path), name)


def instantiate(node, /, **kwargs):
    """hydra.utils.instantiate for a ``_target_`` node (not recursive)."""
    if node is None:
        return None
    node = dict(node)
    target = node.pop("_target_")
    node.update(kwargs)
    return resolve_target(target)(**{k: to_plain(v) for k, v in node.items()})
