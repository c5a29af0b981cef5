"""Self-describing checkpoints (counterpart of
peekvit_tpu/utils/checkpoint.py). Layout::

    {experiment_dir}/checkpoints/epoch_{e:03d}/
        metadata.json   # model_class, model_args, noise_args, epoch (+ extras)
        params.pt       # the module's state_dict (JAX tree paths joined by ".")
        opt_state.pt    # optional: the torch optimizer's state_dict

Both ``.pt`` files are written by ``torch.save`` to a temporary name and
committed with ``os.replace``, the optimizer's first: a checkpoint is
visible (``get_checkpoint_path``) only once its ``params.pt`` is.

``save_state(async_save=True)`` copies every tensor to host memory before
it returns and writes the copy from a background thread, so the
optimizer's in-place updates of the next steps cannot reach the file.
The JAX package's orbax checkpoints (a ``params/`` directory) are
refused: the port does not read orbax.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import torch
from torch import nn

ORBAX_MESSAGE = ("is an orbax checkpoint of the JAX package (a params/ directory); the "
                 "port does not read orbax. Export the tree with numpy and load it with "
                 "peekvit_torch.models.adapters.params_from_jax")

_pending: Optional[threading.Thread] = None
_pending_error: list = []


def make_experiment_directory(base: str) -> tuple[str, str]:
    """Create {base}/checkpoints and {base}/images; return both."""
    ckpt = os.path.join(base, "checkpoints")
    images = os.path.join(base, "images")
    os.makedirs(ckpt, exist_ok=True)
    os.makedirs(images, exist_ok=True)
    return ckpt, images


def wait_for_checkpoints() -> None:
    """Block until the save in flight, if any, has committed; raise its
    error if it failed."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def _host_copy(obj):
    """``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_copy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _commit(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def model_metadata(model: nn.Module) -> dict:
    """What ``build_model`` recorded on the module: enough to rebuild it."""
    try:
        return {"model_class": model.model_class, "model_args": model.model_args,
                "noise_args": model.noise_args}
    except AttributeError as e:
        raise ValueError("the model carries no model_class / model_args / noise_args: "
                         "build it with peekvit_torch.build_model") from e


def save_state(checkpoints_dir: str, model: nn.Module, optimizer_state: Any = None,
               epoch: int = 0, skip_optimizer: bool = True, async_save: bool = False,
               extra_metadata: Optional[dict] = None) -> str:
    """Save a self-describing checkpoint; return its path. One save is in
    flight at a time: a second waits for the first."""
    global _pending
    path = os.path.abspath(os.path.join(checkpoints_dir, f"epoch_{epoch:03d}"))
    os.makedirs(path, exist_ok=True)
    wait_for_checkpoints()
    meta = {**model_metadata(model), "epoch": epoch, **(extra_metadata or {})}
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    params = _host_copy(model.state_dict())
    opt = (None if optimizer_state is None or skip_optimizer
           else _host_copy(optimizer_state))

    def write():
        if opt is not None:
            _commit(opt, os.path.join(path, "opt_state.pt"))
        _commit(params, os.path.join(path, "params.pt"))

    if not async_save:
        write()
        return path

    def background():
        try:
            write()
        except BaseException as e:  # raised by the next wait_for_checkpoints
            _pending_error.append(e)

    _pending = threading.Thread(target=background, daemon=False)
    _pending.start()
    return path


def _check_not_orbax(path: str) -> None:
    if (os.path.isdir(os.path.join(path, "params"))
            and not os.path.isfile(os.path.join(path, "params.pt"))):
        raise ValueError(f"{path} {ORBAX_MESSAGE}")


def load_state(checkpoint_path: str, model: Optional[nn.Module] = None, strict: bool = True,
               device="cuda") -> nn.Module:
    """Load a checkpoint into ``model``, or rebuild the model from the
    metadata alone on ``device`` when it is None. ``strict=False`` copies
    every saved leaf whose path and shape the model has and keeps the
    model's values for the rest (``adapters.transfer_params``), printing
    the paths it kept."""
    from peekvit_torch.models.adapters import _nest, load_tree, module_params, transfer_params

    wait_for_checkpoints()
    path = os.path.abspath(checkpoint_path)
    _check_not_orbax(path)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if model is None:
        from peekvit_torch.models.registry import build_model

        model_args = dict(meta["model_args"])
        for key in ("torch_pretrained_weights", "timm_pretrained_weights", "_target_"):
            model_args.pop(key, None)
        model = build_model(meta["model_class"], model_args, meta.get("noise_args"),
                            device=device)
    state = torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True)
    if strict:
        model.load_state_dict(state)
        return model
    merged, missing, _ = transfer_params(_nest(state.items()), module_params(model))
    if missing:
        print("Params missing from checkpoint (keeping init):", missing[:10])
    return load_tree(model, merged)


def load_optimizer_state(checkpoint_path: str) -> dict:
    """The optimizer state_dict of a checkpoint (``opt_state.pt``), on the
    host; ``torch.optim.Optimizer.load_state_dict`` moves it to the
    parameters' device."""
    wait_for_checkpoints()
    path = os.path.join(os.path.abspath(checkpoint_path), "opt_state.pt")
    return torch.load(path, map_location="cpu", weights_only=True)


def get_checkpoint_path(experiment_dir: str) -> Optional[str]:
    """The last committed checkpoint (lexical order) in
    {dir}/checkpoints or in {dir} itself; a checkpoint whose params.pt is
    not committed yet is skipped. A directory holding only orbax
    checkpoints raises."""
    for root in (os.path.join(experiment_dir, "checkpoints"), experiment_dir):
        if not os.path.isdir(root):
            continue
        dirs = sorted(d for d in os.listdir(root) if d.startswith("epoch_")
                      and os.path.isfile(os.path.join(root, d, "metadata.json")))
        epochs = [d for d in dirs if os.path.isfile(os.path.join(root, d, "params.pt"))]
        if epochs:
            return os.path.join(root, epochs[-1])
        for d in dirs:
            _check_not_orbax(os.path.join(root, d))
    return None
