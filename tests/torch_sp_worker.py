"""Rank processes for tests/test_torch_sp_training.py.

A spawned rank imports the module that defines its target, so the target
lives here, in a module that imports only torch and numpy. Each rank joins
a gloo group through a file in the test's tmp directory, builds the port's
models from the weights the test saved, runs every case on the CPU in fp32
and writes its outputs to ``rank<r>.npz``:

- ``block`` cases: ``sequence_parallel_vit_block`` on layer 0's weights
  and the saved ``tokens.npy``, keyed ``<name>``;
- ``forward`` cases: ``sequence_parallel_vit_forward`` at each budget,
  keyed ``<name>/<budget>``, and for a ranking forward the same forward
  fed the kept tokens it reported, keyed ``<name>/<budget>/fed_kept``;
- ``train`` cases: a ``Trainer(sequence_parallel_devices=...)`` taking SGD
  steps over slices of the saved batch, keyed ``<name>/loss/<step>`` and
  ``<name>/param/<path>`` (the parameters after the last step), and
  ``<name>/kernels`` (the tail's form the Trainer resolved).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def _nest(flat) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def run(rank: int, world: int, tmp: str, cases: list) -> None:
    """One rank: every case of ``cases`` (weights in ``<tmp>/<weights>.npz``,
    images in ``<tmp>/<images>.npy``, labels in ``<tmp>/labels.npy``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                            world_size=world, rank=rank)
    try:
        from peekvit_torch import Trainer, build_model
        from peekvit_torch.models.adapters import module_params, params_from_jax, tree_leaves
        from peekvit_torch.parallel import make_mesh
        from peekvit_torch.parallel.sequence import (
            sequence_parallel_vit_block,
            sequence_parallel_vit_forward,
        )
        from peekvit_torch.training import optim

        meshes = {}
        labels = np.load(os.path.join(tmp, "labels.npy"))
        out = {}
        for case in cases:
            with np.load(os.path.join(tmp, case["weights"] + ".npz")) as weights:
                model = params_from_jax(build_model(case["family"], case["args"], device="cpu"),
                                        _nest(weights))
            images = np.load(os.path.join(tmp, case["images"] + ".npy"))
            mesh_shape = case.get("mesh")
            if mesh_shape is not None and mesh_shape not in meshes:
                meshes[mesh_shape] = make_mesh(*mesh_shape, device="cpu")
            mesh = None if mesh_shape is None else meshes[mesh_shape]
            name = case["name"]
            if case["kind"] == "block":
                tokens = torch.from_numpy(np.load(os.path.join(tmp, "tokens.npy")))
                with torch.no_grad():
                    out[name] = sequence_parallel_vit_block(
                        module_params(model)["encoder"]["layers_0"], tokens, model.num_heads,
                        mesh=mesh).numpy()
                continue
            if case["kind"] == "forward":
                params = module_params(model)
                kw = dict(num_heads=model.num_heads, patch_size=model.patch_size,
                          rankvit_layers=getattr(model, "rankvit_layers", ()), mesh=mesh,
                          kernels=case["kernels"])
                for budget in case["budgets"]:
                    kept = {}
                    with torch.no_grad():
                        logits = sequence_parallel_vit_forward(
                            params, torch.from_numpy(images), budget=budget, kept_out=kept, **kw)
                        out[f"{name}/{budget}"] = logits.numpy()
                        if kept:  # the same forward fed its own kept tokens
                            out[f"{name}/{budget}/fed_kept"] = sequence_parallel_vit_forward(
                                params, torch.from_numpy(images), budget=budget, kept=kept,
                                **kw).numpy()
                continue
            trainer = Trainer(model=model, optimizer=optim.SGD(lr=case["lr"]), device="cpu",
                              mesh=mesh, **case["trainer"])
            for step, (lo, hi) in enumerate(case["batches"]):
                metrics = trainer.train_step(images[lo:hi], labels[lo:hi],
                                             budget=case.get("budget"),
                                             step_idx=case.get("step_idx", step))
                out[f"{name}/loss/{step}"] = metrics["total_loss"].numpy()
            out[f"{name}/kernels"] = np.array(trainer._sp_fwd_kwargs["kernels"])
            for path, leaf in tree_leaves(module_params(model)):
                out[f"{name}/param/{path}"] = leaf.numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
