"""Rank processes for tests/test_torch_tp_serving.py.

A spawned rank imports the module that defines its target, so the target
lives here, in a module that imports only torch and numpy (a test module
would import JAX and conftest's XLA flags into every rank). Each rank
joins a gloo group through a file in the test's tmp directory, builds the
port's models from the weights the test saved, serves every case through
``InferenceEngine(mesh=make_mesh(...))`` on the CPU in fp32 and writes its
outputs to ``rank<r>.npz``.
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


def serve(rank: int, world: int, n_model: int, tmp: str, cases: list) -> None:
    """One rank: every case of ``cases`` (dicts with ``name``, ``family``,
    ``args``, ``budgets``, ``ee``; weights in ``<tmp>/<name>.npz``, images
    in ``<tmp>/images.npy``) at each budget; outputs keyed
    ``<name>/<budget>/<output index>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                            world_size=world, rank=rank)
    try:
        from peekvit_torch import InferenceEngine, build_model
        from peekvit_torch.models.adapters import params_from_jax
        from peekvit_torch.parallel import make_mesh

        out = {}
        try:
            make_mesh(n_data=world, n_model=n_model, device="cpu")
        except ValueError as err:
            out["guard/world_size"] = np.array(str(err))
        mesh = make_mesh(n_data=world // n_model, n_model=n_model, device="cpu")
        images = torch.from_numpy(np.load(os.path.join(tmp, "images.npy")))
        for case in cases:
            with np.load(os.path.join(tmp, case["name"] + ".npz")) as weights:
                model = params_from_jax(build_model(case["family"], case["args"], device="cpu"),
                                        _nest(weights))
            engine = InferenceEngine(model, compute_dtype=torch.float32, device="cpu", mesh=mesh,
                                     ee_outputs=case["ee"])
            for budget in case["budgets"]:
                got = engine(images, budget=budget)
                for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
                    out[f"{case['name']}/{budget}/{i}"] = t.numpy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
