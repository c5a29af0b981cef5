"""Rank processes for tests/test_torch_data_parallel.py.

A spawned rank imports the module that defines its target, so the target
lives here, in a module that imports only torch and numpy. Each rank joins
a gloo group through a file in the test's tmp directory, builds a
``(world, 1)`` data mesh on the CPU, loads the port's models from the
weights the test saved, runs every case with the global batch and writes
its outputs to ``rank<r>.npz``:

- ``engine`` cases: ``InferenceEngine(mesh=...)`` (fp32) at each budget,
  keyed ``<name>/<budget>``;
- ``train`` cases: a ``Trainer(mesh=...)`` taking steps on the saved
  batch, keyed ``<name>/loss/<step>``, ``<name>/<metric>/<step>``,
  ``<name>/param/<path>`` (the parameters after the last step),
  ``<name>/kind`` (the step the Trainer took) and ``<name>/opt_bytes``
  (the optimizer state this rank holds). A case may feed the dropout
  masks (``masks``: the global batch's, replayed through
  ``ops/dropout.keep_mask`` in order on every step) and the fused
  ResidualViT step's budget vector (``budgets``).
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


def load_model(tmp: str, case: dict):
    """The port's model of ``case`` with the saved weights (CPU)."""
    from peekvit_torch import build_model
    from peekvit_torch.models.adapters import params_from_jax

    with np.load(os.path.join(tmp, case["weights"] + ".npz")) as weights:
        return params_from_jax(build_model(case["family"], case["args"], device="cpu"),
                               _nest(weights))


def replay_masks(masks: list, steps: int):
    """A ``keep_mask`` serving ``masks`` in order, once per step."""
    order = iter(list(range(len(masks))) * steps)

    def keep_mask(shape, keep_prob, generator, device):
        mask = masks[next(order)]
        assert tuple(shape) == mask.shape, (tuple(shape), mask.shape)
        return torch.from_numpy(mask).to(device)

    return keep_mask


def make_trainer(model, case: dict, mesh=None):
    from peekvit_torch import Trainer
    from peekvit_torch.training import optim
    from peekvit_torch.utils import losses

    kw = dict(case["trainer"])
    if "loss_compose" in kw:
        kw["loss_compose"] = losses.LossCompose(kw["loss_compose"])
    opt = getattr(optim, case["optimizer"][0])(**case["optimizer"][1])
    return Trainer(model=model, optimizer=opt, device="cpu", mesh=mesh, **kw)


def train_case(tmp: str, case: dict, images, labels, mesh=None) -> dict:
    """Run one train case (patching the fed draws); its outputs by key."""
    from peekvit_torch.models.adapters import live_params, tree_leaves
    from peekvit_torch.ops import dropout as tdrop
    from peekvit_torch.training import trainer as trainer_mod

    name, steps = case["name"], case["steps"]
    model = load_model(tmp, case)
    trainer = make_trainer(model, case, mesh)
    saved = tdrop.keep_mask, trainer_mod.sample_budgets
    try:
        if case.get("masks"):
            with np.load(os.path.join(tmp, case["masks"] + ".npz")) as f:
                masks = [f[f"m{i}"] for i in range(len(f.files))]
            tdrop.keep_mask = replay_masks(masks, len(steps))
        if case.get("budgets"):
            bvec = torch.from_numpy(np.load(os.path.join(tmp, case["budgets"] + ".npy")))
            trainer_mod.sample_budgets = lambda model, n, gen, device: bvec.to(device)
        out = {}
        for i, step_idx in enumerate(steps):
            metrics = trainer.train_step(images, labels, budget=case.get("budget"),
                                         step_idx=step_idx)
            for key, value in metrics.items():
                out[f"{name}/{key}/{i}"] = value.numpy()
    finally:
        tdrop.keep_mask, trainer_mod.sample_budgets = saved
    out[f"{name}/kind"] = np.array(trainer._train_kind)
    opt = trainer.torch_optimizer
    out[f"{name}/opt_bytes"] = np.array(
        opt.state_bytes() if hasattr(opt, "state_bytes")
        else sum(t.numel() * t.element_size() for st in opt.state.values()
                 for t in st.values() if isinstance(t, torch.Tensor)))
    for path, leaf in tree_leaves(live_params(model)):
        out[f"{name}/param/{path}"] = leaf.detach().numpy()
    return out


def engine_case(tmp: str, case: dict, images, mesh=None) -> dict:
    from peekvit_torch import InferenceEngine

    engine = InferenceEngine(load_model(tmp, case), compute_dtype=torch.float32, device="cpu",
                             mesh=mesh, **case["engine"])
    return {f"{case['name']}/{b}": engine(images, **({} if b is None else {"budget": b})).numpy()
            for b in case["budgets"]}


def run(rank: int, world: int, tmp: str, cases: list) -> None:
    """One rank: every case of ``cases`` (weights in ``<tmp>/<weights>.npz``,
    images in ``<tmp>/<images>.npy``, labels in ``<tmp>/labels.npy``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                            world_size=world, rank=rank)
    try:
        from peekvit_torch.parallel import make_mesh

        mesh = make_mesh(world, 1, device="cpu")
        labels = np.load(os.path.join(tmp, "labels.npy"))
        out = {}
        for case in cases:
            images = np.load(os.path.join(tmp, case["images"] + ".npy"))
            if case["kind"] == "engine":
                out.update(engine_case(tmp, case, images, mesh))
            else:
                out.update(train_case(tmp, case, images, labels[:images.shape[0]], mesh))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
