"""Rank processes for tests/test_torch_sharded_training.py.

A spawned rank imports the module that defines its target, so the target
lives here, in a module that imports only torch, numpy and the port. Each
rank joins a gloo group through a file in the test's tmp directory, builds
the ``(n_data, n_model)`` mesh of its world on the CPU, runs every case
(``torch_dp_worker``'s weights, trainers and mask replay) with the global
batch and writes its outputs to ``rank<r>.npz``:

- ``<name>/total_loss/<step>`` and the other metrics of each step;
- ``<name>/param/<path>``: the whole parameters after the last step
  (``Trainer.gathered_params``: gathered under FSDP and TP);
  ``<name>/eval``: ``Trainer.eval_step``'s correct count and loss on the
  batch after the steps;
- ``<name>/held_bytes`` / ``<name>/whole_bytes``: the parameter bytes this
  rank holds between steps and the whole model's; ``<name>/split/<when>``:
  the fraction of the model's elements in split leaves before and after
  the steps; ``<name>/opt_bytes``: the optimizer state this rank holds;
- with ``ckpt``: the checkpoint of the trained model (``save_state`` of
  ``Trainer.full_state_dict()``, one directory per rank) loaded into a
  single-device model (``<name>/ckpt_single/<path>``) and from its
  ``state_dict`` into a freshly placed Trainer
  (``Trainer.load_full_state_dict``; ``<name>/ckpt_sharded/<path>``,
  gathered back).

A case may feed the dropout masks (``masks``, replayed through
``ops/dropout.keep_mask``) and the MoE gates' Gumbel noise (``gumbel``,
through ``ops/gates._gumbel_noise``), each the global batch's, in order on
every step.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from torch_dp_worker import load_model, make_trainer, replay_masks


def _feed(tmp: str, name: str, steps: int):
    """``replay_masks`` over the arrays saved in ``<tmp>/<name>.npz``."""
    with np.load(os.path.join(tmp, name + ".npz")) as f:
        return replay_masks([f[f"m{i}"] for i in range(len(f.files))], steps)


def _opt_bytes(opt) -> int:
    if hasattr(opt, "state_bytes"):
        return opt.state_bytes()
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if isinstance(t, torch.Tensor))


def _split(trainer) -> float:
    return 0.0 if trainer._shards is None else trainer._shards.split_fraction()


def _held(trainer) -> tuple:
    if trainer._shards is not None:
        return trainer._shards.held_bytes(), trainer._shards.whole_bytes()
    total = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    return total, total


def train_case(tmp: str, case: dict, images, labels, mesh=None) -> dict:
    """Run one case (patching the fed draws); its outputs by key."""
    from peekvit_torch.models.adapters import tree_leaves
    from peekvit_torch.ops import dropout as tdrop
    from peekvit_torch.ops import gates as tgates

    name, steps = case["name"], case["steps"]
    trainer = make_trainer(load_model(tmp, case), case, mesh)
    out = {f"{name}/split/before": np.array(_split(trainer))}
    saved = tdrop.keep_mask, tgates._gumbel_noise
    try:
        if case.get("masks"):
            tdrop.keep_mask = _feed(tmp, case["masks"], len(steps))
        if case.get("gumbel"):
            draws = _feed(tmp, case["gumbel"], len(steps))
            tgates._gumbel_noise = lambda shape, gen, device: draws(shape, 0.0, gen,
                                                                    device).float()
        for i, step_idx in enumerate(steps):
            metrics = trainer.train_step(images, labels, budget=case.get("budget"),
                                         step_idx=step_idx)
            for key, value in metrics.items():
                out[f"{name}/{key}/{i}"] = value.numpy()
    finally:
        tdrop.keep_mask, tgates._gumbel_noise = saved
    out[f"{name}/kind"] = np.array(trainer._train_kind)
    out[f"{name}/split/after"] = np.array(_split(trainer))
    out[f"{name}/held_bytes"], out[f"{name}/whole_bytes"] = map(np.array, _held(trainer))
    out[f"{name}/opt_bytes"] = np.array(_opt_bytes(trainer.torch_optimizer))
    correct, loss, _ = trainer.eval_step(images, labels, budget=case.get("budget"))
    out[f"{name}/eval"] = np.array([float(correct), float(loss)])
    whole = trainer.gathered_params()
    for path, leaf in tree_leaves(whole):
        out[f"{name}/param/{path}"] = leaf.numpy()
    if case.get("ckpt"):
        out.update(_checkpoint_round_trip(tmp, case, trainer, mesh))
    return out


def _checkpoint_round_trip(tmp: str, case: dict, trainer, mesh) -> dict:
    """Save the sharded model, load it into a single-device model and into a
    fresh sharded Trainer."""
    from peekvit_torch import build_model
    from peekvit_torch.models.adapters import module_params, tree_leaves
    from peekvit_torch.utils.checkpoint import load_state, save_state

    name = case["name"]
    path = save_state(os.path.join(tmp, f"ckpt_{name}_rank{dist.get_rank()}"), trainer.model,
                      epoch=1, state_dict=trainer.full_state_dict())
    out = {}
    single = load_state(path, device="cpu")
    for key, leaf in tree_leaves(module_params(single)):
        out[f"{name}/ckpt_single/{key}"] = leaf.numpy()
    fresh = make_trainer(build_model(case["family"], case["args"], seed=99, device="cpu"),
                         case, mesh)
    fresh.load_full_state_dict(single.state_dict())
    for key, leaf in tree_leaves(fresh.gathered_params()):
        out[f"{name}/ckpt_sharded/{key}"] = leaf.numpy()
    return out


def run(rank: int, world: int, tmp: str, mesh_shape: tuple, cases: list) -> None:
    """One rank: every case of ``cases`` (weights in ``<tmp>/<weights>.npz``,
    images in ``<tmp>/<images>.npy``, labels in ``<tmp>/labels.npy``) over
    an ``mesh_shape`` mesh."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                            world_size=world, rank=rank)
    try:
        from peekvit_torch.parallel import make_mesh

        mesh = make_mesh(*mesh_shape, device="cpu")
        labels = np.load(os.path.join(tmp, "labels.npy"))
        out = {}
        for case in cases:
            images = np.load(os.path.join(tmp, case["images"] + ".npy"))
            out.update(train_case(tmp, case, images, labels[:images.shape[0]],
                                  None if case.get("single") else mesh))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
