"""Rank processes for tests/test_torch_pipeline.py.

A spawned rank imports the module that defines its target, so the target
lives here, in a module that imports only torch, numpy and the port. Each
rank joins a gloo group through a file in the test's tmp directory, runs
every case on the CPU in fp32, building each mesh it names once (every
rank in the same order), and writes its outputs to ``rank<r>.npz``:

- ``pipeline`` cases: ``pipeline_forward`` over the saved ``blocks.npz``
  stages (``vit_block_forward``) on the saved ``tokens.npy``, keyed
  ``<name>``;
- ``forward`` cases: ``pipelined_vit_forward`` of the saved weights on the
  batch, keyed ``<name>/logits``, and the gradient of the cross-entropy
  summed over the ranks (each backpropagates ``loss / world``), keyed
  ``<name>/grad/<path>``;
- ``gated`` cases: the gated ResidualViT's pipelined or SP forward at
  the case's budget, keyed ``<name>/logits`` and ``<name>/mask/<layer>``;
- ``train`` cases: a Trainer of the case's keywords taking SGD steps on
  the batch, keyed ``<name>/<metric>/<step>``, ``<name>/param/<path>``
  (after the last step), ``<name>/kind``, ``<name>/kernels`` and
  ``<name>/warned`` (whether the step warned of the bubble); a case with
  ``refused_budget`` first records the message its step raises at that
  budget, keyed ``<name>/refused``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from torch_dp_worker import _nest, load_model, make_trainer


def _mesh(meshes: dict, spec):
    """The mesh of ``spec`` = (n_data, n_second, axis name), built once."""
    from peekvit_torch.parallel import make_mesh

    if spec not in meshes:
        meshes[spec] = make_mesh(spec[0], spec[1], device="cpu", axis=spec[2])
    return meshes[spec]


def _grads(model, world: int) -> dict:
    """Every parameter's gradient summed over the ranks."""
    leaves = [(k.replace(".", "/"), p) for k, p in model.named_parameters()]
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for _, p in leaves])
    dist.all_reduce(flat)
    out, offset = {}, 0
    for path, p in leaves:
        out[path] = flat[offset:offset + p.numel()].view_as(p).numpy()
        offset += p.numel()
    return out


def _pipeline_case(tmp: str, case: dict, mesh) -> np.ndarray:
    from peekvit_torch.parallel import pipeline_forward, stack_stage_params
    from peekvit_torch.parallel.pipeline import vit_block_forward

    with np.load(os.path.join(tmp, "blocks.npz")) as f:
        stages = _nest({k: torch.from_numpy(f[k]) for k in f.files})
    stacked = stack_stage_params([stages[str(i)] for i in range(len(stages))])
    tokens = torch.from_numpy(np.load(os.path.join(tmp, "tokens.npy")))
    with torch.no_grad():
        return pipeline_forward(lambda p, a: vit_block_forward(p, a, case["heads"]), stacked,
                                tokens, mesh=mesh, num_microbatches=case["microbatches"]).numpy()


def _forward_case(case: dict, model, images, labels, mesh, world: int) -> dict:
    from peekvit_torch.models.adapters import live_params
    from peekvit_torch.parallel.pipeline import pipelined_vit_forward

    name = case["name"]
    logits = pipelined_vit_forward(
        live_params(model), torch.from_numpy(images), mesh=mesh,
        num_microbatches=case["microbatches"], num_heads=model.num_heads,
        patch_size=model.patch_size, kernels=case["kernels"])
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels).long())
    (loss / world).backward()
    out = {f"{name}/logits": logits.detach().numpy()}
    out.update({f"{name}/grad/{k}": v for k, v in _grads(model, world).items()})
    return out


def _gated_case(case: dict, model, images, mesh) -> dict:
    from peekvit_torch.models.adapters import module_params
    from peekvit_torch.parallel import residual

    name = case["name"]
    kw = dict(mesh=mesh, num_heads=model.num_heads, patch_size=model.patch_size,
              gate_temp=model.gate_temp, gate_bias=model.gate_bias,
              budget_token=model.add_budget_token, data_axis=case.get("data_axis"))
    if case["form"] == "pipeline":
        fwd = residual.pipelined_residualvit_forward
        kw["num_microbatches"] = case["microbatches"]
    else:
        fwd = residual.sequence_parallel_residualvit_forward
    bvec = torch.full((images.shape[0],), case["budget"], dtype=torch.float32)
    with torch.no_grad():
        logits, aux = fwd(module_params(model), torch.from_numpy(images), bvec, **kw)
    assert torch.equal(aux["current_budget"], bvec)
    out = {f"{name}/logits": logits.numpy()}
    out.update({f"{name}/mask/{k}": v.numpy() for k, v in aux["masks"].items()})
    return out


def _train_case(case: dict, model, images, labels, mesh) -> dict:
    from peekvit_torch.models.adapters import module_params, tree_leaves

    name = case["name"]
    trainer = make_trainer(model, case, mesh)
    out = {}
    if "refused_budget" in case:
        try:
            trainer.train_step(images, labels, budget=case["refused_budget"])
        except NotImplementedError as exc:
            out[f"{name}/refused"] = np.array(str(exc))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for i, step_idx in enumerate(case["steps"]):
            metrics = trainer.train_step(images, labels, budget=case.get("budget"),
                                         step_idx=step_idx)
            for key, value in metrics.items():
                out[f"{name}/{key}/{i}"] = value.numpy()
    out[f"{name}/warned"] = np.array(any("pipeline_microbatches" in str(w.message)
                                         for w in rec))
    out[f"{name}/kind"] = np.array(trainer._train_kind)
    kw = trainer._pipeline_fwd_kwargs or trainer._sp_fwd_kwargs
    out[f"{name}/kernels"] = np.array(kw.get("kernels", "fp32"))
    for path, leaf in tree_leaves(module_params(model)):
        out[f"{name}/param/{path}"] = leaf.numpy()
    return out


def run(rank: int, world: int, tmp: str, cases: list) -> None:
    """One rank: every case of ``cases`` (weights in ``<tmp>/<weights>.npz``,
    images in ``<tmp>/images.npy``, labels in ``<tmp>/labels.npy``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
                            world_size=world, rank=rank)
    try:
        meshes = {}
        images = np.load(os.path.join(tmp, "images.npy"))
        labels = np.load(os.path.join(tmp, "labels.npy"))
        out = {}
        for case in cases:
            mesh = None if case.get("mesh") is None else _mesh(meshes, tuple(case["mesh"]))
            kind = case["kind"]
            if kind == "pipeline":
                out[case["name"]] = _pipeline_case(tmp, case, mesh)
                continue
            model = load_model(tmp, case)
            if kind == "forward":
                out.update(_forward_case(case, model, images, labels, mesh, world))
            elif kind == "gated":
                out.update(_gated_case(case, model, images, mesh))
            else:
                out.update(_train_case(case, model, images, labels, mesh))
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
