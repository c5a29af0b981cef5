"""A (data, model) mesh over the ranks of a ``torch.distributed`` group
(counterpart of peekvit_tpu/parallel/mesh.py ``make_mesh``).

The JAX mesh is a grid of devices in one program; here each rank is one
process, and the mesh is that rank's view of the grid: its position, the
process group of its model row (the ranks that hold the other slices of
the same weights, over which tensor-parallel partials are all-reduced)
and of its data column (the ranks that serve the other slices of the
batch), and its device.

Rank r sits at (data r // n_model, model r % n_model), the row-major
``reshape(n_data, n_model)`` of the JAX mesh, so a model row is ``n_model``
consecutive ranks. The caller initializes the default process group
(``torch.distributed.init_process_group``: address, world size, rank and
backend are the caller's); the mesh only splits it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from peekvit_torch.models.registry import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a (data, model) mesh. ``shape`` maps
    ``DATA_AXIS`` / ``MODEL_AXIS`` to their sizes; ``model_group`` holds the
    ranks of this rank's model row, ``data_group`` those of its data
    column; ``data_index`` / ``model_index`` are its position."""

    shape: dict
    data_group: Any
    model_group: Any
    data_index: int
    model_index: int
    device: torch.device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The calling rank's view of an ``n_data`` × ``n_model`` mesh over the
    default process group (``n_data`` defaults to world size // n_model).
    Every rank must call it, with the same arguments: each model row and
    each data column becomes a group (``dist.new_group``, called by every
    rank in the same order). ``device``: by default (or ``"cuda"`` with
    no index) ``cuda:{rank % device_count}``, so several ranks may share a
    card; pass ``"cpu"`` to run on the CPU. Raises without a card unless
    the CPU is asked for."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs n_data * n_model == world size, "
                         f"got world size {world}")
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    data_index, model_index = divmod(rank, n_model)
    model_group = data_group = None
    for i in range(n_data):
        group = dist.new_group([i * n_model + j for j in range(n_model)])
        if i == data_index:
            model_group = group
    for j in range(n_model):
        group = dist.new_group([i * n_model + j for i in range(n_data)])
        if j == model_index:
            data_group = group
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, data_group, model_group,
                data_index, model_index, dev)
