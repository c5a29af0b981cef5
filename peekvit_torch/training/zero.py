"""ZeRO-1: the optimizer state sharded over the mesh's data axis
(counterpart of ``Trainer(zero_sharded_optimizer=True)`` and
peekvit_tpu/parallel/mesh.py ``zero1_optimizer_sharding``).

The trainable parameters, flattened in the Trainer's order, are cut into
``n`` equal slices (the last one shorter); rank ``data_index`` keeps the
fp32 master copy of its slice and the optimizer state for it (AdamW's two
moments: ``2 * 4 * P / n`` bytes on each rank in place of ``2 * 4 * P``)
and updates only that slice. The step:

1. the replicated gradient, all-reduced by the Trainer (gloo has no
   ``reduce_scatter``; one fp32 ``all_reduce`` of every gradient), clipped
   and accumulated on every rank as in the replicated step;
2. each rank copies its slice of the gradient, zeroes its frozen
   elements, and runs the optimizer on its slice;
3. the slices are all-gathered into every parameter: one fp32
   ``all_reduce`` of a zero-filled buffer of ``n`` slices (exact).

The optimizers are elementwise, so each element sees the replicated
step's operations on the same values: the numerics are the replicated
step's. The master slice is reread from the parameters at each step, so
a parameter written between steps is picked up. JAX shards the
accumulators of ``grad_accumulation`` too; here they stay replicated
(``optim.GradientTransform``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from peekvit_torch.models.adapters import tree_leaves
from peekvit_torch.parallel.mesh import DATA_AXIS
from peekvit_torch.training.optim import OptimizerSpec


class ZeroShardedOptimizer:
    """The optimizer of ``spec`` over this rank's slice of ``params`` (a
    nested dict of live parameters); ``param_mask`` the same tree of bools,
    True = trainable (None: all). It stands where the Trainer keeps its
    torch optimizer: ``step``, ``zero_grad``, ``param_groups``,
    ``state_dict`` (this rank's slice) and ``load_state_dict``."""

    def __init__(self, spec: OptimizerSpec, params: dict, mesh,
                 param_mask: Optional[dict] = None):
        named = tree_leaves(params)
        self.params = [p for _, p in named]
        self.n = mesh.shape[DATA_AXIS]
        self.index = mesh.data_index
        self.group = mesh.data_group
        total = sum(p.numel() for p in self.params)
        self.size = -(-total // self.n)
        lo = min(self.index * self.size, total)
        hi = min(lo + self.size, total)
        trainable = dict(tree_leaves(param_mask)) if param_mask is not None else None
        # (param, its first and last element in this slice, where they go)
        self._pieces = []
        frozen = []
        offset = 0
        for name, p in named:
            start, stop = max(offset, lo), min(offset + p.numel(), hi)
            if start < stop:
                self._pieces.append((p, start - offset, stop - offset, start - lo))
                if trainable is not None and not trainable[name]:
                    frozen.append((start - lo, stop - lo))
            offset += p.numel()
        device = self.params[0].device
        self.shard = torch.zeros(hi - lo, dtype=torch.float32, device=device)
        self._frozen = frozen
        self._read_params()
        self.inner = spec.build({"shard": self.shard})

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _read_params(self) -> None:
        with torch.no_grad():
            for p, a, b, s in self._pieces:
                self.shard[s:s + b - a].copy_(p.detach().reshape(-1)[a:b])

    def step(self) -> None:
        with torch.no_grad():
            self._read_params()
            grad = torch.zeros_like(self.shard)
            for p, a, b, s in self._pieces:
                if p.grad is not None:
                    grad[s:s + b - a].copy_(p.grad.reshape(-1)[a:b])
            for s, e in self._frozen:  # optax.masked(set_to_zero)
                grad[s:e] = 0.0
            self.shard.grad = grad
            self.inner.step()
            self.shard.grad = None
            flat = torch.zeros(self.n * self.size, dtype=torch.float32, device=self.shard.device)
            flat[self.index * self.size:self.index * self.size + self.shard.numel()] = self.shard
            if self.n > 1:
                dist.all_reduce(flat, group=self.group)
            offset = 0
            for p in self.params:
                p.copy_(flat[offset:offset + p.numel()].view_as(p))
                offset += p.numel()

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (its slice's moments)."""
        return sum(t.numel() * t.element_size() for st in self.inner.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor))
