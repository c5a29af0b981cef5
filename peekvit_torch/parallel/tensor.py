"""Tensor-parallel (Megatron) training over the mesh's model axis
(counterpart of ``Trainer(tensor_parallel=True)``: the JAX linen step with
the parameters placed by ``parallel.shard_params(tensor_parallel=True)``,
peekvit_tpu/training/trainer.py:206-275, rules at parallel/mesh.py:110-138).

JAX places the leaves and lets XLA's partitioner derive the collectives.
Here each rank of a model row is a process that holds its shards, and
:func:`tensor_parallel_params` swaps the model's sublayers for Megatron
forms that compute with them:

- ``SelfAttention`` -> :class:`TPSelfAttention`: this rank's heads. Its
  qkv kernel and bias hold the head group's columns of each of q, k and v
  (``parallel/tp_serving._qkv_shards``' cut), its out-projection the
  matching rows; the out-projection bias stays whole, added once after the
  all-reduce;
- ``MLP`` -> :class:`TPMLP`: fc1's columns and bias, fc2's rows, fc2's
  bias whole;
- a gated ``MoESublayer`` over ``StackedMLP`` experts ->
  :class:`TPMoESublayer`: E / n whole experts (every expert leaf split on
  its expert axis), whose share of the dense one-hot combine is summed
  over the row by one all-reduce; the gate stays whole.

Two autograd functions carry the row (Megatron's f and g):
:func:`copy_to_model` (identity forward, all-reduce backward) in front of
a column-parallel product, :func:`reduce_from_model` (all-reduce forward,
identity backward) after a row-parallel one. Every activation between
them is whole and the same on every rank of the row, so each rank's
gradient of a whole leaf is the whole gradient; the gradient of a slice is
its slice's.

Every leaf's placement is JAX's ``param_spec`` (``parallel/mesh.py``).
A leaf the rules split that no Megatron form computes with (A-ViT's
stacked (L, 3D) / (L, M) biases, the in-projection bias of a stack of
attention experts: JAX's 1-D bias spec on a 2-D leaf splits its leading
axis) is held as its slice and gathered whole in front of each forward
(``training/fsdp.ShardedParams``). The gates, budgets, dropout masks and
noise are drawn whole on every rank from the step's generators, and the
attention-weight dropout keeps this rank's heads (``ops/dropout.py``), so
a step is the single device's up to the order of the sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from peekvit_torch.models.adapters import live_params, tree_leaves
from peekvit_torch.models.moevit import MoESublayer, StackedMLP, combine
from peekvit_torch.ops.attention import SelfAttention, attention_core, get_attention_impl
from peekvit_torch.ops.cuda.fused_attention import fused_mhsa
from peekvit_torch.ops.mlp import MLP, mlp_forward
from peekvit_torch.parallel.mesh import MODEL_AXIS, param_spec, split_axis
from peekvit_torch.training.fsdp import HELD, WHOLE, Leaf, ShardedParams, gathered_leaf, take_part


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced (fp32) over the row."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The partials all-reduced (fp32) over the row; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        total = x.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=group)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def _part(p: torch.Tensor, axis: int, mesh, qkv: bool = False) -> nn.Parameter:
    return nn.Parameter(take_part(p.detach(), axis, mesh.shape[MODEL_AXIS], mesh.model_index,
                                  qkv))


def _check_split(what: str, size: int, n: int) -> None:
    if size % n:
        raise ValueError(f"tensor_parallel: {what} {size} must be divisible by the mesh's "
                         f"'{MODEL_AXIS}' axis size {n}")


class TPSelfAttention(nn.Module):
    """``SelfAttention`` on this rank's heads; the JAX parameter names."""

    def __init__(self, attn: SelfAttention, mesh):
        super().__init__()
        n = mesh.shape[MODEL_AXIS]
        _check_split("num_heads", attn.num_heads, n)
        self.mesh = mesh
        self.num_heads = attn.num_heads // n
        self.dropout = attn.dropout
        self.in_proj_kernel = _part(attn.in_proj_kernel, 1, mesh, qkv=True)
        self.in_proj_bias = _part(attn.in_proj_bias, 0, mesh, qkv=True)
        self.out_proj_kernel = _part(attn.out_proj_kernel, 0, mesh)
        self.out_proj_bias = attn.out_proj_bias

    def forward(self, x: torch.Tensor, *, key_mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: torch.Generator | None = None) -> torch.Tensor:
        mesh = self.mesh
        qkv = torch.matmul(copy_to_model(x, mesh), self.in_proj_kernel) + self.in_proj_bias
        deterministic = not (self.training or train)
        if get_attention_impl() == "pallas" and key_mask is None and deterministic:
            out = fused_mhsa(qkv, self.num_heads)
        else:
            dl = qkv.shape[-1] // 3
            out = attention_core(qkv[..., :dl], qkv[..., dl:2 * dl], qkv[..., 2 * dl:],
                                 self.num_heads, key_mask=key_mask,
                                 dropout_rate=self.dropout if train else 0.0,
                                 deterministic=deterministic, generator=generator,
                                 head_shard=(mesh.shape[MODEL_AXIS], mesh.model_index))
        partial = torch.matmul(out, self.out_proj_kernel)
        return reduce_from_model(partial, mesh) + self.out_proj_bias


class TPMLP(nn.Module):
    """``MLP`` on this rank's fc1 columns and fc2 rows."""

    def __init__(self, mlp: MLP, mesh):
        super().__init__()
        _check_split("mlp_dim", mlp.fc1_kernel.shape[1], mesh.shape[MODEL_AXIS])
        self.mesh = mesh
        self.fc1_kernel = _part(mlp.fc1_kernel, 1, mesh)
        self.fc1_bias = _part(mlp.fc1_bias, 0, mesh)
        self.fc2_kernel = _part(mlp.fc2_kernel, 0, mesh)
        self.fc2_bias = mlp.fc2_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(torch.matmul(copy_to_model(x, self.mesh), self.fc1_kernel) + self.fc1_bias,
                   approximate="none")
        return reduce_from_model(torch.matmul(h, self.fc2_kernel), self.mesh) + self.fc2_bias


class TPStackedMLP(nn.Module):
    """This rank's E / n experts of a ``StackedMLP``; returns their outputs
    (E / n, B, N, D)."""

    def __init__(self, experts: StackedMLP, mesh):
        super().__init__()
        _check_split("the expert count", experts.fc1_kernel.shape[0], mesh.shape[MODEL_AXIS])
        for name in ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"):
            setattr(self, name, _part(getattr(experts, name), 0, mesh))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([mlp_forward(x, {"fc1": {"kernel": self.fc1_kernel[i],
                                                    "bias": self.fc1_bias[i]},
                                            "fc2": {"kernel": self.fc2_kernel[i],
                                                    "bias": self.fc2_bias[i]}})
                            for i in range(self.fc1_kernel.shape[0])])


class TPMoESublayer(nn.Module):
    """A gated MLP ``MoESublayer`` with its experts split over the row: the
    gate whole, this rank's experts' share of the combine, summed over the
    row. Returns (output, probs) as the sublayer."""

    def __init__(self, sub: MoESublayer, mesh):
        super().__init__()
        self.mesh = mesh
        self.attention = False
        self.experts = TPStackedMLP(sub.experts, mesh)
        self.gating_network = sub.gating_network

    def forward(self, x: torch.Tensor, train: bool, generator):
        mesh = self.mesh
        probs = self.gating_network(x, train, generator)
        local = self.experts.fc1_kernel.shape[0]
        lo = mesh.model_index * local
        outs = self.experts(copy_to_model(x, mesh))
        mine = copy_to_model(probs, mesh)[..., lo:lo + local]
        return reduce_from_model(combine(outs, mine), mesh), probs


def _megatron_form(module: nn.Module, mesh) -> Optional[nn.Module]:
    if type(module) is SelfAttention:
        return TPSelfAttention(module, mesh)
    if type(module) is MLP:
        return TPMLP(module, mesh)
    if isinstance(module, MoESublayer) and isinstance(getattr(module, "experts", None),
                                                      StackedMLP):
        return TPMoESublayer(module, mesh)
    return None


# (module class, parameter name) -> (axis, qkv) of a Megatron form's slice
_HELD = {(TPSelfAttention, "in_proj_kernel"): (1, True),
         (TPSelfAttention, "in_proj_bias"): (0, True),
         (TPSelfAttention, "out_proj_kernel"): (0, False),
         (TPMLP, "fc1_kernel"): (1, False), (TPMLP, "fc1_bias"): (0, False),
         (TPMLP, "fc2_kernel"): (0, False)}
_HELD.update({(TPStackedMLP, name): (0, False)
              for name in ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias")})


def tensor_parallel_params(model: nn.Module, mesh) -> ShardedParams:
    """Place ``model``'s parameters over ``mesh``'s model row, leaf by leaf
    by JAX's ``param_spec``: swap its sublayers for their Megatron forms
    (which hold their slices), hold the slice of every other leaf the
    rules split (gathered whole in front of each forward), keep the rest
    whole. Returns the rank's :class:`ShardedParams` over the model row."""
    n, index = mesh.shape[MODEL_AXIS], mesh.model_index
    whole = {path: (tuple(p.shape), p.dim()) for path, p in tree_leaves(live_params(model))}
    for name, module in list(model.named_modules()):
        form = _megatron_form(module, mesh)
        if form is not None:
            form.train(module.training)
            parent, _, attr = name.rpartition(".")
            setattr(model.get_submodule(parent) if parent else model, attr, form)
    owners = {}
    for name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            owners[id(p)] = (type(module), pname)
    leaves = []
    for path, p in tree_leaves(live_params(model)):
        shape, ndim = whole[path]
        axis = split_axis(param_spec(path, ndim), MODEL_AXIS)
        held = _HELD.get(owners[id(p)])
        if held is not None:
            if axis != held[0]:
                raise AssertionError(f"{path}: the Megatron form splits axis {held[0]}, JAX's "
                                     f"rule axis {axis}")
            leaves.append(Leaf(path, p, p, HELD, shape, *held))
        elif axis is None:
            leaves.append(Leaf(path, p, p, WHOLE, shape))
        else:
            _check_split(f"{path} axis {axis} of", shape[axis], n)
            leaves.append(gathered_leaf(path, p, axis, n, index))
    return ShardedParams(leaves, n, index, mesh.model_group)
