"""Optimizers, schedulers and main losses (counterpart of
peekvit_tpu/training/optim.py), as torch optimizers over live parameters.

The JAX package builds optax transforms and chains them in the Trainer
(trainer.py:161-171): clip_by_global_norm -> masked(set_to_zero) for
frozen params -> the optimizer, all optionally inside optax.MultiSteps.
Here :meth:`OptimizerSpec.build` returns the torch optimizer (with the
freezing as a step pre-hook) and :class:`GradientTransform` applies the
clipping and the accumulation around it. Two optax behaviours are copied
exactly:

- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  as ``(g / norm) * max_norm`` (torch's ``clip_grad_norm_`` adds 1e-6 to
  the norm);
- a frozen parameter's gradient is zeroed *before* the optimizer, so the
  coupled L2 of ``adam``/``sgd`` and AdamW's decoupled decay still move
  it (it is not ``requires_grad=False``).

The learning rate lives in the optimizer's ``param_groups``, so the
per-epoch scheduler write is :func:`set_learning_rate`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from peekvit_torch.models.adapters import tree_leaves


@dataclasses.dataclass
class OptimizerSpec:
    """Self-describing optimizer config; ``build()`` makes the optimizer."""

    kind: str
    lr: float
    weight_decay: float = 0.0
    momentum: float = 0.0

    def build(self, params: dict, param_mask: Optional[dict] = None) -> torch.optim.Optimizer:
        """params: a nested dict of live parameters (``live_params``);
        param_mask: the same tree of bools, True = trainable (None: all)."""
        named = tree_leaves(params)
        tensors = [p for _, p in named]
        if self.kind == "adam":
            # optax.adam (b1 0.9, b2 0.999, eps 1e-8) with coupled L2
            # (optim.py:72-77): torch Adam's own weight_decay
            opt = torch.optim.Adam(tensors, lr=self.lr, weight_decay=self.weight_decay)
        elif self.kind == "adamw":
            opt = torch.optim.AdamW(tensors, lr=self.lr, weight_decay=self.weight_decay)
        elif self.kind == "sgd":
            # coupled L2 then heavy-ball momentum (optim.py:80-84)
            opt = torch.optim.SGD(tensors, lr=self.lr, momentum=self.momentum,
                                  weight_decay=self.weight_decay)
        else:
            raise ValueError(f"Unknown optimizer kind {self.kind}")
        if param_mask is not None:
            trainable = dict(tree_leaves(param_mask))
            frozen = [p for name, p in named if not trainable[name]]
            opt.register_step_pre_hook(lambda *_: _zero_grads(frozen))
        return opt


def _zero_grads(params) -> None:
    """optax.masked(set_to_zero): the gradient is zero, not absent, so the
    optimizer still applies its decay to the parameter."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def clip_by_global_norm_(grads: list, max_norm: float, sq_norm=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: with norm the global L2 norm,
    each g becomes (g / norm) * max_norm unless norm < max_norm. Decided on
    the device (no host sync). ``sq_norm(grads)``: the squared global norm
    where ``grads`` are slices of a sharded gradient (the default sums
    their squares). Returns the norm."""
    norm = torch.sqrt(sq_norm(grads) if sq_norm is not None
                      else sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class GradientTransform:
    """What the JAX Trainer chains around the optimizer, over the ``.grad``
    of live parameters: optional k-call mean accumulation (optax.MultiSteps
    with its Welford mean, acc += (g - acc) / (n + 1), applied on the k-th
    call) -> clip_by_global_norm -> the optimizer (whose pre-hook zeroes
    frozen grads). Call it after ``backward()``; it clears the grads and
    returns whether the parameters moved. ``sq_norm``: the squared global
    norm of the gradients, for parameters that are slices of sharded
    leaves (``training/fsdp.ShardedParams.sq_norm``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, params: list,
                 clip_grad_norm: Optional[float] = None, grad_accumulation: int = 1,
                 sq_norm=None):
        self.optimizer = optimizer
        self.params = list(params)
        self.clip_grad_norm = clip_grad_norm
        self.sq_norm = sq_norm
        self.every_k = max(int(grad_accumulation or 1), 1)
        self.mini_step = 0
        self._acc = None

    def _grads(self) -> list:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def __call__(self) -> bool:
        grads = self._grads()
        if self.every_k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                self.optimizer.zero_grad(set_to_none=True)
                return False
            for acc, g in zip(self._acc, grads):
                g.copy_(acc)
                acc.zero_()
        if self.clip_grad_norm:
            clip_by_global_norm_(grads, self.clip_grad_norm, self.sq_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return True


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write the schedule's lr into every param group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    groups = optimizer.param_groups
    return float(groups[0]["lr"]) if groups else None


# ------------------------------------------------------------- config targets


def Adam(lr: float = 1e-3, weight_decay: float = 0.0, **_) -> OptimizerSpec:
    """torch.optim.Adam equivalent (configs/optimizer/adam.yaml)."""
    return OptimizerSpec("adam", lr=lr, weight_decay=weight_decay)


def AdamW(lr: float = 1e-3, weight_decay: float = 0.01, **_) -> OptimizerSpec:
    return OptimizerSpec("adamw", lr=lr, weight_decay=weight_decay)


def SGD(lr: float = 0.1, weight_decay: float = 0.0, momentum: float = 0.0, **_):
    """torch.optim.SGD equivalent (configs/optimizer/sgd.yaml)."""
    return OptimizerSpec("sgd", lr=lr, weight_decay=weight_decay, momentum=momentum)


@dataclasses.dataclass
class SchedulerSpec:
    """Per-epoch lr schedule (reference steps schedulers per epoch,
    train/train.py:125-127)."""

    kind: str
    T_max: int = 200
    eta_min: float = 0.0

    def lr_at(self, epoch: int, base_lr: float) -> float:
        if self.kind == "cosine":
            return self.eta_min + (base_lr - self.eta_min) * 0.5 * (
                1 + math.cos(math.pi * min(epoch, self.T_max) / self.T_max)
            )
        raise ValueError(f"Unknown scheduler kind {self.kind}")


def CosineAnnealingLR(T_max: int = 200, eta_min: float = 0.0, **_) -> SchedulerSpec:
    """torch CosineAnnealingLR equivalent (configs/scheduler/cosineannealing.yaml)."""
    return SchedulerSpec("cosine", T_max=T_max, eta_min=eta_min)


class CrossEntropyLoss:
    """torch.nn.CrossEntropyLoss: integer labels, mean reduced, in fp32."""

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(logits.float(), labels)


class MSELossMain:
    """torch.nn.MSELoss equivalent (reconstruction trainer main loss)."""

    def __call__(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.mean((pred - target) ** 2)
