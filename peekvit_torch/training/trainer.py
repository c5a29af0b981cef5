"""Train/eval harness, single device (counterpart of the single-device part
of peekvit_tpu/training/trainer.py).

A ``Trainer`` holds a built plain ``VisionTransformer`` on its device and
runs one of two train steps:

- **fused** (``fused="auto"`` on the card, or ``fused=True`` anywhere):
  ``training.fused.vit_forward_trainable``, the attention sublayer on the
  CUDA kernels (their plain versions on the CPU) with bf16 compute over
  fp32 master params. This is the JAX rule "fused only on the accelerator
  backend" (trainer.py:283).
- **module** (``fused=False`` / ``"never"``, or ``"auto"`` on the CPU): the
  model's own fp32 forward under autograd, as the linen step.

Both feed the same update: optional gradient accumulation, global-norm
clipping, freezing and the optimizer (``optim.GradientTransform``). The
JAX trainer's multi-device, quantisation-aware, regulariser and noise
options are not ported; each raises ``NotImplementedError`` naming its
ROADMAP.md port queue A item. Batches are moved to the trainer's device
as they come; the JAX ``prefetch_to_device`` (data/loader.py) is not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from peekvit_torch.models.adapters import live_params, tree_leaves
from peekvit_torch.models.registry import resolve_device
from peekvit_torch.models.residualvit import TRAINING_ITEM, ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.training.fused import trainable_forward_fn
from peekvit_torch.training.optim import (
    CrossEntropyLoss,
    GradientTransform,
    OptimizerSpec,
    SchedulerSpec,
    get_learning_rate,
    set_learning_rate,
)

# params that stay trainable when train_backbone=False
# (reference train.py:99-100 -> topology.py:128-157)
FINETUNE_KEYWORDS = ("gate", "class", "head", "threshold", "budget")


def param_filter_mask(params: dict, keywords=FINETUNE_KEYWORDS) -> dict:
    """True = trainable. Matches the reference's substring filter over
    parameter names (topology.train_only_these_params); names are the
    tree paths joined by "/", as in the JAX package."""

    def visit(node, prefix):
        out = {}
        for key, value in node.items():
            path = f"{prefix}{key}"
            out[key] = (visit(value, path + "/") if isinstance(value, dict)
                        else any(kw in path.lower() for kw in keywords))
        return out

    return visit(params, "")


def _main_logits(out, output_format: Optional[str]):
    if output_format == "early_exits":
        return out[-1]
    if output_format in ("logits_recon_mask", "logits_recon"):
        return out[0]
    return out


# field -> (value that means "unused", ROADMAP.md port queue A item)
_NOT_PORTED = {
    "mesh": (None, "item 9 (parallel and serving)"),
    "pipeline_stages": (0, "item 9 (parallel and serving)"),
    "pipeline_microbatches": (0, "item 9 (parallel and serving)"),
    "sequence_parallel_devices": (0, "item 9 (parallel and serving)"),
    "parallel_kernels": ("auto", "item 9 (parallel and serving)"),
    "tensor_parallel": (False, "item 9 (parallel and serving)"),
    "fsdp_sharded_params": (False, "item 9 (parallel and serving)"),
    "zero_sharded_optimizer": (False, "item 9 (parallel and serving)"),
    "qat": (False, "item 8 (QAT)"),
    "qat_caps": (None, "item 8 (QAT)"),
    "qat_smoothing": (None, "item 8 (QAT)"),
    "loss_compose": (None, "item 4b (ResidualViT training; LossCompose regularizers)"),
    "reconstruction_weight": (0.0, "item 7 (EncDec / MAE reconstruction)"),
    "ee_weights": (None, "item 4b (ResidualViT training; early exits)"),
}


@dataclasses.dataclass
class Trainer:
    """Owns the train step, the optimizer and the per-epoch schedule."""

    model: VisionTransformer
    optimizer: OptimizerSpec
    scheduler: Optional[SchedulerSpec] = None
    main_criterion: Optional[Callable] = None
    loss_compose: Any = None
    clip_grad_norm: Optional[float] = None
    train_backbone: bool = True
    reconstruction_weight: float = 0.0
    ee_weights: Optional[list] = None
    # the supported paths draw no random numbers (no dropout, no noise);
    # kept for parity with the JAX Trainer's PRNG seed
    seed: int = 0
    mesh: Any = None
    fused: Any = "auto"
    # flush per-batch log records every N steps with one host fetch
    log_every: int = 50
    pipeline_stages: int = 0
    pipeline_microbatches: int = 0
    sequence_parallel_devices: int = 0
    parallel_kernels: str = "auto"
    # >1: the mean gradient over k train_step calls, applied on the k-th
    # (optax.MultiSteps); clipping sees the mean, as for a true big batch
    grad_accumulation: int = 1
    zero_sharded_optimizer: bool = False
    fsdp_sharded_params: bool = False
    qat: Any = False
    qat_caps: Optional[tuple] = None
    qat_smoothing: Optional[tuple] = None
    tensor_parallel: bool = False
    # per-layer torch.utils.checkpoint on the fused path (the backward
    # recomputes each layer; save_qkv then defaults off)
    remat: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        for name, (unused, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            if name == "loss_compose" and not getattr(value, "additional_losses", None):
                continue  # no additional losses: the main criterion alone
            used = value is not None if unused is None else value != unused
            if used:
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet: ROADMAP.md port queue A {item}")
        if isinstance(self.model, ResidualVisionTransformer):
            raise NotImplementedError(
                f"the port's Trainer trains the plain VisionTransformer; training a "
                f"{type(self.model).__name__} is {TRAINING_ITEM}")
        if not isinstance(self.model, VisionTransformer):
            raise NotImplementedError(
                f"the port's Trainer trains the plain VisionTransformer; "
                f"{type(self.model).__name__} is ROADMAP.md port queue A items 5-7")
        if self.model.dropout or self.model.attention_dropout:
            raise NotImplementedError(
                "training with dropout is not ported yet (ROADMAP.md port queue A item 3): "
                "build the model with dropout=0.0 and attention_dropout=0.0")
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        if self.main_criterion is None:
            self.main_criterion = CrossEntropyLoss()
        self.params = live_params(self.model)
        mask = None if self.train_backbone else param_filter_mask(self.params)
        self.torch_optimizer = self.optimizer.build(self.params, param_mask=mask)
        self.tx = GradientTransform(self.torch_optimizer, [p for _, p in tree_leaves(self.params)],
                                    self.clip_grad_norm, self.grad_accumulation)
        self.output_format = None
        self._forward = None
        self._train_kind = None

    # ------------------------------------------------------------ train step

    def _fused_kind(self):
        """'vit' | None: whether the fused train path applies."""
        if self.fused in (False, "never"):
            return None
        if self.fused == "auto" and self.device.type != "cuda":
            return None
        return "vit"

    def _fused_eligible(self) -> bool:
        return self._fused_kind() is not None

    def _build_forward(self):
        if self.remat and self._fused_kind() != "vit":
            raise NotImplementedError(
                "remat=True is a fused plain-ViT train-path knob (per-layer checkpoint in "
                "training/fused.vit_forward_trainable); for the module path trade memory with "
                "grad_accumulation or a smaller batch")
        if self._fused_eligible():
            self._train_kind = "fused_vit"
            fwd = trainable_forward_fn(self.model, remat=self.remat)
            return lambda x: fwd(self.params, x)
        self._train_kind = "module"
        return lambda x: self.model(x)[0]

    def train_step(self, x, y, budget=None, noise_value=None, step_idx: int = 0):
        """One forward/backward and update. Returns the metrics as 0-d
        tensors on the device: classification_loss and total_loss.
        ``step_idx`` seeds nothing here (no path draws random numbers)."""
        del step_idx
        self._check_unported_args(budget, noise_value)
        if self._forward is None:
            self._forward = self._build_forward()
        x, y = self._to_device(x, y)
        ce = self.main_criterion(self._forward(x), y)
        ce.backward()
        self.tx()
        ce = ce.detach()
        return {"classification_loss": ce, "total_loss": ce}

    @staticmethod
    def _check_unported_args(budget, noise_value):
        if budget is not None:
            raise NotImplementedError(
                "a token budget (RankViT / ResidualViT) is not ported yet: ROADMAP.md port "
                "queue A items 4-5")
        if noise_value is not None:
            raise NotImplementedError("noise is not ported yet: ROADMAP.md port queue A item 10")

    # ------------------------------------------------------------- eval step

    def eval_step(self, x, y, budget=None, noise_value=None):
        """(correct count, mean loss, aux) of the model's fp32 forward."""
        self._check_unported_args(budget, noise_value)
        x, y = self._to_device(x, y)
        with torch.no_grad():
            out, aux = self.model(x)
            logits = _main_logits(out, self.output_format)
            loss = self.main_criterion(logits, y)
            correct = (logits.argmax(-1) == y).sum()
        return correct, loss, aux

    # --------------------------------------------------------------- epochs

    def train_epoch(self, loader, epoch: int, logger=None, budget=None,
                    noise_value=None, log_prefix: str = "train/",
                    should_stop=None) -> Dict[str, float]:
        """One epoch (reference train.py:97-127): per-epoch lr write, per-batch
        step, buffered logging, and the epoch's MEAN metrics.

        ``should_stop``: optional zero-arg callable polled between steps;
        when it returns True the epoch stops after the step in flight,
        flushes its metrics, and the summary carries ``interrupted=1.0``."""
        if self.scheduler is not None:
            set_learning_rate(self.torch_optimizer,
                              self.scheduler.lr_at(epoch, self.optimizer.lr))
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)

        count = 0
        running = None  # device-side metric sums: no per-batch host fetch
        pending = []  # buffered per-batch metrics awaiting a flush

        def flush():
            if logger is None or not pending:
                pending.clear()
                return
            for rec in _fetch_metric_records(pending):  # ONE host fetch
                logger.log({f"{log_prefix}{k}": v for k, v in rec.items()})
            pending.clear()

        interrupted = False
        for x, y in loader:
            metrics = self.train_step(x, y, budget=budget, noise_value=noise_value)
            if logger is not None:
                pending.append(metrics)
                if len(pending) >= max(self.log_every, 1):
                    flush()
            if running is None:
                running = {k: v.float() for k, v in metrics.items()}
            else:
                running = {k: running[k] + metrics[k].float() for k in running}
            count += 1
            if should_stop is not None and should_stop():
                interrupted = True
                break
        flush()
        sums: Dict[str, float] = (
            {} if running is None
            else {k: float(v / count) for k, v in running.items()})
        lr_now = get_learning_rate(self.torch_optimizer)
        if logger is not None and lr_now is not None:
            logger.log({f"{log_prefix}lr": lr_now})
        sums["num_batches"] = count
        if interrupted:
            sums["interrupted"] = 1.0
        return sums

    def validate(self, loader, budget=None, noise_value=None):
        """Accuracy + mean loss over a loader (reference train.py:129-145).
        Per-batch results accumulate on the device; one host fetch at the end."""
        total, batches = 0, 0
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for x, y in loader:
            c, loss, _ = self.eval_step(x, y, budget=budget, noise_value=noise_value)
            correct = correct + c
            loss_sum = loss_sum + loss
            total += int(y.shape[0])
            batches += 1
        return int(correct) / max(total, 1), float(loss_sum) / max(batches, 1)

    def _to_device(self, x, y):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(y, np.ndarray):
            y = torch.from_numpy(y)
        return (x.to(self.device, torch.float32, non_blocking=True),
                y.to(self.device, torch.int64, non_blocking=True))


def _fetch_metric_records(pending) -> list:
    """Buffered per-batch metric dicts with ONE device->host transfer."""
    keys = list(pending[0].keys())
    mat = torch.stack([torch.stack([m[k].float() for k in keys]) for m in pending]).cpu()
    return [dict(zip(keys, map(float, row))) for row in mat.tolist()]
