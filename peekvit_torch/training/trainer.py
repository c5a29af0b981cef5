"""Train/eval harness, single device (counterpart of the single-device part
of peekvit_tpu/training/trainer.py).

A ``Trainer`` holds a built ``VisionTransformer``, ``RankVisionTransformer``,
a model of the ResidualViT family (the early-exit and the EncDec model
included), an ``AdaptiveVisionTransformer``, an ``MAEVisionTransformer``
or a ``VisionTransformerMoE`` on its device and runs one of three train
steps (``_fused_kind``, the JAX conditions of trainer.py:278-308):

- **fused_vit** (a plain ViT or a RankViT, which trains as a plain ViT:
  ranking is an eval-time mechanism; ``fused="auto"`` on the card, or
  ``fused=True`` anywhere): ``training.fused.vit_forward_trainable``, the
  attention sublayer on the CUDA kernels (their plain versions on the CPU)
  with bf16 compute over fp32 master params. This is the JAX rule "fused
  only on the accelerator backend" (trainer.py:283).
- **fused_residual** (a ResidualViT with sigmoid gates, 'attention+mlp' on
  every layer, no ``add_input``, a budget token, no early exits):
  ``training.fused.residualvit_forward_trainable`` over the masked block's
  kernels, then cross-entropy plus the ``loss_compose`` regularizers
  against the batch-mean budget (trainer.py:746-764).
- **module** (otherwise, ``fused=False`` / ``"never"``, or ``"auto"`` on
  the CPU; always for A-ViT, MAE, MoE, the early-exit and EncDec models
  and a model with a NoiseBlock): the model's own fp32 train forward
  under autograd, as the linen step (trainer.py:344-380): the
  cross-entropy of the main logits (of every early exit, weighted by
  ``ee_weights``), the EncDec's masked-pixel reconstruction loss
  ``mean((x - recon)² · mask)`` at ``reconstruction_weight`` when it is
  non-zero (reported as ``reconstruction_loss``; an MAE trains on its
  logits' cross-entropy alone and any other model ignores the weight, as
  JAX's ``loss_fn`` does), and the regularizers (the A-ViT's ponder and
  depth-prior losses read the aux its forward returns). A RankViT given
  a ``budget=`` ranks there; on the fused path a budget raises (it would
  be ignored), as in JAX (trainer.py:814-828).

Which of the three runs is decided at construction from the model type
(the JAX rule). A fused path then holds the shapes to one predicate,
:func:`fused_train_limit`: on CUDA the fused paths' kernels take head
dims 32 and 64 at any token count, GEMM widths that are multiples of 32
and rows of at most 1024 for the LN backward. Every shipped training
config holds them. Where a CUDA model breaks one, ``fused="auto"`` and
``fused=True`` raise at construction, naming the limit; ``fused=False``
takes the module path. On the CPU the plain versions take any shape and
the predicate always holds.

- **sp** (``sequence_parallel_devices=S`` > 1, a plain ViT or a RankViT,
  the JAX ``_build_sp_train_step``, trainer.py:582-676): the token axis
  sharded over the mesh's model axis, one rank per process
  (``parallel.sequence.sequence_parallel_vit_forward``). Every rank
  computes the global loss; it backpropagates ``loss / world size`` and
  the parameter gradients are summed over every rank in one fp32
  all-reduce, so each rank ends the step with the gradient of JAX's one
  global loss and, after the same update, the same parameters.

All feed the same update: optional gradient accumulation, global-norm
clipping, freezing and the optimizer (``optim.GradientTransform``).

Random numbers (the budgets drawn when no ``budget=`` is given, the
gumbel gates' noise, the MAE's shuffle) come from a CPU ``torch.Generator``
seeded, for each step, with ``(seed << 32) | step_idx`` (both taken
modulo 2^32): one stream per step as the JAX step's
``fold_in(key(seed), step_idx)``, though not JAX's bits. The budgets are
drawn first, then each gate in layer order. The NoiseBlock's draws
(``train_step(noise_value=)``, for a model built with a noise layer) come
from :func:`noise_generator`, a second generator of the step's seed on
the batch's device, as JAX's step splits a ``noise`` key off the same
fold; ``eval_step`` draws from a generator seeded 0, JAX's ``key(0)``.
``train_epoch`` passes ``step_idx = epoch * steps_per_epoch + i`` as the
JAX trainer does.

The JAX trainer's other multi-device options (``mesh=`` without SP, the
pipeline, tensor-parallel, ZeRO and FSDP) and its quantisation-aware
options are not ported; each raises ``NotImplementedError`` naming its
ROADMAP.md port queue A item. A PCT or RankPCT is refused: the JAX
``Trainer`` cannot train one (its step holds the BatchNorm statistics
immutable); train it at module level. ``train_epoch`` and ``validate``
take their batches through ``data.loader.prefetch_to_device`` (two in
flight), as the JAX trainer's ``_device_batches``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from peekvit_torch.models.adapters import live_params, tree_leaves
from peekvit_torch.models.adavit import AdaptiveVisionTransformer
from peekvit_torch.models.maevit import MAEVisionTransformer
from peekvit_torch.models.moevit import VisionTransformerMoE
from peekvit_torch.models.pct import PointCloudTransformer
from peekvit_torch.models.rankpct import RankPointCloudTransformer
from peekvit_torch.models.rankvit import RankVisionTransformer
from peekvit_torch.models.registry import resolve_device
from peekvit_torch.models.residualvit import DROPOUT_ITEM, ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.ops.cuda.fused_attention import (
    GEMM_K_MULTIPLE,
    GEMM_N_MULTIPLE,
    SOFTMAX_HEAD_DIMS,
)
from peekvit_torch.ops.cuda.fused_attention_vjp import LN_BWD_MAX_WIDTH
from peekvit_torch.ops.noise import default_generator
from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from peekvit_torch.parallel.sequence import sequence_parallel_vit_forward
from peekvit_torch.training.fused import (
    residual_forward_fn,
    sample_budgets,
    trainable_forward_fn,
)
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


def step_generator(seed: int, step_idx: int) -> torch.Generator:
    """The CPU generator of one train step: seeded with
    ``(seed << 32) | step_idx``, each modulo 2^32."""
    return torch.Generator().manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                                         | (int(step_idx) & 0xFFFFFFFF))


# a step's NoiseBlock stream: the step seed's second generator
_NOISE_STREAM = 0x6E6F697365  # "noise"


def noise_generator(seed: int, step_idx: int, device="cpu") -> torch.Generator:
    """The NoiseBlock's generator of one train step, on ``device``: seeded
    with the step's seed (:func:`step_generator`) XOR a constant, so that
    its stream is not the budgets' and gates'."""
    step_seed = ((int(seed) & 0xFFFFFFFF) << 32) | (int(step_idx) & 0xFFFFFFFF)
    return torch.Generator(device=torch.device(device)).manual_seed(step_seed ^ _NOISE_STREAM)


# the families the Trainer trains; PCT and RankPCT are refused (module docstring)
_TRAINED = (VisionTransformer, RankVisionTransformer, ResidualVisionTransformer,
            AdaptiveVisionTransformer, MAEVisionTransformer, VisionTransformerMoE)


def _dropout_rates(model) -> tuple:
    """Every dropout rate a model was built with (MAE keeps its four in
    ``dropouts``; the EncDec's decoder has its own pair)."""
    names = ("dropout", "attention_dropout", "decoder_dropout", "decoder_attention_dropout")
    return tuple(getattr(model, n, 0.0) for n in names) + tuple(getattr(model, "dropouts", ()))


def _main_logits(out, output_format: Optional[str]):
    if output_format == "early_exits":
        return out[-1]
    if output_format in ("logits_recon_mask", "logits_recon"):
        return out[0]
    return out


def fused_train_limit(hidden_dim: int, num_heads: int, mlp_dim: int, device) -> Optional[str]:
    """The first limit of the fused train paths' CUDA kernels (the split,
    merged and SP-tail steps) that these widths break on ``device``, or
    None where every kernel takes them. On the CPU the plain versions take
    any shape: always None. Limits on CUDA: a head dim of 32 or 64
    (``attn_softmax_fwd`` / ``_bwd``, at any token count); every GEMM's K a
    multiple of 32 and N of 8 (``gemm_bias_epilogue``: K and N are d, 3 d
    and mlp_dim); rows of at most 1024 values, a multiple of 8, for the LN
    backward (``ln_bwd_rows``)."""
    if torch.device(device).type != "cuda":
        return None
    d, h, m = hidden_dim, num_heads, mlp_dim
    if d % h or d // h not in SOFTMAX_HEAD_DIMS:
        return (f"head dim {d / h:g} (hidden_dim {d} over {h} heads): the attention kernels "
                f"take head dims {SOFTMAX_HEAD_DIMS}")
    for name, width in (("hidden_dim", d), ("mlp_dim", m)):
        if width % GEMM_K_MULTIPLE or width % GEMM_N_MULTIPLE:
            return (f"{name} {width}: the GEMM kernel takes K a multiple of {GEMM_K_MULTIPLE} "
                    f"and N a multiple of {GEMM_N_MULTIPLE}")
    if d > LN_BWD_MAX_WIDTH:
        return f"hidden_dim {d}: the LN backward kernel takes rows of at most {LN_BWD_MAX_WIDTH}"
    return None


# field -> (value that means "unused", ROADMAP.md port queue A item);
# ``mesh`` is ported with sequence_parallel_devices > 1 only
_NOT_PORTED = {
    "mesh": (None, "item 9 (parallel and serving)"),
    "pipeline_stages": (0, "item 9 (parallel and serving)"),
    "pipeline_microbatches": (0, "item 9 (parallel and serving)"),
    "tensor_parallel": (False, "item 9 (parallel and serving)"),
    "fsdp_sharded_params": (False, "item 9 (parallel and serving)"),
    "zero_sharded_optimizer": (False, "item 9 (parallel and serving)"),
    "qat": (False, "item 8 (QAT)"),
    "qat_caps": (None, "item 8 (QAT)"),
    "qat_smoothing": (None, "item 8 (QAT)"),
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
    # seeds each step's generator with step_idx (budget sampling, gumbel gates)
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
    # per-layer torch.utils.checkpoint on the fused plain-ViT path (the
    # backward recomputes each layer; save_qkv then defaults off)
    remat: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        sp = (self.sequence_parallel_devices or 0) > 1
        for name, (unused, item) in _NOT_PORTED.items():
            value = getattr(self, name)
            used = value is not None if unused is None else value != unused
            if used and not (name == "mesh" and sp):
                raise NotImplementedError(
                    f"Trainer({name}=...) is not ported yet: ROADMAP.md port queue A {item}")
        if self.parallel_kernels not in ("auto", "xla", "pallas"):
            raise ValueError(f"parallel_kernels must be 'auto', 'xla' or 'pallas', got "
                             f"{self.parallel_kernels!r}")
        if isinstance(self.model, (PointCloudTransformer, RankPointCloudTransformer)):
            raise NotImplementedError(
                f"the JAX Trainer cannot train a {type(self.model).__name__} (its step holds "
                "the BatchNorm statistics immutable, a fault of the reference; ROADMAP.md "
                "queue C): train it at module level, model(points, train=True)")
        if not isinstance(self.model, _TRAINED):
            raise NotImplementedError(
                f"the port's Trainer trains the plain ViT, RankViT, the ResidualViT family, "
                f"A-ViT, MAE and MoE, not {type(self.model).__name__}")
        if any(_dropout_rates(self.model)):
            raise NotImplementedError(
                f"training with dropout is not ported yet ({DROPOUT_ITEM}): "
                "build the model with dropout=0.0 and attention_dropout=0.0")
        self.device = resolve_device(self.device)
        self.output_format = getattr(self.model, "output_format", None)
        # the fused path, decided here from the model and its shapes, before
        # anything moves (raises outside the kernels' limits)
        self._fused_path = None if sp else self._fused_kind()
        self.model.to(self.device)
        if self.main_criterion is None:
            self.main_criterion = CrossEntropyLoss()
        self.params = live_params(self.model)
        mask = None if self.train_backbone else param_filter_mask(self.params)
        self.torch_optimizer = self.optimizer.build(self.params, param_mask=mask)
        self.tx = GradientTransform(self.torch_optimizer, [p for _, p in tree_leaves(self.params)],
                                    self.clip_grad_norm, self.grad_accumulation)
        self._forward = None
        self._train_kind = None
        self._sp_world = 1
        self._sp_fwd_kwargs = None  # the SP forward's arguments, once the step is built

    # ------------------------------------------------------------ train step

    def _fused_kind(self):
        """'vit' | 'residual' | None: which fused train path applies, under
        the JAX conditions (trainer.py:278-308); a fused path raises where
        the shapes break the kernels' limits (:func:`fused_train_limit`)."""
        kind = self._jax_fused_kind()
        if kind is None:
            return None
        model = self.model
        limit = fused_train_limit(model.hidden_dim, model.num_heads, model.mlp_dim, self.device)
        if limit is not None:
            raise ValueError(f"Trainer(fused={self.fused!r}): the fused {kind} train path's CUDA "
                             f"kernels do not take {limit}; fused=False trains this model on "
                             "the module path")
        return kind

    def _jax_fused_kind(self):
        """The JAX rule alone (trainer.py:278-308), from the model type."""
        model = self.model
        if self.fused in (False, "never"):
            return None
        if self.fused == "auto" and self.device.type != "cuda":
            return None
        if (any(_dropout_rates(model))
                or getattr(model, "noise_layer", None) is not None
                or self.output_format is not None):
            return None
        if isinstance(model, (VisionTransformer, RankVisionTransformer)):
            if self.loss_compose and self.loss_compose.additional_losses:
                return None  # a plain ViT emits no aux for regularizers
            return "vit"
        if not isinstance(model, ResidualVisionTransformer):
            return None  # A-ViT, MoE: the linen step (JAX :302-308)
        layers = model.residual_layers or ["attention+mlp"] * model.num_layers
        if (set(layers) == {"attention+mlp"} and model.gate_type == "sigmoid"
                and not model.add_input and model.add_budget_token):
            return "residual"
        return None

    def _fused_eligible(self) -> bool:
        return self._fused_kind() is not None

    def _build_forward(self):
        """(images, budget vector or None, generator, noise keywords) ->
        (outputs, aux). The noise keywords (``noise_value``, ``noise_rng``)
        are empty for a model without a NoiseBlock, which no fused path
        takes."""
        if (self.sequence_parallel_devices or 0) > 1:
            self._train_kind = "sp"
            return self._build_sp_forward()
        kind = self._fused_path
        if self.remat and kind != "vit":
            raise NotImplementedError(
                "remat=True is a fused plain-ViT train-path knob (per-layer checkpoint in "
                "training/fused.vit_forward_trainable); for other paths trade memory with "
                "grad_accumulation or a smaller batch")
        if kind == "vit":
            self._train_kind = "fused_vit"
            fwd = trainable_forward_fn(self.model, remat=self.remat)
            return lambda x, budget, gen, nkw: (fwd(self.params, x), {})
        if kind == "residual":
            self._train_kind = "fused_residual"
            fwd = residual_forward_fn(self.model)
            return lambda x, bvec, gen, nkw: fwd(self.params, x, bvec)
        self._train_kind = "module"
        return functools.partial(self._module_forward, train=True)

    def _module_forward(self, x, budget, gen, nkw, train: bool):
        """The model's own forward, as the linen step applies it: the
        budget to the families that take one, the generator to those that
        draw (the ResidualViT family's budgets and gumbel gates, the MoE's
        gates, the MAE's shuffle), the noise keywords to a NoiseBlock."""
        model = self.model
        if isinstance(model, ResidualVisionTransformer):
            return model(x, budget=budget, train=train, generator=gen, **nkw)
        if isinstance(model, RankVisionTransformer):
            return model(x, budget=budget, **nkw)
        if isinstance(model, (VisionTransformerMoE, MAEVisionTransformer)):
            return model(x, train=train, generator=gen, **nkw)
        if isinstance(model, AdaptiveVisionTransformer):
            return model(x, train=train, **nkw)
        return model(x, **nkw)

    def _noise_kwargs(self, noise_value, make_generator) -> dict:
        """The NoiseBlock's keywords: none for a model without one (JAX
        ignores ``noise_value`` there); else the value (the 0.0 sentinel
        when None) and the generator ``make_generator()`` returns."""
        if getattr(self.model, "noise_layer", None) is None:
            return {}
        return {"noise_value": 0.0 if noise_value is None else noise_value,
                "noise_rng": make_generator()}

    def _sp_kernels(self, model, s: int) -> str:
        """``parallel_kernels`` resolved: ``"auto"`` takes the tail kernel
        (``"pallas"``) on a CUDA device where the fused path's limits hold
        (:func:`fused_train_limit`), ``"xla"`` otherwise (so always on the
        CPU), decided from the shapes up front.
        JAX's rule (``_train_layer_fusable``, training/fused.py:26: the
        weights and gradient accumulators fit VMEM, TPU only) is a TPU
        layout artefact; both rules pick the tail kernel at ViT-B/16."""
        if self.parallel_kernels != "auto":
            return self.parallel_kernels
        fits = fused_train_limit(model.hidden_dim, model.num_heads, model.mlp_dim,
                                 self.device) is None
        return "pallas" if self.device.type == "cuda" and fits else "xla"

    def _build_sp_forward(self):
        """The SP step's forward (the JAX ``_build_sp_train_step``,
        trainer.py:582-676): the mesh checks, then
        ``sequence_parallel_vit_forward`` with dp x sp where the mesh's data
        axis is > 1, the tail in bf16 on CUDA and fp32 on the CPU (JAX: bf16
        on a TPU, fp32 elsewhere)."""
        model = self.model
        what = "sequence_parallel_devices"
        if isinstance(model, ResidualVisionTransformer):
            raise NotImplementedError(
                f"{what} with a gated ResidualViT (JAX parallel/residual.py:183, fp32 linen "
                "math) is not ported yet: ROADMAP.md port queue A item 9 (parallel and serving)")
        if not isinstance(model, (VisionTransformer, RankVisionTransformer)):
            raise NotImplementedError(
                f"{what} applies to the plain-ViT family (uniform blocks) and gated "
                f"ResidualViT, not {type(model).__name__}")
        if getattr(model, "noise_layer", None) is not None:
            raise NotImplementedError(
                f"{what} training is deterministic: set dropout=0 and no noise_layer")
        if self.loss_compose and self.loss_compose.additional_losses:
            raise NotImplementedError(f"plain ViT emits no aux for regularizers under {what}")
        s = int(self.sequence_parallel_devices)
        data_axis = None
        if self.mesh is not None:
            mesh = self.mesh
            if mesh.shape[MODEL_AXIS] != s:
                raise ValueError(f"mesh 'model' axis has {mesh.shape[MODEL_AXIS]} devices but "
                                 f"{what}={s}")
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device {mesh.device} is not on the Trainer's "
                                 f"device type {self.device.type}")
            if mesh.shape[DATA_AXIS] > 1:
                data_axis = DATA_AXIS  # dp x sp
        else:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world != s:
                raise ValueError(f"{what}={s} needs a default process group of {s} ranks "
                                 f"(torch.distributed.init_process_group), have {world}")
            mesh = make_mesh(1, s, device=self.device)
        if mesh.device != self.device:  # the rank's own card ("cuda" names the current one)
            self.device = mesh.device
            model.to(self.device)
        self._sp_world = mesh.shape[MODEL_AXIS] * mesh.shape[DATA_AXIS]
        self._sp_fwd_kwargs = kw = dict(
            num_heads=model.num_heads, patch_size=model.patch_size, mesh=mesh,
            num_class_tokens=model.num_class_tokens,
            num_registers=getattr(model, "num_registers", 0), ln_eps=model.ln_eps,
            rankvit_layers=tuple(getattr(model, "rankvit_layers", ()) or ()),
            data_axis=data_axis, kernels=self._sp_kernels(model, s),
            compute_dtype=torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        return lambda x, budget, gen, nkw: (
            sequence_parallel_vit_forward(self.params, x, budget=budget, **kw), {})

    def _all_reduce_grads(self) -> None:
        """Every parameter's gradient summed over all ranks: one fp32
        all-reduce of the flattened gradients (gloo pays per call)."""
        params = self.tx.params
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
            offset += p.numel()

    def _loss(self, out, aux, y, budget, x=None):
        """The linen ``loss_fn`` (trainer.py:352-380): the cross-entropy (of
        every early exit, weighted by ``ee_weights``), the EncDec's
        reconstruction loss at ``reconstruction_weight`` (the images ``x``
        against the reconstruction under its mask), plus the regularizers
        against the batch-mean budget. Returns (total, metrics)."""
        if self.output_format == "early_exits":
            ces = torch.stack([self.main_criterion(o, y) for o in out])
            n = len(out)
            w = (torch.tensor(self.ee_weights, dtype=torch.float32) / sum(self.ee_weights)
                 if self.ee_weights else torch.full((n,), 1.0 / n))
            ce = (ces * w.to(ces.device)).sum()
        else:
            ce = self.main_criterion(_main_logits(out, self.output_format), y)
        metrics = {"classification_loss": ce}
        total = ce
        if self.output_format == "logits_recon_mask" and self.reconstruction_weight:
            _, recon, rmask = out
            rec = ((x - recon) ** 2 * rmask).mean()
            metrics["reconstruction_loss"] = rec
            total = total + self.reconstruction_weight * rec
        if self.loss_compose is not None and self.loss_compose.additional_losses:
            b = aux.get("current_budget", budget)
            if isinstance(b, torch.Tensor) and b.dim() > 0:
                b = b.mean()
            losses, reg = self.loss_compose.compute(aux, budget=b)
            metrics.update(losses)
            total = total + reg
        metrics["total_loss"] = total
        return total, metrics

    def train_step(self, x, y, budget=None, noise_value=None, step_idx: int = 0):
        """One forward/backward and update. Returns the metrics as 0-d
        tensors on the device: classification_loss, reconstruction_loss
        (EncDec, a non-zero weight), the regularizers by name, and
        total_loss. ``step_idx`` seeds the step's generator
        (``step_generator``); the fused residual step draws its per-sample
        budgets from it when ``budget`` is None, and broadcasts ``budget``
        otherwise. ``noise_value`` drives a model's NoiseBlock, its draws
        from :func:`noise_generator`."""
        self._check_budget(budget)
        if self._forward is None:
            self._forward = self._build_forward()
        if budget is not None and self._train_kind == "fused_vit":
            raise NotImplementedError(
                "the fused train path treats RankViT as a plain ViT: pass fused='never' to "
                "train with an active ranking budget")
        x, y = self._to_device(x, y)
        gen = step_generator(self.seed, step_idx)
        if self._train_kind == "fused_residual":
            n = x.shape[0]
            budget = (sample_budgets(self.model, n, gen, x.device) if budget is None
                      else torch.full((n,), float(budget), dtype=torch.float32, device=x.device))
        nkw = self._noise_kwargs(noise_value,
                                 lambda: noise_generator(self.seed, step_idx, x.device))
        out, aux = self._forward(x, budget, gen, nkw)
        total, metrics = self._loss(out, aux, y, budget, x)
        if self._train_kind == "sp":
            (total / self._sp_world).backward()
            self._all_reduce_grads()
        else:
            total.backward()
        self.tx()
        return {k: v.detach() for k, v in metrics.items()}

    def _check_budget(self, budget):
        if budget is not None and not isinstance(
                self.model, (ResidualVisionTransformer, RankVisionTransformer)):
            raise NotImplementedError(
                f"a {type(self.model).__name__} takes no token budget (JAX ignores one): "
                "ranking is RankViT's (build_model('rankvit'), ROADMAP.md port queue A item 5)")

    # ------------------------------------------------------------- eval step

    def eval_step(self, x, y, budget=None, noise_value=None):
        """(correct count, mean loss, aux) of the model's fp32 eval forward,
        its main logits (``_main_logits``); a NoiseBlock draws from a
        generator seeded 0 (JAX's eval step: ``rngs={"noise": key(0)}``)."""
        self._check_budget(budget)
        x, y = self._to_device(x, y)
        with torch.no_grad():
            nkw = self._noise_kwargs(noise_value, lambda: default_generator(x.device))
            out, aux = self._module_forward(x, budget, None, nkw, train=False)
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

        steps_per_epoch = len(loader) if hasattr(loader, "__len__") else 0
        interrupted = False
        for i, (x, y) in enumerate(self._device_batches(loader)):
            step_idx = epoch * max(steps_per_epoch, 1) + i
            metrics = self.train_step(x, y, budget=budget, noise_value=noise_value,
                                      step_idx=step_idx)
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
        for x, y in self._device_batches(loader):
            c, loss, _ = self.eval_step(x, y, budget=budget, noise_value=noise_value)
            correct = correct + c
            loss_sum = loss_sum + loss
            total += int(y.shape[0])
            batches += 1
        return int(correct) / max(total, 1), float(loss_sum) / max(batches, 1)

    def _device_batches(self, loader):
        from peekvit_torch.data.loader import prefetch_to_device

        return prefetch_to_device(iter(loader), size=2, device=self.device)

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
