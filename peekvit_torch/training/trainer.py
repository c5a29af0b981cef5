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

- **data-parallel** (``mesh=make_mesh(n, 1)``, one process per rank; the
  JAX step under a data mesh, trainer.py:313-400, :721-809): every rank
  receives the global batch and runs the step's forward (fused or module)
  on its rows (``parallel/data.py``); the outputs and the per-sample aux
  are gathered with autograd, so every rank computes the global batch's
  loss, metrics and regularizers; it backpropagates ``loss / n`` and the
  gradients are summed in one fp32 all-reduce over the data column, so
  clipping, ``grad_accumulation`` and the update see the global gradient
  and every rank ends the step with the same parameters. Per-sample draws
  (budgets, dropout masks, gumbel gates, NoiseBlock normals) are made
  over the global batch's shape and each rank keeps its rows, and the
  ResidualViT budget token's whole-batch mean (the A-ViT's mean halting
  score) is averaged over the data column (``ops/global_batch.py``): an
  n-rank step is the single-device step of the same seed on the same
  global batch, up to the order of the sums. The data axis must divide
  the batch (JAX's message). ``zero_sharded_optimizer=True`` keeps each
  rank's 1/n share of the optimizer state (``training/zero.py``), under
  SP too (over the SP mesh's data axis). A mesh with a model axis > 1
  takes ``sequence_parallel_devices`` or ``tensor_parallel``; with
  neither, the module step runs replicated over the model axis and the
  fused path raises (JAX's words). The eval step runs the whole batch on
  every rank.
- **FSDP** (``fsdp_sharded_params=True``, a mesh; JAX trainer.py:227-262):
  the module step (``fused`` coerced off) with every divisible leaf held
  as this rank's slice over the data column and gathered whole in front
  of the forward, the optimizer over the slices (``training/fsdp.py``).
- **tensor parallel** (``tensor_parallel=True``, a mesh whose model axis
  is >= 2; JAX trainer.py:206-225): the module step (``fused`` coerced
  off) on Megatron forms of the attention, MLP and MoE expert sublayers
  that hold this rank's slices by JAX's ``param_spec``
  (``parallel/tensor.py``); the data axis still splits the batch.

Under FSDP and tensor parallelism ``Trainer.params`` is this rank's
share (what its optimizer steps: the slices and the whole leaves), and the
model is marked sharded (``models.adapters.mark_sharded``): reading or
loading its parameters directly raises. :meth:`Trainer.gathered_params`,
:meth:`Trainer.full_state_dict` (what ``utils/checkpoint.save_state(...,
state_dict=)`` writes) and :meth:`Trainer.eval_step` see whole leaves in
JAX's tree grammar (collectives: every rank of the group calls them),
:meth:`Trainer.load_full_state_dict` loads whole leaves into the shares,
and the optimizer state is saved per rank.

Random numbers (the budgets drawn when no ``budget=`` is given, the
gumbel gates' noise, the MAE's shuffle, the dropout masks) come from a
``torch.Generator`` on the batch's device seeded, for each step, with
``(seed << 32) | step_idx`` (both taken modulo 2^32): one stream per step
as the JAX step's ``fold_in(key(seed), step_idx)``, though not JAX's
bits. The budgets are drawn first, then each gate and dropout mask in
the forward's order. The NoiseBlock's draws
(``train_step(noise_value=)``, for a model built with a noise layer) come
from :func:`noise_generator`, a second generator of the step's seed on
the batch's device, as JAX's step splits a ``noise`` key off the same
fold; ``eval_step`` draws from a generator seeded 0, JAX's ``key(0)``.
``train_epoch`` passes ``step_idx = epoch * steps_per_epoch + i`` as the
JAX trainer does.

- **QAT** (``qat=True`` / ``"dynamic"`` / ``"static"`` with ``qat_caps``
  and optionally ``qat_smoothing``): the module path (``fused`` coerced
  off), every train and eval forward inside ``ops/fake_quant.fake_quant``
  (the JAX step's trace-time switch, trainer.py:340-350, :856-866). Not
  with SP, the pipeline or ``remat`` (a checkpointed backward would rerun
  the forward unquantized).

Dropout (``dropout`` / ``attention_dropout`` > 0, the decoder's rates)
trains on the module path, as JAX's step takes linen at a nonzero rate
(trainer.py:284-288): ``fused=True`` with dropout raises, naming it, and
SP refuses dropout with JAX's words.

- **Pipeline parallelism** (``pipeline_stages=S``, ``pipeline_microbatches=M``,
  default S): GPipe over the ranks of a ``(data, stage)`` mesh
  (``parallel.make_mesh(n, S, axis=STAGE_AXIS)``), or of a default
  process group of S ranks without one (``parallel/pipeline.py``): every
  rank holds the whole model and optimizer, as JAX's replicated tree, and
  runs its stage's layers; the gradient is summed over every rank as
  under SP. ``parallel_kernels`` picks each stage's layer math as under SP
  (``"pallas"``: the trainable attention kernels, sites 18-19, in bf16).
  A gated ResidualViT in the shipped-config mode trains pipelined or
  sequence-parallel through ``parallel/residual.py``'s fp32 forwards, its
  masks reaching the regularizers; JAX's checks and words throughout
  (trainer.py:401-580).

A PCT or
RankPCT is refused: the JAX ``Trainer`` cannot train one (its step holds
the BatchNorm statistics immutable); train it at module level. ``train_epoch`` and ``validate``
take their batches through ``data.loader.prefetch_to_device`` (two in
flight), as the JAX trainer's ``_device_batches``.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from peekvit_torch.models.adapters import _nest, live_params, mark_sharded, tree_leaves
from peekvit_torch.models.adavit import AdaptiveVisionTransformer
from peekvit_torch.models.maevit import MAEVisionTransformer
from peekvit_torch.models.moevit import VisionTransformerMoE
from peekvit_torch.models.pct import PointCloudTransformer
from peekvit_torch.models.rankpct import RankPointCloudTransformer
from peekvit_torch.models.rankvit import RankVisionTransformer
from peekvit_torch.models.registry import resolve_device
from peekvit_torch.models.residualvit import ResidualVisionTransformer
from peekvit_torch.models.vit import VisionTransformer
from peekvit_torch.ops.cuda.fused_attention import (
    GEMM_K_MULTIPLE,
    GEMM_N_MULTIPLE,
    SOFTMAX_HEAD_DIMS,
)
from peekvit_torch.ops.cuda.fused_attention_vjp import LN_BWD_MAX_WIDTH
from peekvit_torch.ops.fake_quant import fake_quant
from peekvit_torch.ops.noise import default_generator
from peekvit_torch.parallel.data import check_divisible, data_rows, data_slice, gather_tree
from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, STAGE_AXIS, make_mesh
from peekvit_torch.parallel.pipeline import bubble_fraction, pipelined_vit_forward
from peekvit_torch.parallel.residual import (
    pipelined_residualvit_forward,
    sequence_parallel_residualvit_forward,
)
from peekvit_torch.parallel.sequence import sequence_parallel_vit_forward
from peekvit_torch.parallel.tensor import tensor_parallel_params
from peekvit_torch.training.fsdp import fsdp_params
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
from peekvit_torch.training.zero import ZeroShardedOptimizer

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


def step_generator(seed: int, step_idx: int, device="cpu") -> torch.Generator:
    """The generator of one train step, on ``device`` (the Trainer's: the
    batch's): seeded with ``(seed << 32) | step_idx``, each modulo 2^32."""
    return torch.Generator(device=torch.device(device)).manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(step_idx) & 0xFFFFFFFF))


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


# aux entries that hold the whole batch's values already under data
# parallelism (no leading batch axis): the MAE's shared permutation, the
# A-ViT's per-layer mean halting score (averaged over the data column)
_WHOLE_BATCH_AUX = ("forward_perm", "backward_perm", "halting_score_layer")


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
    # quantization-aware training (ops/fake_quant.py): the module forward's
    # qkv / out-proj / fc1 / fc2 matmuls see int8-grid fake-quantized
    # operands with straight-through gradients, in the train and the eval
    # step. True / "dynamic": the dynamic engine's grid; "static": the
    # static-caps grid of qat_caps (one ((attn_ln, attn_out), (mlp_ln,
    # mlp_h)) per encoder layer), optionally with the SmoothQuant vectors
    # qat_smoothing (inference.collect_qat_calibration). Takes the module
    # path: ``fused`` is coerced off.
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
        pipeline = (self.pipeline_stages or 0) > 1
        self._check_placement(sp)
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
        if self.qat:
            self._check_qat(sp)
        self.device = resolve_device(self.device)
        self._dp = self._data_mesh(sp or pipeline)
        self.output_format = getattr(self.model, "output_format", None)
        # the fused path, decided here from the model and its shapes, before
        # anything moves (raises outside the kernels' limits)
        self._fused_path = None if sp or pipeline else self._fused_kind()
        self.model.to(self.device)
        if self.main_criterion is None:
            self.main_criterion = CrossEntropyLoss()
        self._shards = None  # FSDP / tensor parallel: training/fsdp.ShardedParams
        if self.tensor_parallel:
            self._shards = tensor_parallel_params(self.model, self._dp)
        elif self.fsdp_sharded_params:
            self._shards = fsdp_params(self.model, self._dp)
        # what this rank's optimizer steps: the whole tree, or its share
        self.params = (live_params(self.model) if self._shards is None
                       else self._shards.local_tree())
        mask = None if self.train_backbone else param_filter_mask(self.params)
        if self.zero_sharded_optimizer and not self.fsdp_sharded_params:
            # FSDP's optimizer runs over its slices already
            self.torch_optimizer = ZeroShardedOptimizer(self.optimizer, self.params,
                                                        self.mesh if sp or pipeline
                                                        else self._dp,
                                                        param_mask=mask)
        else:
            self.torch_optimizer = self.optimizer.build(self.params, param_mask=mask)
        self.tx = GradientTransform(self.torch_optimizer,
                                    [p for _, p in tree_leaves(self.params)],
                                    self.clip_grad_norm, self.grad_accumulation,
                                    sq_norm=None if self._shards is None else self._shards.sq_norm)
        if self._shards is not None:
            mark_sharded(self.model, "tensor_parallel" if self.tensor_parallel
                         else "fsdp_sharded_params")
        self._forward = None
        self._train_kind = None
        self._parallel_world = 1  # SP / pipeline: the ranks the loss is split over
        self._sp_fwd_kwargs = None  # the SP forward's arguments, once the step is built
        self._pipeline_fwd_kwargs = None  # the pipeline forward's, likewise

    def _check_placement(self, sp: bool) -> None:
        """JAX's checks of the parameter placements (trainer.py:206-240):
        tensor parallelism needs a model axis >= 2 and excludes FSDP, the
        pipeline and SP; FSDP needs a mesh and excludes the pipeline and
        SP; both take the module step (``fused`` coerced off)."""
        pipeline = (self.pipeline_stages or 0) > 1
        if self.tensor_parallel:
            if self.mesh is None or self.mesh.shape.get(MODEL_AXIS, 1) < 2:
                raise ValueError(f"tensor_parallel=True requires mesh= with a '{MODEL_AXIS}' axis "
                                 "of size >= 2 (parallel.make_mesh(n_model=...))")
            if self.fsdp_sharded_params:
                raise NotImplementedError("tensor_parallel and fsdp_sharded_params both own the "
                                          "param placement; pick one")
            if pipeline or sp:
                raise NotImplementedError("tensor_parallel composes with the dp linen step; "
                                          "pipeline/sequence-parallel modes own their placement")
            self.fused = False
        if self.fsdp_sharded_params:
            if self.mesh is None:
                raise ValueError("fsdp_sharded_params requires mesh= (params shard over the "
                                 "mesh's data axis)")
            if pipeline or sp:
                raise NotImplementedError(
                    "fsdp_sharded_params composes with the dp linen step; pipeline/sequence-"
                    "parallel modes own their param placement")
            self.fused = False

    def _data_mesh(self, own_mesh: bool):
        """The data-parallel mesh (``mesh=`` without SP or the pipeline;
        JAX trainer.py:258-275): ZeRO-1 needs a mesh. None without one, and
        under SP and the pipeline (``own_mesh``: their steps take the mesh
        themselves). The Trainer moves to the mesh's device (the rank's own
        card)."""
        mesh = self.mesh
        if self.zero_sharded_optimizer and mesh is None:
            raise ValueError("zero_sharded_optimizer requires mesh= (the optimizer state shards "
                             "over the mesh's data axis)")
        if mesh is None:
            return None
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's device {mesh.device} is not on the Trainer's device "
                             f"type {self.device.type}")
        self.device = mesh.device
        return None if own_mesh else mesh

    def _check_qat(self, sp: bool) -> None:
        """JAX's QAT checks (trainer.py:180-205), then ``fused`` off: the
        fake-quant hooks live in the module ops, not in the fused kernels."""
        if self.qat not in (True, "dynamic", "static"):
            raise ValueError(f"qat={self.qat!r}: expected False, True/'dynamic', or 'static'")
        if self.qat == "static" and self.qat_caps is None:
            raise ValueError("qat='static' requires qat_caps= (the per-layer static "
                             "calibration tuple from inference.collect_activation_caps)")
        if (self.qat_smoothing is not None and self.qat_caps is not None
                and len(self.qat_smoothing) != len(self.qat_caps)):
            raise ValueError(
                f"qat_smoothing covers {len(self.qat_smoothing)} layers but qat_caps "
                f"{len(self.qat_caps)}: calibrate both together "
                "(inference.collect_qat_calibration)")
        if sp or (self.pipeline_stages or 0) > 1:
            raise NotImplementedError("qat=True runs the module step; the pipeline/"
                                      "sequence-parallel stage math carries no fake-quant hooks")
        if self.tensor_parallel:
            raise NotImplementedError(
                "Trainer(qat=..., tensor_parallel=True) is not ported yet (a fake-quant scale "
                "needs the whole leaf's absmax): ROADMAP.md port queue A item 9 (parallel and "
                "serving)")
        if self.remat:
            raise NotImplementedError(
                "qat=True refuses remat=True: a checkpointed backward reruns the forward "
                "outside the fake_quant block, unquantized")
        self.fused = False

    def _fake_quant(self):
        """The fake-quant block every forward runs in (a no-op without QAT):
        JAX's ``fake_quant(bool(qat), caps if qat == "static", smoothing)``."""
        return fake_quant(bool(self.qat), self.qat_caps if self.qat == "static" else None,
                          self.qat_smoothing)

    # ------------------------------------------------------------ train step

    def _fused_kind(self):
        """'vit' | 'residual' | None: which fused train path applies, under
        the JAX conditions (trainer.py:278-308); a fused path raises where
        the shapes break the kernels' limits (:func:`fused_train_limit`)."""
        if self.fused is True and any(_dropout_rates(self.model)):
            raise ValueError(
                "Trainer(fused=True): the fused train paths have no dropout; a model with a "
                "nonzero dropout rate trains on the module path (fused=False or 'auto'), as "
                "JAX's step takes linen")
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
        if (self.pipeline_stages or 0) > 1:
            self._train_kind = "pipeline"
            return self._build_pipeline_forward()
        if (self.sequence_parallel_devices or 0) > 1:
            self._train_kind = "sp"
            return self._build_sp_forward()
        kind = self._fused_path
        if kind is not None and self._dp is not None and self._dp.shape[MODEL_AXIS] > 1:
            # JAX's refusal (trainer.py:702-707)
            raise NotImplementedError(
                "the fused train path shards over 'data' only; for a 'model' axis use "
                "sequence_parallel_devices/pipeline_stages or fused='never'")
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
        budget to the families that take one, the generator to every draw
        (the ResidualViT family's budgets and gumbel gates, the MoE's
        gates, the MAE's shuffle, the dropout masks), the noise keywords
        to a NoiseBlock."""
        model = self.model
        if isinstance(model, ResidualVisionTransformer):
            return model(x, budget=budget, train=train, generator=gen, **nkw)
        if isinstance(model, RankVisionTransformer):
            return model(x, budget=budget, train=train, generator=gen, **nkw)
        return model(x, train=train, generator=gen, **nkw)

    def _noise_kwargs(self, noise_value, make_generator) -> dict:
        """The NoiseBlock's keywords: none for a model without one (JAX
        ignores ``noise_value`` there); else the value (the 0.0 sentinel
        when None) and the generator ``make_generator()`` returns."""
        if getattr(self.model, "noise_layer", None) is None:
            return {}
        return {"noise_value": 0.0 if noise_value is None else noise_value,
                "noise_rng": make_generator()}

    def _sp_kernels(self, model, s: int) -> str:
        """``parallel_kernels`` resolved (SP and the pipeline): ``"auto"``
        takes the kernels (``"pallas"``: SP's tail, the pipeline's trainable
        attention block) on a CUDA device where the fused path's limits hold
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

    def _check_parallel_model(self, what: str):
        """JAX's ``_check_deterministic_parallel_model`` (trainer.py:
        509-539), in its words: a gated ResidualViT in the shipped-config
        mode, or the plain-ViT family; no dropout and no NoiseBlock; no
        regularizers on a plain ViT (it emits no aux)."""
        model = self.model
        name = type(model).__name__
        if name == "ResidualVisionTransformer":
            layers = model.residual_layers or ["attention+mlp"] * model.num_layers
            if (set(layers) != {"attention+mlp"} or model.gate_type != "sigmoid"
                    or model.add_input or model.add_budget_token != "learnable"):
                raise NotImplementedError(
                    f"{what} supports ResidualViT in the shipped-config mode: sigmoid gates, "
                    "attention+mlp skip, budget_token='learnable', add_input=False")
        elif name not in ("VisionTransformer", "RankVisionTransformer"):
            raise NotImplementedError(
                f"{what} applies to the plain-ViT family (uniform blocks) and gated "
                f"ResidualViT, not {name}")
        if any(_dropout_rates(model)) or getattr(model, "noise_layer", None) is not None:
            raise NotImplementedError(
                f"{what} training is deterministic: set dropout=0 and no noise_layer")
        if (name != "ResidualVisionTransformer" and self.loss_compose
                and self.loss_compose.additional_losses):
            raise NotImplementedError(f"plain ViT emits no aux for regularizers under {what}")
        return model

    def _parallel_mesh(self, what: str, s: int, axis: str):
        """The SP / pipeline mesh: ``mesh=`` where it has ``axis`` (of size
        ``s``, else JAX's ValueError naming the axis; dp x sp / dp x pp where
        its data axis is > 1), else a (1, s) mesh over a default process
        group of ``s`` ranks. Returns (mesh, data_axis or None); the
        Trainer and its model move to the mesh's device."""
        data_axis = None
        if self.mesh is not None and axis in self.mesh.shape:
            mesh = self.mesh
            if mesh.shape[axis] != s:
                raise ValueError(f"mesh '{axis}' axis has {mesh.shape[axis]} devices but "
                                 f"{what}={s}")
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's device {mesh.device} is not on the Trainer's "
                                 f"device type {self.device.type}")
            if mesh.shape[DATA_AXIS] > 1:
                data_axis = DATA_AXIS
        else:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world != s:
                raise ValueError(f"{what}={s} needs a default process group of {s} ranks "
                                 f"(torch.distributed.init_process_group), have {world}")
            mesh = make_mesh(1, s, device=self.device, axis=axis)
        if mesh.device != self.device:  # the rank's own card ("cuda" names the current one)
            self.device = mesh.device
            self.model.to(self.device)
        self._parallel_world = mesh.shape[axis] * mesh.shape[DATA_AXIS]
        return mesh, data_axis

    def _residual_parallel_forward(self, fwd, mesh, data_axis):
        """The gated ResidualViT's pipeline / SP step forward (JAX
        ``_build_residual_parallel_step``, trainer.py:541-580): ``fwd`` of
        ``parallel/residual.py`` with the model's gate settings; the step
        passes the budget vector (``train_step``)."""
        model = self.model
        self._train_kind += "_residual"
        kw = dict(mesh=mesh, num_heads=model.num_heads, patch_size=model.patch_size,
                  num_class_tokens=model.num_class_tokens,
                  num_registers=getattr(model, "num_registers", 0), gate_temp=model.gate_temp,
                  gate_bias=model.gate_bias, budget_token=model.add_budget_token,
                  data_axis=data_axis)
        return kw, lambda x, bvec, gen, nkw: fwd(self.params, x, bvec, **kw)

    def _build_pipeline_forward(self):
        """The pipeline step's forward (JAX ``_build_pipeline_train_step``,
        trainer.py:401-496): the checks in JAX's order and words, then
        ``pipelined_vit_forward`` (``parallel_kernels`` resolved as under
        SP) or, for a gated ResidualViT, ``pipelined_residualvit_forward``;
        dp x pp where the mesh's data axis is > 1."""
        what = "pipeline_stages"
        model = self._check_parallel_model(what)
        s = int(self.pipeline_stages)
        if model.num_layers % s:
            raise ValueError(f"num_layers={model.num_layers} not divisible into {s} pipeline "
                             "stages")
        mesh, data_axis = self._parallel_mesh(what, s, STAGE_AXIS)
        m = int(self.pipeline_microbatches) or s
        if m < 2 * s:
            warnings.warn(
                f"pipeline_microbatches={m} with pipeline_stages={s} idles "
                f"{bubble_fraction(s, m):.0%} of every stage (GPipe bubble (S-1)/(M+S-1)); set "
                f"pipeline_microbatches >= {2 * s} to keep it under ~33%", stacklevel=3)
        if isinstance(model, ResidualVisionTransformer):
            kw, fwd = self._residual_parallel_forward(
                functools.partial(pipelined_residualvit_forward, num_microbatches=m), mesh,
                data_axis)
            self._pipeline_fwd_kwargs = dict(kw, num_microbatches=m)
            return fwd
        self._pipeline_fwd_kwargs = kw = dict(
            mesh=mesh, num_microbatches=m, num_heads=model.num_heads,
            patch_size=model.patch_size, num_class_tokens=model.num_class_tokens,
            num_registers=getattr(model, "num_registers", 0), ln_eps=model.ln_eps,
            data_axis=data_axis, kernels=self._sp_kernels(model, s),
            compute_dtype=torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        return lambda x, budget, gen, nkw: (pipelined_vit_forward(self.params, x, **kw), {})

    def _build_sp_forward(self):
        """The SP step's forward (the JAX ``_build_sp_train_step``,
        trainer.py:582-676): the checks, then ``sequence_parallel_vit_forward``
        with dp x sp where the mesh's data axis is > 1, the tail in bf16 on
        CUDA and fp32 on the CPU (JAX: bf16 on a TPU, fp32 elsewhere); for a
        gated ResidualViT, ``sequence_parallel_residualvit_forward``."""
        what = "sequence_parallel_devices"
        model = self._check_parallel_model(what)
        s = int(self.sequence_parallel_devices)
        mesh, data_axis = self._parallel_mesh(what, s, MODEL_AXIS)
        if isinstance(model, ResidualVisionTransformer):
            kw, fwd = self._residual_parallel_forward(sequence_parallel_residualvit_forward,
                                                      mesh, data_axis)
            self._sp_fwd_kwargs = kw
            return fwd
        self._sp_fwd_kwargs = kw = dict(
            num_heads=model.num_heads, patch_size=model.patch_size, mesh=mesh,
            num_class_tokens=model.num_class_tokens,
            num_registers=getattr(model, "num_registers", 0), ln_eps=model.ln_eps,
            rankvit_layers=tuple(getattr(model, "rankvit_layers", ()) or ()),
            data_axis=data_axis, kernels=self._sp_kernels(model, s),
            compute_dtype=torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        return lambda x, budget, gen, nkw: (
            sequence_parallel_vit_forward(self.params, x, budget=budget, **kw), {})

    def _dp_forward(self, x, budget, gen, nkw):
        """The step's forward under data parallelism: this rank's rows of
        the global batch (and of a per-sample budget vector) inside
        ``parallel.data.data_slice``, then the outputs and the per-sample
        aux gathered over the data column with autograd."""
        mesh = self._dp
        rows = data_rows(x, mesh)
        if isinstance(budget, torch.Tensor) and budget.dim():
            budget = data_rows(budget, mesh)
        with data_slice(mesh):
            out, aux = self._forward(rows, budget, gen, nkw)
        n = rows.shape[0]
        return gather_tree(out, mesh, n), gather_tree(aux, mesh, n, keep=_WHOLE_BATCH_AUX)

    def _all_reduce_grads(self, group=None, params=None) -> None:
        """Every gradient of ``params`` (the default: the optimizer's)
        summed over the ranks of ``group`` (the default: all): one fp32
        all-reduce of the flattened gradients (gloo pays per call)."""
        params = self.tx.params if params is None else params
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .reshape(-1).float() for p in params])
        dist.all_reduce(flat, group=group)
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
        (``step_generator``, on the batch's device); the fused residual step
        draws its per-sample
        budgets from it when ``budget`` is None, and broadcasts ``budget``
        otherwise. ``noise_value`` drives a model's NoiseBlock, its draws
        from :func:`noise_generator`."""
        self._check_budget(budget)
        if self._forward is None:
            self._forward = self._build_forward()
        if (budget is not None and self._train_kind == "pipeline"
                and getattr(self.model, "rankvit_layers", None)):
            # JAX's refusal (trainer.py:815-823)
            raise NotImplementedError(
                "pipeline_stages training has no RankViT ranking path: a train budget would be "
                "silently ignored (use sequence_parallel_devices or the single-device step)")
        if budget is not None and self._train_kind == "fused_vit":
            raise NotImplementedError(
                "the fused train path treats RankViT as a plain ViT: pass fused='never' to "
                "train with an active ranking budget")
        x, y = self._to_device(x, y)
        dp = self._dp
        if dp is not None:
            check_divisible(x.shape[0], dp, "the dp-fused train step"
                            if self._train_kind.startswith("fused") else "the data-parallel "
                            "train step")
        gen = step_generator(self.seed, step_idx, x.device)
        if self._train_kind in ("fused_residual", "pipeline_residual", "sp_residual"):
            n = x.shape[0]
            budget = (sample_budgets(self.model, n, gen, x.device) if budget is None
                      else torch.full((n,), float(budget), dtype=torch.float32, device=x.device))
        nkw = self._noise_kwargs(noise_value,
                                 lambda: noise_generator(self.seed, step_idx, x.device))
        shards = self._shards
        if shards is not None:
            shards.gather()
        try:
            with self._fake_quant():
                out, aux = (self._forward(x, budget, gen, nkw) if dp is None
                            else self._dp_forward(x, budget, gen, nkw))
            total, metrics = self._loss(out, aux, y, budget, x)
            if self._train_kind.startswith(("sp", "pipeline")):
                (total / self._parallel_world).backward()
                self._all_reduce_grads()
            elif dp is not None and dp.shape[DATA_AXIS] > 1:
                (total / dp.shape[DATA_AXIS]).backward()
                self._all_reduce_grads(dp.data_group,
                                       None if shards is None else shards.module_params())
            else:
                total.backward()
            if shards is not None:
                shards.collect_grads()
            self.tx()
        finally:
            if shards is not None:
                shards.free()
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
        its main logits (``_main_logits``), fake-quantized under QAT; a
        NoiseBlock draws from a generator seeded 0 (JAX's eval step:
        ``rngs={"noise": key(0)}``)."""
        self._check_budget(budget)
        x, y = self._to_device(x, y)
        shards = self._shards
        if shards is not None:  # whole leaves (FSDP; the leaves TP gathers)
            shards.gather()
        try:
            with torch.no_grad(), self._fake_quant():
                nkw = self._noise_kwargs(noise_value, lambda: default_generator(x.device))
                out, aux = self._module_forward(x, budget, None, nkw, train=False)
                logits = _main_logits(out, self.output_format)
                loss = self.main_criterion(logits, y)
                correct = (logits.argmax(-1) == y).sum()
        finally:
            if shards is not None:
                shards.free()
        return correct, loss, aux

    def gathered_params(self) -> dict:
        """The model's parameters as whole leaves in JAX's tree grammar,
        detached: under FSDP and tensor parallelism gathered from every
        rank's share (a collective over the sharding group)."""
        return _nest(self.full_state_dict().items())

    def full_state_dict(self) -> dict:
        """:meth:`gathered_params` keyed as the single-device model's
        ``state_dict`` (what ``utils/checkpoint.save_state(...,
        state_dict=)`` writes)."""
        if self._shards is None:
            return {k: v.detach() for k, v in self.model.state_dict().items()}
        return self._shards.full_state_dict()

    def load_full_state_dict(self, state: dict) -> None:
        """Load whole leaves (a single-device model's ``state_dict``) into
        the model, under FSDP and tensor parallelism into this rank's
        share."""
        if self._shards is None:
            self.model.load_state_dict(state)
        else:
            self._shards.load_full_state_dict(state)

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
