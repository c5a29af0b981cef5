"""Pipeline parallelism: GPipe microbatching over the mesh's stage axis
(counterpart of peekvit_tpu/parallel/pipeline.py).

JAX runs the schedule as one ``shard_map`` program: a ``lax.scan`` over
``M + S - 1`` ticks in which stage ``s`` processes microbatch ``t - s`` and
hands its activation to stage ``s + 1`` with ``ppermute``; ``jax.grad``
transposes it into the GPipe backward. Here each rank is one process and
one stage (``parallel/mesh.py``, ``make_mesh(n_data, S, axis=STAGE_AXIS)``),
and the schedule is one ``torch.autograd.Function`` whose backward runs the
transposed schedule itself, so that every rank makes the same collective calls
in the same order (an autograd graph that differs from rank to rank would
not):

- **Forward.** At tick ``t`` the rank runs its stage on microbatch
  ``t - s`` where that is in range (stage 0 reads the input queue, a later
  stage what the previous one handed on), under autograd on detached
  leaves, and keeps that tick's graph. It writes the result into slot
  ``s`` of a zero-filled (S, mb, ...) buffer and the stage group
  all-reduces it: adding zeros is exact, so every rank holds the same bits
  of every stage's output. Slot ``s - 1`` is the next tick's input, and
  slot ``S - 1`` is the last stage's output: every rank reads the
  pipeline's outputs from it, in microbatch order. Gloo's ``send`` /
  ``recv`` and ``all_gather`` take no CUDA tensors and its ``all_reduce``
  does, so one all-reduce of S slots a tick (S times the bytes of a send)
  is both the handoff and the output broadcast. A bubble tick runs
  nothing and writes zeros.
- **Aux.** Each stage's aux leaves (batch-leading, as JAX requires) are
  stacked (S, M) + leaf.shape, stage-major and microbatch-minor, with one
  zero-filled all-reduce after the loop.
- **Backward.** The aux cotangent is all-reduced in fp32 and the rank keeps
  its stage's slot; then, from the last tick to the first, every rank adds
  its cotangent of the outputs into slot ``S - 1`` and the cotangent of its
  next tick's input into slot ``s - 1``, the stage group all-reduces the
  buffer in fp32, and the rank backpropagates its slot through that tick's
  graph: the transpose of the forward, tick by tick.

Gradients follow the port's SP step (``parallel/sequence.py``): every rank
computes the whole loss from the outputs it holds; a caller backpropagates
``loss / world size`` and sums the parameter gradients over every rank
(``Trainer._all_reduce_grads``): each stage's layers get their gradient on
their own rank, the replicated embed and head theirs on every rank.

``data_axis`` (dp x pp): as JAX's ``in_specs=(P(axis), P(None,
data_axis))``, the within-microbatch batch is split over the data axis, so
each data row of the mesh runs the same pipeline on its part of every
microbatch; outputs and aux come back over the data column in JAX's global
row order.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

from peekvit_torch.inference import _classify, _embed, _layer_ids, _layer_norm
from peekvit_torch.models.adapters import _flatten, _nest, tree_map
from peekvit_torch.ops.attention import attention_core
from peekvit_torch.ops.cuda.fused_attention_vjp import attention_block_trainable
from peekvit_torch.parallel.mesh import STAGE_AXIS
from peekvit_torch.parallel.sequence import _axis, _gather_tokens, _ln

__all__ = ["STAGE_AXIS", "bubble_fraction", "pipeline_forward", "pipeline_forward_aux",
           "pipelined_vit_forward", "stack_stage_params", "stack_vit_stage_params",
           "vit_block_forward"]


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """The GPipe bubble of this schedule: ``M + S - 1`` ticks of which each
    stage works ``M``, so it idles ``(S - 1) / (M + S - 1)`` of them in each
    direction (JAX ``bubble_fraction``). The Trainer warns when M < 2S."""
    s, m = int(num_stages), int(num_microbatches)
    if s < 1 or m < 1:
        raise ValueError(f"need num_stages>=1, num_microbatches>=1; got {s}, {m}")
    return (s - 1) / (m + s - 1)


def stack_stage_params(per_stage_params):
    """[stage0 tree, stage1 tree, ...] -> one tree whose leaves have a
    leading stage axis (JAX ``stack_stage_params``)."""
    flats = [_flatten(p) for p in per_stage_params]
    return _nest((k, torch.stack([f[k] for f in flats])) for k in flats[0])


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(x, group=group)
    return x


def _aux_items(aux) -> list:
    """(key, leaf) pairs of an aux tree: none for None, one keyed "" for a
    bare tensor."""
    if aux is None:
        return []
    if isinstance(aux, torch.Tensor):
        return [("", aux)]
    return list(_flatten(aux).items())


def _check_stage(inp, act_out, aux_items) -> None:
    """JAX's trace-time checks: the stage keeps the activation's shape, and
    every aux leaf leads with the microbatch's batch."""
    if act_out.shape != inp.shape:
        raise ValueError(f"pipeline stages must preserve activation shape: {tuple(inp.shape)} "
                         f"-> {tuple(act_out.shape)}")
    for _, leaf in aux_items:
        if leaf.shape[:1] != inp.shape[:1]:
            raise ValueError(f"pipeline aux leaves must be batch-leading (the within-microbatch "
                             f"batch, here {inp.shape[0]}); got leaf shape {tuple(leaf.shape)}")


class _Pipeline(torch.autograd.Function):
    """The schedule over this rank's stage (module docstring). Inputs: the
    plan (a dict, filled with the aux layout), the input queue xs (M, mb,
    ...) and this stage's parameter leaves; outputs: the last stage's
    outputs (M, mb, ...) and each aux leaf stacked (S, M) + leaf.shape."""

    @staticmethod
    def forward(ctx, plan, xs, *leaves):
        stage_fn, names, group = plan["stage_fn"], plan["names"], plan["group"]
        s_total, s_idx, m = plan["stages"], plan["index"], xs.shape[0]
        grad = plan["grad"]
        ticks = m + s_total - 1
        p_in = [p.detach().requires_grad_(grad and p.requires_grad) for p in leaves]
        params = _nest(zip(names, p_in))
        outs = torch.empty_like(xs)
        saved, aux_rows = [None] * ticks, [None] * m
        act_in = None
        for t in range(ticks):
            mi = t - s_idx
            buf = xs.new_zeros((s_total,) + tuple(xs.shape[1:]))
            if 0 <= mi < m:
                inp = (xs[mi] if s_idx == 0 else act_in).detach().requires_grad_(grad)
                with torch.enable_grad() if grad else torch.no_grad():
                    act_out, aux = stage_fn(params, inp)
                aux_flat = _aux_items(aux)
                _check_stage(inp, act_out, aux_flat)
                if grad:
                    saved[t] = (inp, act_out, [v for _, v in aux_flat])
                aux_rows[mi] = aux_flat
                buf[s_idx].copy_(act_out.detach())
            _all_reduce(buf, group)
            act_in = buf[s_idx - 1] if s_idx else None
            if t >= s_total - 1:
                outs[t - (s_total - 1)].copy_(buf[s_total - 1])
        # every stage made M rows of one layout; stack them (S, M) + leaf.shape
        keys = [k for k, _ in aux_rows[0]]
        plan["aux_keys"] = keys
        aux_out = []
        if keys:
            local = [torch.stack([row[i][1].detach() for row in aux_rows])
                     for i in range(len(keys))]
            flat = torch.cat([a.reshape(-1).float() for a in local])
            stacked = flat.new_zeros((s_total, flat.numel()))
            stacked[s_idx] = flat
            _all_reduce(stacked, group)
            offset = 0
            for a in local:
                aux_out.append(stacked[:, offset:offset + a.numel()].reshape(
                    (s_total,) + tuple(a.shape)).to(a.dtype))
                offset += a.numel()
            ctx.aux_shapes = [a.shape for a in local]
        ctx.plan, ctx.saved, ctx.p_in = plan, saved, p_in
        ctx.xs_meta = (xs.shape, xs.dtype)
        return (outs, *aux_out)

    @staticmethod
    def backward(ctx, g_out, *g_aux):
        plan, saved, p_in = ctx.plan, ctx.saved, ctx.p_in
        group, s_total, s_idx = plan["group"], plan["stages"], plan["index"]
        m = g_out.shape[0]
        ticks = m + s_total - 1
        # the aux cotangent summed over the stage group; this stage's slot
        mine = []
        if g_aux:
            flat = _all_reduce(torch.cat([g.reshape(s_total, -1).float() for g in g_aux], 1)
                               .contiguous(), group)[s_idx]
            offset = 0
            for shape in ctx.aux_shapes:
                n = shape.numel()
                mine.append(flat[offset:offset + n].reshape(shape))
                offset += n
        g_params = [None] * len(p_in)
        g_xs = torch.zeros(ctx.xs_meta[0], dtype=ctx.xs_meta[1], device=g_out.device)
        pending = None  # the cotangent of this stage's input at the next tick
        for t in reversed(range(ticks)):
            buf = g_out.new_zeros((s_total,) + tuple(g_out.shape[1:]), dtype=torch.float32)
            if t >= s_total - 1:
                buf[s_total - 1] += g_out[t - (s_total - 1)].float()
            if pending is not None:
                buf[s_idx - 1] += pending.float()
            _all_reduce(buf, group)
            pending = None
            if saved[t] is None:
                continue
            inp, act_out, aux_out = saved[t]
            saved[t] = None
            mi = t - s_idx
            pairs = [(act_out, buf[s_idx].to(act_out.dtype))] + [
                (a, g[mi].to(a.dtype)) for g, a in zip(mine, aux_out) if a.requires_grad]
            wanted = [inp] + [p for p in p_in if p.requires_grad]
            grads = torch.autograd.grad([o for o, _ in pairs], wanted, [c for _, c in pairs],
                                        allow_unused=True)
            g_inp, it = grads[0], iter(grads[1:])
            for i, p in enumerate(p_in):
                if not p.requires_grad:
                    continue
                g = next(it)
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
            if g_inp is None:
                g_inp = torch.zeros_like(inp)
            if s_idx == 0:
                g_xs[mi] = g_inp
            else:
                pending = g_inp
        return (None, g_xs, *g_params)


def pipeline_forward(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                     num_microbatches: int, axis: str = STAGE_AXIS,
                     data_axis: str | None = None) -> torch.Tensor:
    """Run the ``S = mesh.shape[axis]`` stages over microbatches (JAX
    ``pipeline_forward``). ``stage_fn(params_slice, act) -> act`` keeps the
    activation's shape; ``stage_params``' leaves have a leading stage axis
    (:func:`stack_stage_params`), of which this rank runs its slice; ``x``:
    (B, ...) into stage 0, the same on every rank, B a multiple of
    ``num_microbatches``. Returns the last stage's outputs (B, ...), the
    same bits on every rank. Schedule, collectives and ``data_axis``: the
    module docstring."""
    out, _ = pipeline_forward_aux(
        lambda p, a: (stage_fn(p, a), None), stage_params, x, mesh=mesh,
        num_microbatches=num_microbatches, axis=axis, data_axis=data_axis)
    return out


def pipeline_forward_aux(stage_fn: Callable, stage_params, x: torch.Tensor, *, mesh,
                         num_microbatches: int, axis: str = STAGE_AXIS,
                         data_axis: str | None = None):
    """:func:`pipeline_forward` with per-stage aux (JAX
    ``pipeline_forward_aux``): ``stage_fn(params_slice, act) -> (act, aux)``,
    aux a tree of tensors whose leading dim is the microbatch's batch (or
    None). Returns ``(out, aux)``, each aux leaf stacked to (S, M) +
    leaf.shape, stage-major and microbatch-minor; differentiable in both."""
    index = _axis(mesh, axis)[1]
    return _run_stage(stage_fn, tree_map(lambda p: p[index], stage_params), x, mesh=mesh,
                      num_microbatches=num_microbatches, axis=axis, data_axis=data_axis)


def _run_stage(stage_fn: Callable, local_params, x: torch.Tensor, *, mesh,
               num_microbatches: int, axis: str, data_axis: str | None):
    """:func:`pipeline_forward_aux` given this rank's own stage's
    parameters (any tree) instead of every stage's stacked."""
    m = num_microbatches
    b = x.shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    mb = b // m
    xs = x.reshape(m, mb, *x.shape[1:])
    s_total, s_idx, group = _axis(mesh, axis)
    if data_axis is not None:
        n_data, d_idx, d_group = _axis(mesh, data_axis)
        if mb % n_data:
            raise ValueError(f"microbatch {mb} must divide the mesh's {data_axis!r} axis of "
                             f"{n_data}")
        mbl = mb // n_data
        xs = xs[:, d_idx * mbl:(d_idx + 1) * mbl]
    names, leaves = zip(*_flatten(local_params).items())
    plan = dict(stage_fn=stage_fn, names=names, group=group, stages=s_total, index=s_idx,
                grad=torch.is_grad_enabled())
    out, *aux_leaves = _Pipeline.apply(plan, xs, *leaves)
    if data_axis is not None:
        out = _gather_tokens(out, 1, d_idx, n_data, d_group)
        aux_leaves = [_gather_tokens(a, 2, d_idx, n_data, d_group) for a in aux_leaves]
    keys = plan["aux_keys"]
    aux = (None if not keys else aux_leaves[0] if keys == [""]
           else _nest(zip(keys, aux_leaves)))
    return out.reshape(b, *out.shape[2:]), aux


def stage_layers(params, num_stages: int, index: int) -> list:
    """The encoder layer trees of stage ``index`` of ``num_stages``:
    contiguous groups, as :func:`stack_vit_stage_params` stacks them (JAX's
    ValueError where the layers do not divide). A rank runs its own
    stage's layers from these, without stacking every stage's."""
    enc = params["encoder"]
    ids = _layer_ids(enc)
    if len(ids) % num_stages:
        raise ValueError(f"{len(ids)} encoder layers not divisible into {num_stages} pipeline "
                         "stages")
    lps = len(ids) // num_stages
    return [enc[f"layers_{i}"] for i in ids[index * lps:(index + 1) * lps]]


# --------------------------------------------------- ViT-level pipelining


def vit_block_forward(p, x: torch.Tensor, num_heads: int, ln_eps: float = 1e-5) -> torch.Tensor:
    """One pre-LN ViT block from an encoder layer's param tree (JAX
    ``vit_block_forward``: the linen block's numerics, fp32 two-pass LN,
    ``attention_core`` and the exact-erf gelu; deterministic)."""
    at = p["self_attention"]
    d = x.shape[-1]
    y = _ln(x, p["ln_1"]["scale"], p["ln_1"]["bias"], ln_eps)
    qkv = y @ at["in_proj_kernel"] + at["in_proj_bias"]
    y = attention_core(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads)
    x = x + (y @ at["out_proj_kernel"] + at["out_proj_bias"])
    z = _ln(x, p["ln_2"]["scale"], p["ln_2"]["bias"], ln_eps)
    z = F.gelu(z @ p["mlp"]["fc1_kernel"] + p["mlp"]["fc1_bias"])
    return x + (z @ p["mlp"]["fc2_kernel"] + p["mlp"]["fc2_bias"])


def stack_vit_stage_params(params, num_stages: int):
    """The encoder's layer trees stacked with leading (num_stages,
    layers_per_stage) axes, contiguous layer groups (JAX
    ``stack_vit_stage_params``); JAX's ValueError where the layers do not
    divide."""
    return stack_stage_params([stack_stage_params(stage_layers(params, num_stages, s))
                               for s in range(num_stages)])


def pipelined_vit_forward(params, images: torch.Tensor, *, mesh, num_microbatches: int,
                          num_heads: int, patch_size: int, num_class_tokens: int = 1,
                          num_registers: int = 0, ln_eps: float = 1e-5, axis: str = STAGE_AXIS,
                          data_axis: str | None = None, kernels: str = "xla",
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Full plain-ViT forward with the encoder blocks pipelined over the
    mesh's ``axis`` (JAX ``pipelined_vit_forward``), from the JAX-grammar
    param tree (``models.adapters.live_params``). images: the whole (B, H,
    W, 3) batch, the same on every rank; returns the whole batch's fp32
    logits, the same bits on every rank. The embed, pos-embedding, final LN
    and classifier run on every rank in fp32.

    - ``kernels="xla"``: each layer :func:`vit_block_forward` in fp32.
    - ``kernels="pallas"``: each layer ``attention_block_trainable`` (sites
      18-19, the recompute backward; the CUDA kernels on the card, their
      plain versions on the CPU) and the eager tanh-gelu MLP, every operand
      cast to ``compute_dtype`` and the layer's output back to fp32: the
      split path of the fused single-device step (``training/fused.py``).

    JAX's ``interpret`` is a TPU knob and is dropped."""
    if kernels == "pallas":
        def block(p, act):
            at = p["self_attention"]
            c = lambda t: t.to(compute_dtype)  # noqa: E731
            t = attention_block_trainable(
                c(act), c(p["ln_1"]["scale"]), c(p["ln_1"]["bias"]), c(at["in_proj_kernel"]),
                c(at["in_proj_bias"]), c(at["out_proj_kernel"]), c(at["out_proj_bias"]),
                num_heads, ln_eps, False)
            z = _layer_norm(t, c(p["ln_2"]["scale"]), c(p["ln_2"]["bias"]), ln_eps)
            z = F.gelu(z @ c(p["mlp"]["fc1_kernel"]) + c(p["mlp"]["fc1_bias"]),
                       approximate="tanh")
            t = t + (z @ c(p["mlp"]["fc2_kernel"]) + c(p["mlp"]["fc2_bias"]))
            return t.to(act.dtype)
    elif kernels == "xla":
        def block(p, act):
            return vit_block_forward(p, act, num_heads, ln_eps)
    else:
        raise ValueError(f"kernels must be 'xla' or 'pallas', got {kernels}")

    cast = lambda t: t.float()  # noqa: E731
    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    tokens = tokens + cast(params["encoder"]["pos_embedding"])
    s_total, index, _ = _axis(mesh, axis)
    layers = stage_layers(params, s_total, index)

    def stage_fn(p, act):
        for j in range(len(layers)):  # this stage's layers
            act = block(p[str(j)], act)
        return act, None

    out, _ = _run_stage(stage_fn, {str(j): lp for j, lp in enumerate(layers)}, tokens, mesh=mesh,
                        num_microbatches=num_microbatches, axis=axis, data_axis=data_axis)
    return _classify(params, out, num_class_tokens, cast, ln_eps)
