"""Sequence parallelism over ``torch.distributed``: the token axis sharded
over the mesh's model axis (counterpart of peekvit_tpu/parallel/sequence.py).

The layout is the Megatron-SP one: each rank of a model row holds
``n_pad / S`` consecutive rows of the (zero-padded) token sequence and runs
everything token-local on them (LayerNorm, the qkv projection, the
out-projection and the MLP); per layer the only cross-token step gathers K
and V, so the rank's queries attend to every key. The embed, the
RankViT norm ranking and the classifier run on every rank.

Where JAX runs one ``shard_map`` program over a device mesh, each rank
here is one process (``parallel/mesh.py``). Gloo's ``all_gather`` takes no
CUDA tensors, but its ``all_reduce`` does, so :func:`_gather_tokens` writes
the rank's slice into a zero-filled buffer and all-reduces it: adding
zeros is exact, so every rank holds the same bits. Its backward is an
fp32 all-reduce of the cotangent followed by the rank's slice (the
reduce-scatter JAX transposes an all-gather into). It gathers K and V
(cast to the compute dtype before the gather: the same bits as JAX's
gather-then-cast, half the bytes), the RankViT norms (detached) and the
final tokens for the classifier; with a data axis, the logits over the
data column, so the forward is global-batch in and out as JAX's.

Gradients: every rank computes the loss of the whole batch from the
gathered tokens, and each rank's backward reaches the parameters only
through its own rows (and, for the head, its copy of the classifier).
So the gradient of JAX's one global loss is the SUM over all ranks of
each rank's gradient of ``loss / world_size``: a caller scales the loss
by 1 / world size and all-reduces the parameter gradients (the Trainer's
SP step, training/trainer.py). Parity with JAX is pinned in
tests/test_torch_sp_training.py.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from peekvit_torch.inference import _classify, _embed, _layer_ids, _layer_norm
from peekvit_torch.ops.attention import attention_core
from peekvit_torch.ops.cuda.fused_layer_vjp import sp_tail_block, sp_tail_block_ref
from peekvit_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

_ln = _layer_norm  # two-pass fp32 LN rounded to x's dtype (JAX sequence.py:25)


def _axis(mesh, axis: str):
    """(size, this rank's index, process group) of a mesh axis: the data
    axis, or the second (``model`` or ``stage``)."""
    if axis == DATA_AXIS:
        return mesh.shape[DATA_AXIS], mesh.data_index, mesh.data_group
    if axis in mesh.shape:
        return mesh.shape[axis], mesh.model_index, mesh.model_group
    raise ValueError(f"unknown mesh axis {axis!r}: this mesh has {tuple(mesh.shape)}")


class _GatherTokens(torch.autograd.Function):
    """All-gather of equal slices along ``dim`` over ``group`` as an
    all-reduce of a zero-filled buffer (optionally in another dtype: the
    copy into the buffer casts). Backward: the cotangent all-reduced in
    fp32, then this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, index, size, group, dtype):
        n = x.shape[dim]
        ctx.dim, ctx.start, ctx.n, ctx.group, ctx.in_dtype = dim, index * n, n, group, x.dtype
        shape = list(x.shape)
        shape[dim] = n * size
        buf = x.new_zeros(shape, dtype=dtype or x.dtype)
        buf.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.n).to(ctx.in_dtype), None, None, None, None, None


def _gather_tokens(x, dim: int, index: int, size: int, group, dtype=None) -> torch.Tensor:
    """The ``size`` ranks' slices of ``x`` concatenated along ``dim`` (cast
    to ``dtype`` if given), identical on every rank; differentiable. A
    one-rank axis needs no collective."""
    if size == 1:
        return x if dtype is None else x.to(dtype)
    return _GatherTokens.apply(x, dim, index, size, group, dtype)


def _local_layer(lp, t, key_mask, gather, *, num_heads: int, ln_eps: float, kernels: str,
                 compute_dtype, tail):
    """One pre-LN encoder layer on this rank's rows t (B, n_local, D): LN1
    and qkv in fp32 (XLA in JAX, sequence.py:179-181), K and V gathered,
    then the tail: ``tail`` (the SP tail block, in ``compute_dtype``) under
    ``kernels="pallas"``, else the fp32 attention with ``key_mask``,
    out-projection, LN2 and the exact-erf gelu MLP (:198-203)."""
    at = lp["self_attention"]
    d = t.shape[-1]
    y = _ln(t, lp["ln_1"]["scale"], lp["ln_1"]["bias"], ln_eps)
    qkv = y @ at["in_proj_kernel"] + at["in_proj_bias"]
    if kernels == "pallas":
        kv = gather(qkv[..., d:], compute_dtype)
        cd = lambda a: a.to(compute_dtype)  # noqa: E731
        mlp = lp["mlp"]
        return tail(cd(t), cd(qkv[..., :d]), kv[..., :d], kv[..., d:], key_mask,
                    cd(at["out_proj_kernel"]), cd(at["out_proj_bias"]),
                    cd(lp["ln_2"]["scale"]), cd(lp["ln_2"]["bias"]),
                    cd(mlp["fc1_kernel"]), cd(mlp["fc1_bias"]), cd(mlp["fc2_kernel"]),
                    cd(mlp["fc2_bias"]), num_heads, ln_eps).to(t.dtype)
    kv = gather(qkv[..., d:], None)
    y = attention_core(qkv[..., :d], kv[..., :d], kv[..., d:], num_heads, key_mask=key_mask)
    t = t + (y @ at["out_proj_kernel"] + at["out_proj_bias"])
    z = _ln(t, lp["ln_2"]["scale"], lp["ln_2"]["bias"], ln_eps)
    z = F.gelu(z @ lp["mlp"]["fc1_kernel"] + lp["mlp"]["fc1_bias"])
    return t + (z @ lp["mlp"]["fc2_kernel"] + lp["mlp"]["fc2_bias"])


def sequence_parallel_vit_block(params, tokens: torch.Tensor, num_heads: int, *, mesh,
                                axis: str = MODEL_AXIS, ln_eps: float = 1e-5) -> torch.Tensor:
    """One pre-LN ViT block with the token axis sharded over ``axis``
    (JAX ``sequence_parallel_vit_block``, :33). ``params``: one encoder
    layer's tree (ln_1 / self_attention / ln_2 / mlp). ``tokens``: the
    whole (B, N, D), N divisible by the axis size, the same on every rank
    of the axis; this rank runs its N / S rows, gathering K and V, and the
    rows are gathered back: every rank returns the whole (B, N, D)."""
    s, index, group = _axis(mesh, axis)
    if tokens.shape[1] % s:
        raise ValueError(f"N={tokens.shape[1]} tokens must be divisible by the {axis!r} axis "
                         f"size {s}")
    nl = tokens.shape[1] // s

    def gather(x, dtype=None, dim=1):
        return _gather_tokens(x, dim, index, s, group, dtype)

    out = _local_layer(params, tokens[:, index * nl:(index + 1) * nl], None, gather,
                       num_heads=num_heads, ln_eps=ln_eps, kernels="xla", compute_dtype=None,
                       tail=None)
    return gather(out)


def sequence_parallel_vit_forward(params, images: torch.Tensor, *, num_heads: int,
                                  patch_size: int, mesh, axis: str = MODEL_AXIS,
                                  num_class_tokens: int = 1, num_registers: int = 0,
                                  ln_eps: float = 1e-5, rankvit_layers=(), budget=None,
                                  data_axis: str | None = None, kernels: str = "xla",
                                  compute_dtype=torch.float32, plain: bool = False,
                                  kept_out: dict | None = None, kept: dict | None = None
                                  ) -> torch.Tensor:
    """Full ViT / RankViT forward with the token axis sharded over ``axis``
    (JAX ``sequence_parallel_vit_forward``, :80), from the JAX-grammar param
    tree (``models.adapters.live_params``). images: the whole (B, H, W, 3)
    batch, the same on every rank. Returns the whole batch's fp32 logits,
    the same bits on every rank.

    - The embed and pos-embedding run on every rank in fp32; N is
      zero-padded to a multiple of S, and the padded positions are excluded
      as keys in every layer.
    - RankViT (``rankvit_layers`` and a ``budget``): each ranked layer
      gathers the (B, n_pad) fp32 token norms, ranks the alive image tokens
      by a stable argsort of the negated norms, keeps ceil(alive * budget)
      and updates the key mask (class tokens always attended), as the
      linen ``_rank_update``.
    - ``kernels="pallas"``: everything after each layer's K/V gather runs
      ``sp_tail_block`` (Pallas site 12; CUDA kernels on the card, bf16)
      on every operand cast to ``compute_dtype``, the output cast back to
      fp32; ``plain=True`` takes its plain version whatever the device (the
      reference the kernels are held against). ``"xla"``: the fp32 torch
      tail with the exact-erf gelu (the tail kernel's is tanh: ~2e-3).
    - ``data_axis``: the mesh's data axis for dp x sp: this rank runs its
      data column's slice of the batch, and the logits are gathered over
      the data column.
    - ``kept_out``: a dict this fills with each ranked layer's alive mask
      (B, n_pad - C) after the ranking; ``kept``: such a dict, used instead
      of ranking, so a reference can be fed a run's kept tokens (bf16 norm
      ties flip kept sets between two roundings of the same layers).

    JAX's ``interpret`` is a TPU knob and is dropped.
    """
    if kernels not in ("xla", "pallas"):
        raise ValueError(f"kernels must be 'xla' or 'pallas', got {kernels}")
    s, index, group = _axis(mesh, axis)

    def gather(x, dtype=None, dim=1):
        return _gather_tokens(x, dim, index, s, group, dtype)

    if data_axis is not None:
        n_data, data_index, data_group = _axis(mesh, data_axis)
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} must divide the mesh's {data_axis!r} "
                             f"axis of {n_data}")
        bl = images.shape[0] // n_data
        images = images[data_index * bl:(data_index + 1) * bl]

    cast = lambda t: t.float()  # noqa: E731
    tokens, _ = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    enc = params["encoder"]
    tokens = tokens + cast(enc["pos_embedding"])
    b, n, _ = tokens.shape
    n_pad = -(-n // s) * s
    nl = n_pad // s
    t = F.pad(tokens, (0, 0, 0, n_pad - n))[:, index * nl:(index + 1) * nl]
    c = num_class_tokens
    pad_valid = (torch.arange(n_pad, device=t.device) < n).float()
    ranked = tuple(rankvit_layers or ())
    rank_on = budget is not None and bool(ranked)
    alive = pad_valid[c:].expand(b, n_pad - c)
    tail = sp_tail_block_ref if plain else sp_tail_block
    for i in _layer_ids(enc):
        lp = enc[f"layers_{i}"]
        if rank_on and i in ranked and kept is not None:
            alive = kept[i]
        elif rank_on and i in ranked:
            norms = gather(t.detach().float().pow(2).sum(-1).sqrt())  # (B, n_pad) global
            img_norms = torch.where(alive > 0, norms[:, c:], torch.finfo(torch.float32).min)
            order = torch.argsort(-img_norms, dim=-1, stable=True)
            ranks = torch.argsort(order, dim=-1)
            n_keep = torch.ceil(alive.sum(-1, keepdim=True)
                                * torch.tensor(budget, dtype=torch.float32))
            alive = ((ranks < n_keep) & (alive > 0)).float()
        if rank_on and i in ranked and kept_out is not None:
            kept_out[i] = alive
        if rank_on:
            key_mask = torch.cat([torch.ones(b, c, device=t.device), alive], dim=1)
        else:
            key_mask = pad_valid.expand(b, n_pad).contiguous()
        t = _local_layer(lp, t, key_mask, gather, num_heads=num_heads, ln_eps=ln_eps,
                         kernels=kernels, compute_dtype=compute_dtype, tail=tail)
    logits = _classify(params, gather(t)[:, :n], c, cast, ln_eps)
    if data_axis is not None:
        logits = _gather_tokens(logits, 0, data_index, n_data, data_group)
    return logits
