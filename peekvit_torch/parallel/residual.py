"""Pipeline- and sequence-parallel forwards of the gated ResidualViT, with
the per-layer gate masks coming back as aux for the regularizers
(counterpart of peekvit_tpu/parallel/residual.py).

The mode is the fused train path's shipped-config one: sigmoid gates, the
``attention+mlp`` skip on every layer, the ``learnable`` budget token,
``add_input=False``, no dropout. The numerics are the module's fp32 math
(``attention_core``, the exact-erf gelu, two-pass LN at eps 1e-6 in the
blocks and 1e-5 before the head); nothing here reaches a CUDA kernel.

- :func:`pipelined_residualvit_forward`: each stage runs its layers' gate
  and masked block through ``parallel/pipeline.py``'s schedule and hands
  its masks on as the schedule's aux.
- :func:`sequence_parallel_residualvit_forward`: the token axis sharded as
  in ``parallel/sequence.py``. The gate, the masked LN and the MLP are
  token-local; the learnable threshold needs the evolving budget token on
  every rank, recovered by one sum over the axis per layer (each rank's
  budget-position row, the owner's and zeros, gathered and summed: one
  zero-filled all-reduce whose backward all-reduces the cotangent).
  Padded keys are excluded; gated tokens still attend, with zeroed
  features, as the module's.

Gradients follow the SP step: every rank computes the whole loss, a caller
backpropagates ``loss / world size`` and sums the gradients over every
rank (``Trainer._all_reduce_grads``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from peekvit_torch.inference import _classify, _embed, _layer_ids
from peekvit_torch.ops.attention import attention_core
from peekvit_torch.parallel.mesh import MODEL_AXIS, STAGE_AXIS
from peekvit_torch.parallel.pipeline import _run_stage, stack_stage_params, stage_layers
from peekvit_torch.parallel.sequence import _axis, _gather_tokens, _ln

__all__ = ["pipelined_residualvit_forward", "sequence_parallel_residualvit_forward",
           "stack_residual_stage_params"]

BLOCK_EPS = 1e-6  # the gated blocks' LN (the classifier's stays 1e-5)


def _gate_mask(lp, tokens, s, *, gate_temp, gate_bias, budget_token):
    """The sigmoid gate over the learnable budget token's threshold, fp32.
    tokens: (B, N, D) laid out [special (s), image, budget]. Returns the
    mask (B, N_img, 1)."""
    img = tokens[:, s:-1].float()
    gp = lp["residual_gate"]["projection"]
    sig = torch.sigmoid((img @ gp["kernel"].float() + gp["bias"].float()) / gate_temp
                        + gate_bias)
    if budget_token == "learnable":
        bg = lp["budget_token_gate"]
        thr = torch.sigmoid(tokens[:, -1:].float() @ bg["kernel"].float() + bg["bias"].float())
        return torch.relu(sig - thr)
    raise NotImplementedError(
        "parallel ResidualViT training supports budget_token='learnable' only: the other "
        "modes threshold on a WHOLE-batch mean of the evolving budget token (reference "
        "residualvit.py:208), which microbatching / batch sharding would silently change")


def _residual_block(lp, tokens, mask, s, num_heads, ln_eps=BLOCK_EPS):
    """The gated block after its gate: the masked stream replaces the
    tokens, mask * LN before both sublayers, the attention output masked,
    the MLP output not."""
    b, _, d = tokens.shape
    img = tokens[:, s:-1]
    ones = tokens.new_ones((b, 1, 1), dtype=torch.float32)
    fwd_mask = torch.cat([tokens.new_ones((b, s, 1), dtype=torch.float32), mask, ones], dim=1)
    t = torch.cat([tokens[:, :s], mask.to(tokens.dtype) * img, tokens[:, -1:]], dim=1)
    at = lp["self_attention"]
    x = _ln(t, lp["ln_1"]["scale"], lp["ln_1"]["bias"], ln_eps) * fwd_mask
    qkv = x @ at["in_proj_kernel"] + at["in_proj_bias"]
    y = attention_core(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], num_heads)
    y = (y @ at["out_proj_kernel"] + at["out_proj_bias"]) * fwd_mask
    x = y + t
    z = _ln(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"], ln_eps) * fwd_mask
    z = F.gelu(z @ lp["mlp"]["fc1_kernel"] + lp["mlp"]["fc1_bias"])
    return x + (z @ lp["mlp"]["fc2_kernel"] + lp["mlp"]["fc2_bias"])


def _embed_with_budget(params, images, budget_vec, *, patch_size, num_class_tokens,
                       num_registers, budget_token):
    """The embed and pos-embedding (the budget token has none), then the
    budget token appended: (tokens (B, N, D), D)."""
    cast = lambda t: t.float()  # noqa: E731
    tokens, d = _embed(params, images, patch_size, num_class_tokens, num_registers, cast)
    tokens = tokens + cast(params["encoder"]["pos_embedding"])
    b = tokens.shape[0]
    bvec = budget_vec.float()[:, None, None]
    if budget_token == "learnable":
        btok = cast(params["learnable_budget_token_1"]) * bvec
    elif budget_token == "learnable_interpolate":
        btok = (cast(params["learnable_budget_token_1"]) * bvec
                + cast(params["learnable_budget_token_2"]) * (1.0 - bvec))
    else:
        btok = bvec
    return torch.cat([tokens, btok.expand(b, 1, d)], dim=1), d


def stack_residual_stage_params(params, num_stages: int):
    """The gated encoder layers (gates included) stacked with leading
    (num_stages, layers_per_stage) axes, contiguous layer groups."""
    return stack_stage_params([stack_stage_params(stage_layers(params, num_stages, s))
                               for s in range(num_stages)])


def pipelined_residualvit_forward(params, images: torch.Tensor, budget_vec: torch.Tensor, *,
                                  mesh, num_microbatches: int, num_heads: int, patch_size: int,
                                  num_class_tokens: int = 1, num_registers: int = 0,
                                  gate_temp: float = 1.0, gate_bias: float = 0.0,
                                  budget_token="learnable", axis: str = STAGE_AXIS,
                                  data_axis: str | None = None):
    """The gated ResidualViT forward with its layers pipelined over the
    mesh's ``axis`` (JAX ``pipelined_residualvit_forward``). images and
    ``budget_vec`` (B,): the whole batch, the same on every rank. Returns
    ``(logits, aux)``: aux["masks"][f"layer_{i}"] (B, N_img, 1) in global
    row order and aux["current_budget"] = budget_vec, the same bits on
    every rank."""
    tokens, _ = _embed_with_budget(params, images, budget_vec, patch_size=patch_size,
                                   num_class_tokens=num_class_tokens,
                                   num_registers=num_registers, budget_token=budget_token)
    s = num_class_tokens + num_registers
    n_img = tokens.shape[1] - s - 1
    s_total, index, _ = _axis(mesh, axis)
    layers = stage_layers(params, s_total, index)

    def stage_fn(p, act):
        masks = []
        for j in range(len(layers)):  # this stage's layers
            lp = p[str(j)]
            mask = _gate_mask(lp, act, s, gate_temp=gate_temp, gate_bias=gate_bias,
                              budget_token=budget_token)
            act = _residual_block(lp, act, mask, s, num_heads)
            masks.append(mask)
        # batch-leading (mb, lps, N_img, 1), as the schedule's aux must be
        return act, torch.stack(masks, dim=1)

    out, stacked = _run_stage(stage_fn, {str(j): lp for j, lp in enumerate(layers)}, tokens,
                              mesh=mesh, num_microbatches=num_microbatches, axis=axis,
                              data_axis=data_axis)
    # (S, M, mb, lps, N_img, 1) -> one (B, N_img, 1) per layer
    s_n, m, mb, lps = stacked.shape[:4]
    masks = {f"layer_{st * lps + j}": stacked[st, :, :, j].reshape(m * mb, n_img, 1)
             for st in range(s_n) for j in range(lps)}
    logits = _classify(params, out, num_class_tokens, lambda t: t.float(), 1e-5)
    return logits, {"masks": masks, "current_budget": budget_vec}


def sequence_parallel_residualvit_forward(params, images: torch.Tensor,
                                          budget_vec: torch.Tensor, *, mesh, num_heads: int,
                                          patch_size: int, num_class_tokens: int = 1,
                                          num_registers: int = 0, gate_temp: float = 1.0,
                                          gate_bias: float = 0.0, budget_token="learnable",
                                          axis: str = MODEL_AXIS, data_axis: str | None = None):
    """The gated ResidualViT forward with the token axis sharded over
    ``axis`` (JAX ``sequence_parallel_residualvit_forward``). The tokens
    are zero-padded to a multiple of S; each rank runs its N_pad / S rows,
    gathers K and V and recovers the budget token by one sum a layer.
    ``data_axis``: dp x sp, this rank's data column's slice of the batch.
    Returns ``(logits, aux)`` for the whole batch, masks on the image
    positions, the same bits on every rank."""
    if budget_token != "learnable":
        raise NotImplementedError("SP ResidualViT needs budget_token='learnable' (other modes "
                                  "threshold on a whole-batch mean)")
    s_axis, index, group = _axis(mesh, axis)
    whole_budget = budget_vec
    if data_axis is not None:
        n_data, data_index, data_group = _axis(mesh, data_axis)
        if images.shape[0] % n_data:
            raise ValueError(f"batch {images.shape[0]} must divide the mesh's {data_axis!r} "
                             f"axis of {n_data}")
        bl = images.shape[0] // n_data
        images = images[data_index * bl:(data_index + 1) * bl]
        budget_vec = budget_vec[data_index * bl:(data_index + 1) * bl]
    tokens, d = _embed_with_budget(params, images, budget_vec, patch_size=patch_size,
                                   num_class_tokens=num_class_tokens,
                                   num_registers=num_registers, budget_token=budget_token)
    special = num_class_tokens + num_registers
    b, n, _ = tokens.shape
    n_pad = -(-n // s_axis) * s_axis
    npl = n_pad // s_axis
    t = F.pad(tokens, (0, 0, 0, n_pad - n))[:, index * npl:(index + 1) * npl]
    pos = torch.arange(n_pad, device=t.device)
    pad_valid = (pos < n).float()
    is_img = ((pos >= special) & (pos < n - 1)).float()
    is_budget = (pos == n - 1).float()
    here = slice(index * npl, (index + 1) * npl)
    l_valid = pad_valid[here][None, :, None]
    l_img = is_img[here][None, :, None]
    l_budget = is_budget[here][None, :, None]
    key_mask = pad_valid.expand(b, n_pad)
    enc = params["encoder"]
    ids = _layer_ids(enc)
    masks = []
    for i in ids:
        lp = enc[f"layers_{i}"]
        tf = t.float()
        gp = lp["residual_gate"]["projection"]
        sig = torch.sigmoid((tf @ gp["kernel"].float() + gp["bias"].float()) / gate_temp
                            + gate_bias)
        # the owner's row, zeros elsewhere: summing the gathered rows is exact
        btok = _gather_tokens((tf * l_budget).sum(dim=1, keepdim=True), 1, index, s_axis,
                              group).sum(dim=1, keepdim=True)
        bg = lp["budget_token_gate"]
        thr = torch.sigmoid(btok @ bg["kernel"].float() + bg["bias"].float())
        mask_full = torch.relu(sig - thr)  # (B, npl, 1) at every position
        # image positions gate; special and budget stay 1, padding 0
        fwd_mask = (mask_full * l_img + (l_valid - l_img)) * l_valid
        masks.append(mask_full * l_img)
        t = tf * torch.where(l_img > 0, mask_full, torch.ones_like(mask_full)) * l_valid
        at = lp["self_attention"]
        x = _ln(t, lp["ln_1"]["scale"], lp["ln_1"]["bias"], BLOCK_EPS) * fwd_mask
        qkv = x @ at["in_proj_kernel"] + at["in_proj_bias"]
        kv = _gather_tokens(qkv[..., d:], 1, index, s_axis, group)
        y = attention_core(qkv[..., :d], kv[..., :d], kv[..., d:], num_heads, key_mask=key_mask)
        y = (y @ at["out_proj_kernel"] + at["out_proj_bias"]) * fwd_mask
        x = y + t
        z = _ln(x, lp["ln_2"]["scale"], lp["ln_2"]["bias"], BLOCK_EPS) * fwd_mask
        z = F.gelu(z @ lp["mlp"]["fc1_kernel"] + lp["mlp"]["fc1_bias"])
        t = x + (z @ lp["mlp"]["fc2_kernel"] + lp["mlp"]["fc2_bias"])
    out = _gather_tokens(t, 1, index, s_axis, group)[:, :n]
    # every layer's masks in one gather over the tokens: (L, B, n_pad, 1)
    stacked = _gather_tokens(torch.stack(masks), 2, index, s_axis, group)
    logits = _classify(params, out, num_class_tokens, lambda v: v.float(), 1e-5)
    if data_axis is not None:
        logits = _gather_tokens(logits, 0, data_index, n_data, data_group)
        stacked = _gather_tokens(stacked, 1, data_index, n_data, data_group)
    masks = {f"layer_{i}": stacked[li, :, special:n - 1] for li, i in enumerate(ids)}
    return logits, {"masks": masks, "current_budget": whole_budget}
