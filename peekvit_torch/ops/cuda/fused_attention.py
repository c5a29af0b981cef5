"""The encoder layer's kernels: wrappers, plain versions and the layer
compositions (counterpart of peekvit_tpu/ops/pallas/fused_attention.py).

The Pallas layer kernel (``_layer_kernel``, plain mode, LN affines
folded) keeps a whole layer's weights resident in TPU VMEM and runs the
layer in one call. Hopper has 227 KB of shared memory per block, so its
contract becomes seven launches over three hand-written CUDA kernels
(``peekvit_torch/csrc``)::

    norm_rows -> gemm(+bias) -> attn_scores_pv -> gemm(+bias+residual, fp32)
    -> norm_rows -> gemm(+bias, tanh-gelu) -> gemm(+bias+residual)

Each kernel has a plain PyTorch version here (``*_ref``) with the Pallas
kernel's math and rounding points (not linen's): one-pass statistics,
tanh-gelu, the clamped exp2 softmax without max subtraction, the fp32
mid-layer residual, bf16 rounding of normalized rows, qkv, attention
output and gelu output (rounding to the compute dtype: none in fp32).
``gemm_nt`` (the same GEMM source with W read as (N, K) and no bias)
serves the trainable block's backward (fused_attention_vjp.py), and
``gemm_masked_rowdot`` (epilogue ``masked_rowdot``) the masked block's:
the bf16 g * mask and the row partials of sum(g * proj). The merged
trainable layer (fused_layer_vjp.py) adds ``ln_rows`` on its fp32 mid
residual and two two-output epilogues, ``gemm_gelu_hpre`` (h and the
fp32 pre-activation) and ``gemm_nt_gelu_grad`` (dhpre and the column
partials of db1). ``gemm_partial_f32`` (epilogue ``partial_f32``: the
bare fp32 product) carries the tensor-parallel partials
(``tp_blocks.py``).

``fused_mhsa`` and ``fused_attention`` are the linen attention switch's
Pallas sites 1 and 2 (:153, :220): packed qkv through ``attn_scores_pv``,
and separate q, k, v through ``attn_softmax_fwd``'s kernel.

The ResidualViT layer (``_layer_kernel`` mode ``masked``, and the split
``masked_attention_block`` / ``masked_mlp_block``) runs on the same three
kernels with a per-row mask: the norms take the LN affine and the mask
(mask * LN(x); the affine cannot be folded, the mask does not commute
with the folded bias), the out-projection GEMM masks its output before the
residual add, and the attention kernel weights the compaction engine's
phantom key (``phantom_idx``/``phantom_mult``, the Pallas ``kweight``).

The A-ViT layer (``_layer_kernel`` mode ``avit``, ``avit_layer_block``)
runs the same seven launches with the norms in their ``avit`` mode,
LN(x * a) * a (the row multiplied by its mask before the statistics and
again after the affine), and unmasked residual adds.

The padded RankViT layer (``_layer_kernel`` mode ``keymasked``, folded)
and its split attention sublayer (``keymasked_attention_block``) run the
plain compositions with the attention kernel's key mask (the Pallas
``kmask``: excluded keys selected to weight 0, non-finite values of v
scrubbed, so garbage in excluded rows stays inert). ``fused_mlp_block``
is the split MLP sublayer the exact RankViT engine takes below 128
tokens.

The attention kernel is instantiated at head dims 64 (the ViT family), 32
(PCT: d = 128 over 4 heads; MAE; counted as ``attn_scores_pv.hd32``) and
48 (the EncDec ResidualViT's decoder: d = 192 over 4 heads, counted as
``attn_scores_pv.hd48``), so every composition here runs at any of them;
each head dim takes the wgmma kernel with the head's K and V resident in
shared memory up to its length limit (832 tokens at 64, 1,088 at 48,
1,728 at 32) and the mma.sync kernel past it.

Dispatch is by device only. A wrapper uses the plain version for CPU
tensors; for CUDA tensors it launches its kernel or raises (wrong dtype,
shape, contiguity, a failed build or launch). Nothing sends a CUDA tensor
to a plain version. ``LAUNCHES`` counts kernel launches by kernel and
variant; :func:`reset_launch_counts` zeroes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from peekvit_torch.ops.cuda import _build

LOG2E = 1.4426950408889634  # exp(x) = exp2(x * LOG2E)

LAUNCHES: dict[str, int] = {}
_EPILOGUES = {"bias": 0, "gelu": 1, "residual_f32": 2, "residual": 3,
              "masked_residual_f32": 6, "masked_residual": 7}
_NT_EPILOGUES = {"none": 4, "none_f32": 5}  # W read as (N, K), no bias
# Every epilogue of gemm_bias_epilogue.cu by name, for gemm_plan
GEMM_EPILOGUES = {**_EPILOGUES, **_NT_EPILOGUES, "masked_rowdot": 8, "gelu_hpre": 9,
                  "gelu_grad": 10, "partial_f32": 11}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _count(key: str) -> None:
    LAUNCHES[key] = LAUNCHES.get(key, 0) + 1


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if devices == {"cpu"}:
        return True
    if devices == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {devices}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_bf16(name: str, t: torch.Tensor) -> None:
    _require(t.dtype == torch.bfloat16, f"{name}: the kernel takes bf16, got {t.dtype}")
    _require(t.is_contiguous(), f"{name}: must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name}: must be 16-byte aligned")


def _launched(key: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{key}: CUDA launch failed with cudaError_t {err}")
    _count(key)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------------ norm_rows


def fold_ln_into_weights(ln_scale, ln_bias, w, b):
    """(norm(x) * s + lb) @ W + b == norm(x) @ (s[:, None] * W) + (lb @ W + b).
    Computed in fp32, cast back to ``w``'s / ``b``'s dtype; the bias comes
    back as (1, out). Accepts (k,) or (1, k) vectors. A weight
    transformation done once at engine build, not a kernel."""
    sf = ln_scale.float().reshape(-1)
    bf = ln_bias.float().reshape(1, -1)
    wf = w.float()
    w2 = (sf[:, None] * wf).to(w.dtype)
    b2 = (bf @ wf + b.float().reshape(1, -1)).to(b.dtype)
    return w2, b2


def _affine_mask_ref(out, scale, bias, mask):
    """fp32 rows * scale + bias, then * the per-row mask (either optional)."""
    if scale is not None:
        out = out * scale.float().reshape(-1) + bias.float().reshape(-1)
    if mask is not None:
        out = out * mask.float().reshape(-1, 1)
    return out


def _check_affine_mask(scale, bias, mask, premask=False):
    """One-pass rows take the LN affine exactly when they take the row
    mask: unmasked, the affine is folded into the next GEMM's weights.
    ``premask`` (A-ViT) needs the mask."""
    _require((scale is None) == (bias is None), "norm_rows: scale and bias come together")
    _require((scale is None) == (mask is None),
             "norm_rows: one-pass rows take the LN affine exactly when they take the "
             "row mask (a mask does not commute with a folded affine)")
    _require(mask is not None or not premask, "norm_rows: premask needs the row mask")


def norm_rows_ref(x: torch.Tensor, eps: float, out_dtype: torch.dtype,
                  scale=None, bias=None, mask=None, premask: bool = False) -> torch.Tensor:
    """Plain version of :func:`norm_rows` (Pallas ``_norm_rows``, with the
    affine and mask ``mask * _ln_f32_rows``, and with ``premask``
    ``_ln_f32_rows(x * mask) * mask``)."""
    _check_affine_mask(scale, bias, mask, premask)
    xf = x.float()
    if premask:
        xf = xf * mask.float().reshape(-1, 1)
    mu = xf.mean(-1, keepdim=True)
    ms = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    return _affine_mask_ref((xf - mu) * torch.rsqrt(var + eps), scale, bias, mask).to(out_dtype)


def ln_rows_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float, mask=None, out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`ln_rows`: two-pass LN with affine (then the
    row mask), rounded to ``out_dtype`` (default x's dtype; Pallas
    ``_attn_block_kernel`` :253-258, ``_masked_attn_kernel`` :389-395,
    ``_layer_fwd_kernel`` :122-124)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return _affine_mask_ref(out, scale, bias, mask).to(out_dtype or x.dtype)


def _rows_mask(key, mask, rows):
    """The (rows,) bf16 mask the kernels read, made contiguous."""
    mask = mask.reshape(-1).contiguous()
    _check_bf16(f"{key} mask", mask)
    _require(mask.numel() == rows, f"{key}: mask has {mask.numel()} values for {rows} rows")
    return mask


def _norm_launch(key, x, scale, bias, mask, eps, mode):
    """``mode``: 0 one-pass, 1 two-pass, 2 one-pass of x * mask (A-ViT)."""
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"{key}: input must be bf16 or fp32, got {x.dtype}")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             f"{key}: input must be contiguous and 16-byte aligned")
    d = x.shape[-1]
    rows = x.numel() // d
    _require(d % 8 == 0, f"{key}: row width {d} must be a multiple of 8")
    if scale is not None:
        scale, bias = scale.reshape(-1), bias.reshape(-1)
        _check_bf16(f"{key} scale", scale)
        _check_bf16(f"{key} bias", bias)
        _require(scale.numel() == d and bias.numel() == d, f"{key}: affine must have {d} values")
    if mask is not None:
        mask = _rows_mask(key, mask, rows)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    err = _build.library("norm_rows")(
        x.data_ptr(), int(x.dtype == torch.float32),
        None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        out.data_ptr(), rows, d, float(eps), mode, _stream())
    _launched(key, err)
    return out


def norm_rows(x: torch.Tensor, eps: float, out_dtype: torch.dtype,
              scale=None, bias=None, mask=None, premask: bool = False) -> torch.Tensor:
    """Row normalization with one-pass statistics, rounded to
    ``out_dtype``. x: (..., D), bf16 or fp32. Without a mask there is no
    affine (it is folded into the next GEMM); with the row mask (one value
    per row of x, ResidualViT's masked layer) the LN affine ``scale``,
    ``bias`` (D,) applies before the mask: mask * (norm(x) * scale + bias).
    ``premask`` (A-ViT's layer) also multiplies the row by its mask, in
    fp32, before the statistics: mask * (norm(x * mask) * scale + bias).
    On CUDA the output must be bf16 and scale, bias and mask are bf16."""
    _check_affine_mask(scale, bias, mask, premask)
    if _on_cpu(x, scale, bias, mask):
        return norm_rows_ref(x, eps, out_dtype, scale, bias, mask, premask)
    _require(out_dtype == torch.bfloat16, "norm_rows: the kernel writes bf16 only")
    mode = "norm_rows.avit" if premask else "norm_rows.masked" if mask is not None else "norm_rows"
    key = mode + (".f32" if x.dtype == torch.float32 else ".bf16")
    return _norm_launch(key, x, scale, bias, mask, eps, 2 if premask else 0)


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float, mask=None, out_dtype=None) -> torch.Tensor:
    """Two-pass LayerNorm with affine, rounded to ``out_dtype`` (default x's
    dtype; the split path's LN); with ``mask`` (one value per row of x) the
    result is mask * LN(x) (the split masked sublayers). On CUDA, scale,
    bias, mask and the output are bf16, and x is bf16, or fp32 without a
    mask (the merged trainable layer's LN2 on its fp32 mid residual,
    ``ln_rows.f32``, with ``out_dtype=torch.bfloat16``)."""
    if _on_cpu(x, scale, bias, mask):
        return ln_rows_ref(x, scale, bias, eps, mask, out_dtype)
    if x.dtype == torch.float32 and mask is None:
        _require(out_dtype == torch.bfloat16, "ln_rows: from fp32 the kernel writes bf16 only; "
                 "pass out_dtype=torch.bfloat16")
        key = "ln_rows.f32"
    else:
        _check_bf16("ln_rows x", x)
        _require(out_dtype in (None, torch.bfloat16), "ln_rows: the kernel writes bf16 only")
        key = "ln_rows.masked" if mask is not None else "ln_rows"
    return _norm_launch(key, x, scale, bias, mask, eps, 1)


# --------------------------------------------------------- gemm_bias_epilogue


def _check_epilogue(epilogue, residual, mask):
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    needs_res = "residual" in epilogue
    needs_mask = epilogue.startswith("masked")
    _require((residual is not None) == needs_res,
             f"epilogue {epilogue!r} {'needs' if needs_res else 'takes no'} residual")
    _require((mask is not None) == needs_mask,
             f"epilogue {epilogue!r} {'needs' if needs_mask else 'takes no'} mask")
    return needs_res, needs_mask


GEMM_K_MULTIPLE, GEMM_N_MULTIPLE = 32, 8  # gemm_bias_epilogue.cu's K and N


def _check_gemm(key, a, w, nt: bool):
    """(m, n, k) of a @ w (``nt``: a @ w^T) after the GEMM kernel's checks."""
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[1 if nt else 0],
             f"{key}: shapes {tuple(a.shape)} @ {tuple(w.shape)}{'^T' if nt else ''} "
             "do not chain")
    m, k = a.shape
    n = w.shape[0 if nt else 1]
    _require(k % GEMM_K_MULTIPLE == 0, f"{key}: K={k} must be a multiple of {GEMM_K_MULTIPLE}")
    _require(n % GEMM_N_MULTIPLE == 0, f"{key}: N={n} must be a multiple of {GEMM_N_MULTIPLE}")
    for name, t in (("a", a), ("w", w)):
        _check_bf16(f"{key} {name}", t)
    return m, n, k


def gemm_plan(m: int, n: int, epilogue: str = "bias") -> dict:
    """The schedule the GEMM kernel takes for an (m, n) output of
    ``epilogue`` (a key of ``GEMM_EPILOGUES``) on the card, chosen by shape
    inside its C entry point: the C tile width (128 or 256) and the number
    of persistent CTAs. For the record; needs the built library."""
    out = (ctypes.c_int * 2)()
    _build.extra("gemm_bias_epilogue")(m, n, GEMM_EPILOGUES[epilogue], out)
    return {"bn": out[0], "grid": out[1]}


def gemm_bias_epilogue_ref(a, w, bias, epilogue: str, residual=None, mask=None):
    """Plain version of :func:`gemm_bias_epilogue`: fp32 products and sums,
    one rounding at the end."""
    _check_epilogue(epilogue, residual, mask)
    acc = torch.matmul(a.float(), w.float()) + bias.float().reshape(-1)
    if epilogue == "gelu":
        acc = F.gelu(acc, approximate="tanh")
    elif mask is not None:
        acc = acc * mask.float().reshape(-1, 1) + residual.float()
    elif residual is not None:
        acc = acc + residual.float()
    return acc if epilogue.endswith("residual_f32") else acc.to(a.dtype)


def gemm_bias_epilogue(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       epilogue: str, residual: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """C = a @ w + bias with a fused epilogue. a: (R, K), w: (K, N) (the
    (in, out) layout), bias: (N,) or (1, N). ``epilogue``:

    - ``"bias"``: -> a.dtype (qkv);
    - ``"gelu"``: tanh-gelu -> a.dtype (fc1);
    - ``"residual_f32"``: + residual -> fp32 (out-proj, the mid-layer y);
    - ``"residual"``: + residual -> a.dtype (fc2, split-path out-proj);
    - ``"masked_residual_f32"``: (.) * mask + residual -> fp32 (the
      ResidualViT layer's out-proj);
    - ``"masked_residual"``: (.) * mask + residual -> a.dtype (the split
      masked attention sublayer's out-proj).

    The residual is (R, N), fp32 or a.dtype; the mask has one value per
    row (R values, a.dtype)."""
    needs_res, needs_mask = _check_epilogue(epilogue, residual, mask)
    if _on_cpu(a, w, bias, residual, mask):
        return gemm_bias_epilogue_ref(a, w, bias, epilogue, residual, mask)
    key = f"gemm_bias_epilogue.{epilogue}"
    m, n, k = _check_gemm(key, a, w, nt=False)
    bias = bias.reshape(-1)
    _require(bias.numel() == n, f"{key}: bias has {bias.numel()} values, want {n}")
    _check_bf16(f"{key} bias", bias)
    res_f32 = 0
    if needs_res:
        _require(residual.shape == (m, n), f"{key}: residual must be {(m, n)}")
        _require(residual.dtype in (torch.float32, torch.bfloat16),
                 f"{key}: residual must be fp32 or bf16")
        _require(residual.is_contiguous() and residual.data_ptr() % 16 == 0,
                 f"{key}: residual must be contiguous and 16-byte aligned")
        res_f32 = int(residual.dtype == torch.float32)
    if needs_mask:
        mask = _rows_mask(key, mask, m)
    out_dtype = torch.float32 if epilogue.endswith("residual_f32") else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if needs_res else None,
        mask.data_ptr() if needs_mask else None, out.data_ptr(), None,
        m, n, k, _EPILOGUES[epilogue], res_f32, _stream())
    _launched(key, err)
    return out


def gemm_nt_ref(a, w, epilogue: str):
    """Plain version of :func:`gemm_nt`: an fp32 product, one rounding."""
    if epilogue not in _NT_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    acc = torch.matmul(a.float(), w.float().t())
    return acc if epilogue == "none_f32" else acc.to(a.dtype)


def gemm_nt(a: torch.Tensor, w: torch.Tensor, epilogue: str) -> torch.Tensor:
    """C = a @ w^T with no bias, the transposed-weight products inside the
    trainable block's backward kernels. a: (R, K); w: (N, K), a JAX
    (in, out) kernel read as it lies. ``epilogue``: ``"none"`` -> a.dtype
    (dattn = g Wo^T), ``"none_f32"`` -> fp32 (dln = dqkv Wqkv^T). Same
    kernel source as :func:`gemm_bias_epilogue`, with W's layout chosen at
    compile time."""
    if epilogue not in _NT_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if _on_cpu(a, w):
        return gemm_nt_ref(a, w, epilogue)
    key = f"gemm_nt.{epilogue}"
    m, n, k = _check_gemm(key, a, w, nt=True)
    out_dtype = torch.float32 if epilogue == "none_f32" else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), None, None, None, out.data_ptr(), None, m, n, k,
        _NT_EPILOGUES[epilogue], 0, _stream())
    _launched(key, err)
    return out


def gemm_partial_f32_ref(a, w):
    """Plain version of :func:`gemm_partial_f32`: the fp32 product."""
    return torch.matmul(a.float(), w.float())


def gemm_partial_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """C = a @ w in fp32 with no bias and no rounding, GEMM epilogue
    ``partial_f32``: the out-projection and fc2 partials of the
    tensor-parallel sublayers (``ops/cuda/tp_blocks.py``), summed over the
    model shards before bias and residual are added once. a: (R, K), w:
    (K, N) (the (in, out) layout). On CUDA a and w are bf16."""
    if _on_cpu(a, w):
        return gemm_partial_f32_ref(a, w)
    key = "gemm_bias_epilogue.partial_f32"
    m, n, k = _check_gemm(key, a, w, nt=False)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), None, None, None, out.data_ptr(), None, m, n, k,
        GEMM_EPILOGUES["partial_f32"], 0, _stream())
    _launched(key, err)
    return out


def gemm_gelu_hpre_ref(a, w, bias):
    """Plain version of :func:`gemm_gelu_hpre`."""
    hpre = torch.matmul(a.float(), w.float()) + bias.float().reshape(-1)
    return F.gelu(hpre, approximate="tanh").to(a.dtype), hpre


def gemm_gelu_hpre(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """The merged layer backward's recomputed fc1 (Pallas
    ``_layer_bwd_kernel`` :184-186), GEMM epilogue ``gelu_hpre``: with
    hpre = a @ w + bias in fp32, returns h = tanh-gelu(hpre) rounded to a's
    dtype, (R, N), and hpre itself, (R, N) fp32, which gelu' reads. a:
    (R, K), w: (K, N), bias: (N,). On CUDA a, w and bias are bf16."""
    if _on_cpu(a, w, bias):
        return gemm_gelu_hpre_ref(a, w, bias)
    key = "gemm_bias_epilogue.gelu_hpre"
    m, n, k = _check_gemm(key, a, w, nt=False)
    bias = bias.reshape(-1)
    _require(bias.numel() == n, f"{key}: bias has {bias.numel()} values, want {n}")
    _check_bf16(f"{key} bias", bias)
    h = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    hpre = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), None, None, h.data_ptr(), hpre.data_ptr(),
        m, n, k, GEMM_EPILOGUES["gelu_hpre"], 0, _stream())
    _launched(key, err)
    return h, hpre


GELU_GRAD_TILE = 128  # gemm_nt_gelu_grad writes one column partial per 128 rows
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the tanh-approximate gelu, fp32 (Pallas
    ``fused_layer_vjp._gelu_tanh_grad`` :70)."""
    t = torch.tanh(_SQRT_2_OVER_PI * (x + _GELU_C * x * x * x))
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du


def gemm_nt_gelu_grad_ref(a, w, hpre):
    """Plain version of :func:`gemm_nt_gelu_grad`, with the kernel's
    partials: the column sums of each 128-row tile, (ceil(R / 128), N)."""
    dhpre = torch.matmul(a.float(), w.float().t()) * gelu_tanh_grad(hpre.float())
    r, n = dhpre.shape
    tiles = -(-r // GELU_GRAD_TILE)
    parts = F.pad(dhpre, (0, 0, 0, tiles * GELU_GRAD_TILE - r)).reshape(
        tiles, GELU_GRAD_TILE, n).sum(1)
    return dhpre.to(a.dtype), parts


def gemm_nt_gelu_grad(a: torch.Tensor, w: torch.Tensor, hpre: torch.Tensor):
    """The merged layer backward's MLP step (Pallas ``_layer_bwd_kernel``
    :193-202), GEMM NT epilogue ``gelu_grad``: with dhpre = (a @ w^T) *
    gelu'(hpre) in fp32, returns dhpre rounded to a's dtype, (R, N), and
    the fp32 column partials of the unrounded dhpre, (P, N) with P =
    ceil(R / 128), for the caller to sum over P (db1). a: (R, K) (the
    output cotangent g), w: (N, K) (fc2's (in, out) kernel read as it
    lies), hpre: (R, N) fp32. On CUDA a and w are bf16."""
    if _on_cpu(a, w, hpre):
        return gemm_nt_gelu_grad_ref(a, w, hpre)
    key = "gemm_nt.gelu_grad"
    m, n, k = _check_gemm(key, a, w, nt=True)
    _require(hpre.shape == (m, n) and hpre.dtype == torch.float32 and hpre.is_contiguous()
             and hpre.data_ptr() % 16 == 0, f"{key}: hpre must be contiguous, aligned fp32 "
             f"{(m, n)}")
    dhpre = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    parts = torch.empty((-(-m // GELU_GRAD_TILE), n), dtype=torch.float32, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), None, hpre.data_ptr(), None, dhpre.data_ptr(),
        parts.data_ptr(), m, n, k, GEMM_EPILOGUES["gelu_grad"], 0, _stream())
    _launched(key, err)
    return dhpre, parts


ROWDOT_TILE = 128  # gemm_masked_rowdot writes one partial per 128 output columns


def gemm_masked_rowdot_ref(a, w, bias, g, mask):
    """Plain version of :func:`gemm_masked_rowdot`, with the kernel's
    partials: the row sums over each 128-column group, (R, ceil(N / 128))."""
    proj = torch.matmul(a.float(), w.float()) + bias.float().reshape(-1)
    gf = g.float()
    dproj = (gf * mask.float().reshape(-1, 1)).to(a.dtype)
    r, n = proj.shape
    groups = -(-n // ROWDOT_TILE)
    parts = F.pad(gf * proj, (0, groups * ROWDOT_TILE - n)).reshape(
        r, groups, ROWDOT_TILE).sum(-1)
    return dproj, parts


def gemm_masked_rowdot(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                       mask: torch.Tensor):
    """The head of the masked trainable block's backward, GEMM epilogue
    ``masked_rowdot``: with proj = a @ w + bias in fp32 (never stored),
    returns dproj = (g * mask) rounded to a's dtype, (R, N), and the fp32
    partials of sum(g * proj) per row, (R, P) with P = ceil(N / 128), for
    the caller to sum over P. a: (R, K), w: (K, N), g: (R, N), mask: one
    value per row. On CUDA every tensor is bf16."""
    if _on_cpu(a, w, bias, g, mask):
        return gemm_masked_rowdot_ref(a, w, bias, g, mask)
    key = "gemm_bias_epilogue.masked_rowdot"
    m, n, k = _check_gemm(key, a, w, nt=False)
    bias = bias.reshape(-1)
    _require(bias.numel() == n, f"{key}: bias has {bias.numel()} values, want {n}")
    _require(g.shape == (m, n), f"{key}: g must be {(m, n)}")
    for name, t in (("bias", bias), ("g", g)):
        _check_bf16(f"{key} {name}", t)
    mask = _rows_mask(key, mask, m)
    dproj = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    parts = torch.empty((m, -(-n // ROWDOT_TILE)), dtype=torch.float32, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), g.data_ptr(), mask.data_ptr(),
        dproj.data_ptr(), parts.data_ptr(), m, n, k, GEMM_EPILOGUES["masked_rowdot"], 0,
        _stream())
    _launched(key, err)
    return dproj, parts


# -------------------------------------------------------------- attn_scores_pv


# Head dims the attention kernel is instantiated for (attn_scores_pv.cu):
# 64 (the ViT family), 32 (PCT, MAE) and 48 (the EncDec decoder).
HEAD_DIMS = (64, 32, 48)


def _qscale(hd: int) -> float:
    """The query's pre-scale, head_dim^-0.5 * log2(e) (Pallas ``scale *
    LOG2E``), for the kernel and its plain version alike."""
    return (1.0 / (hd ** 0.5)) * LOG2E


def _check_kmask(qkv, phantom_idx, kmask):
    """The key mask as (B, N), or None. A key mask and a phantom key are
    exclusive: no JAX path combines them."""
    _require(phantom_idx < qkv.shape[1], f"attn_scores_pv: phantom_idx {phantom_idx} "
             f"outside {qkv.shape[1]} keys")
    if kmask is None:
        return None
    _require(phantom_idx < 0, "attn_scores_pv: a key mask and a phantom key are exclusive")
    b, n = qkv.shape[0], qkv.shape[1]
    _require(kmask.numel() == b * n, f"attn_scores_pv: kmask has {kmask.numel()} values "
             f"for {b} images of {n} keys")
    return kmask.reshape(b, n)


def attn_scores_pv_key(head_dim: int, kmask: bool = False, phantom: bool = False) -> str:
    """The launch key of an :func:`attn_scores_pv` call: ``attn_scores_pv``
    plus ``.kmask`` (a key mask) or ``.kweight`` (a phantom key), plus
    ``.hd32`` / ``.hd48`` off head dim 64."""
    key = ("attn_scores_pv.kmask" if kmask else "attn_scores_pv.kweight" if phantom
           else "attn_scores_pv")
    return key + ("" if head_dim == 64 else f".hd{head_dim}")


def attn_scores_pv_plan(b: int, n: int, num_heads: int, head_dim: int = 64) -> dict:
    """The schedule :func:`attn_scores_pv` takes on the card for b images
    of n tokens, chosen by shape inside its C entry point: the kernel
    (``"wgmma"``, the head's K and V resident in shared memory, or
    ``"kept"``, the mma.sync kernel: past 832 tokens at head dim 64, 1,088
    at 48 and 1,728 at 32), the CTAs per (image, head), the wgmma kernel's
    shared memory in bytes and its warpgroups per CTA (the mma.sync
    kernel's: one CTA of one warpgroup per 64 query rows, no dynamic shared
    memory). For the record; needs the built library."""
    out = (ctypes.c_int * 4)()
    _build.extra("attn_scores_pv")(b, n, num_heads, head_dim, out)
    return {"kernel": "wgmma" if out[0] else "kept", "ctas_per_head": out[1], "smem": out[2],
            "warpgroups": out[3]}


def attn_scores_pv_ex2_check() -> dict:
    """The exhaustive check on the card that the kernel's packed exp2 terms
    (cvt / max / min.bf16x2, ex2.approx.ftz.f32) give the bits of the
    earlier scalar bf16(exp2f(bf16(clamp(x)))) for every fp32 logit x, NaN
    and +-Inf included: mismatches, patterns checked (2^32) and the first
    mismatching pattern (None if none). Needs the built library."""
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    err = _build.extra("attn_scores_pv", "peekvit_attn_scores_pv_ex2_check")(
        counts.data_ptr(), _stream())
    if err != 0:
        raise RuntimeError(f"attn_scores_pv ex2 check: launch failed with cudaError_t {err}")
    bad, seen, first = counts.tolist()
    return {"mismatches": bad, "checked": seen,
            "first_mismatch": None if first == 0 else first - (1 << 32)}


def attn_scores_pv_ref(qkv: torch.Tensor, num_heads: int, phantom_idx: int = -1,
                       phantom_mult: float = 0.0, kmask=None) -> torch.Tensor:
    """Plain version of :func:`attn_scores_pv` (Pallas ``_attn_scores_pv``
    applied per image and head; ``kweight`` as the phantom key's weight,
    ``kmask`` as the key mask)."""
    kmask = _check_kmask(qkv, phantom_idx, kmask)
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    dt = qkv.dtype
    heads = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]  # (B, H, N, hd)
    q = (q.float() * _qscale(hd)).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp2(logits.clamp(-80.0, 115.0).to(dt).float()).to(dt)
    if kmask is not None:
        # select, not multiply: an excluded garbage key's NaN term becomes
        # 0, and non-finite values are scrubbed from v (0 * NaN = NaN)
        keep = (kmask.float() > 0.0)[:, None, None, :]
        e = torch.where(keep, e, torch.zeros((), dtype=dt, device=e.device))
        v = torch.where(torch.isfinite(v), v, torch.zeros((), dtype=dt, device=v.device))
    if phantom_idx >= 0:
        weight = torch.ones(n, dtype=dt, device=qkv.device)
        weight[phantom_idx] = phantom_mult
        e = (e.float() * weight.float()).to(dt)
    e = e.float()
    pv = torch.matmul(e, v.float())
    s = e.sum(-1, keepdim=True)
    out = pv * (1.0 / s)
    return out.to(dt).permute(0, 2, 1, 3).reshape(b, n, d)


def attn_scores_pv(qkv: torch.Tensor, num_heads: int, phantom_idx: int = -1,
                   phantom_mult: float = 0.0, kmask=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per image and head over packed qkv
    (B, N, 3D) (head h at columns h*hd, D + h*hd, 2D + h*hd) -> (B, N, D),
    with the Pallas fast-softmax numerics. With ``phantom_idx >= 0`` key
    ``phantom_idx``'s exp term is multiplied by ``phantom_mult`` (rounded
    to the input dtype, as ``kweight``), whatever the multiplier, 0
    included. ``kmask`` (B * N values, (B, N) or (B, 1, N), 1 = attend):
    a key whose mask is not > 0 gets weight 0 for every query, selected
    (not multiplied) so that NaN or Inf in its row cannot leak, and
    non-finite values of v are scrubbed to 0 (Pallas ``kmask``). On CUDA:
    bf16, a bf16 key mask, head dim 64, 48 or 32 (the wgmma kernel; past
    832, 1,088 and 1,728 tokens the mma.sync kernel, see
    :func:`attn_scores_pv_plan`), counted under
    :func:`attn_scores_pv_key`."""
    km = _check_kmask(qkv, phantom_idx, kmask)
    if _on_cpu(qkv, kmask):
        return attn_scores_pv_ref(qkv, num_heads, phantom_idx, phantom_mult, kmask)
    _check_bf16("attn_scores_pv qkv", qkv)
    if km is not None:
        km = km.contiguous()
        _check_bf16("attn_scores_pv kmask", km)
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, "attn_scores_pv: qkv must be (B, N, 3D)")
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    _require(hd in HEAD_DIMS and d == num_heads * hd,
             f"attn_scores_pv: the kernel is built for head dims {HEAD_DIMS}, got D={d}, "
             f"H={num_heads}")
    # the kernels' 16-byte loads: head h's q, k and v start at bytes
    # 2 * h * hd, 2 * (D + h * hd) and 2 * (2D + h * hd) of a 16-byte-aligned row
    _require((2 * hd) % 16 == 0 and (2 * d) % 16 == 0,
             f"attn_scores_pv: head offsets of {2 * hd} and row thirds of {2 * d} bytes must be "
             "multiples of 16")
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=qkv.device)
    err = _build.library("attn_scores_pv")(
        qkv.data_ptr(), out.data_ptr(), None if km is None else km.data_ptr(), b, n, d,
        num_heads, hd, _qscale(hd), int(phantom_idx), float(phantom_mult), _stream())
    _launched(attn_scores_pv_key(hd, km is not None, phantom_idx >= 0), err)
    return out


# ----------------------------------------------- the attention switch's kernels

# The head dims attn_softmax_fwd.cu and attn_softmax_bwd.cu are built for,
# at any token count. Their C entry points choose the kernel by shape (the
# wgmma kernels, the kept backward, or the key-tiled ones where those
# stop); ``softmax_route`` asks them, and a call on a key-tiled kernel is
# counted with ``.tiled`` appended to its key.
SOFTMAX_HEAD_DIMS = (32, 64)
_SOFTMAX_ROUTES = {1: "wgmma", 0: "kept", 2: "tiled"}


@functools.lru_cache(maxsize=None)
def softmax_route(head_dim: int, n: int, backward: bool = False) -> str:
    """The kernel ``attn_softmax_fwd`` (``n`` keys, with or without a key
    mask) or ``attn_softmax_bwd`` (``n`` tokens) runs at ``head_dim`` on
    the card: ``"wgmma"``, ``"kept"`` (the backward only) or ``"tiled"``,
    as its C entry point chooses it
    (``peekvit_attn_softmax_{fwd,bwd}_route``). Needs the built library."""
    _require(head_dim in SOFTMAX_HEAD_DIMS, f"attn_softmax: the kernels are built for head dims "
             f"{SOFTMAX_HEAD_DIMS}, got {head_dim}")
    name = "attn_softmax_bwd" if backward else "attn_softmax_fwd"
    return _SOFTMAX_ROUTES[_build.extra(name)(n, head_dim)]


def softmax_head_dim(key: str, d: int, num_heads: int) -> int:
    """d // num_heads after the softmax kernels' head-dim check."""
    hd = d // num_heads
    _require(hd in SOFTMAX_HEAD_DIMS and d == num_heads * hd,
             f"{key}: the kernel is built for head dims {SOFTMAX_HEAD_DIMS}, got D={d}, "
             f"H={num_heads}")
    return hd


def softmax_key(key: str, head_dim: int, n: int, backward: bool = False) -> str:
    """The launch key of a softmax kernel call: ``key``, plus ``.tiled``
    where the shape takes the key-tiled kernel."""
    return key + (".tiled" if softmax_route(head_dim, n, backward) == "tiled" else "")


def _check_b15(key: str, t: torch.Tensor) -> None:
    if t.dtype == torch.float32:
        raise NotImplementedError(
            f"{key}: the CUDA kernels take bf16 only; fp32 on the card is ROADMAP.md port "
            "queue B item 15 (fp32 on CUDA)")


def fused_mhsa_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_mhsa`."""
    return attn_scores_pv_ref(qkv, num_heads)


def fused_mhsa(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Pallas site 1 (``fused_mhsa``, :153, ``_mhsa_kernel`` :118): all
    heads of packed qkv (B, N, 3D) -> (B, N, D) with the fast softmax of
    ``_attn_scores_pv``, which the linen attention takes under
    ``set_attention_impl("pallas")``. On CUDA it is one ``attn_scores_pv``
    launch (bf16, head dim 64, 32 or 48); an fp32 input raises naming B15."""
    if not _on_cpu(qkv):
        _check_b15("fused_mhsa", qkv)
    return attn_scores_pv(qkv, num_heads)


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Plain version of :func:`fused_attention` (``_attn_kernel`` :168 per
    image and head, without its padding)."""
    dt = q.dtype
    b, n, d = q.shape
    hd = d // num_heads
    qh, kh, vh = (t.float().reshape(b, n, num_heads, hd).transpose(1, 2) for t in (q, k, v))
    s = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / hd ** 0.5), dim=-1)
    out = torch.matmul(s.to(dt).float(), vh).to(dt)
    return out.transpose(1, 2).reshape(b, n, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Pallas site 2 (``fused_attention``, :220): softmax(q k^T / sqrt(hd)) v
    per image and head over separate q, k, v (B, N, D) -> (B, N, D), the
    max-subtracted softmax normalised and rounded to the input dtype
    before PV. On CUDA: ``attn_softmax_fwd``'s kernels on three pointers
    (``attn_softmax_fwd.separate``), bf16, head dim 32 or 64, any N (the
    key-tiled kernel, ``.separate.tiled``, at head dim 32 and past 256
    tokens); an fp32 input raises naming B15."""
    if _on_cpu(q, k, v):
        return fused_attention_ref(q, k, v, num_heads)
    key = "attn_softmax_fwd.separate"
    _check_b15(key, q)
    _require(q.dim() == 3 and k.shape == q.shape and v.shape == q.shape,
             f"{key}: q, k and v must be the same (B, N, D)")
    b, n, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_bf16(f"{key} {name}", t)
    hd = softmax_head_dim(key, d, num_heads)
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=q.device)
    err = _build.library("attn_softmax_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, n, n, d, d, d,
        num_heads, hd ** -0.5, _stream())
    _launched(softmax_key(key, hd, n), err)
    return out


# ------------------------------------------------------------ layer compositions
#
# One composition of the layer, bound twice: to the wrappers (the engine's
# path: kernels on CUDA tensors, plain versions on CPU tensors) and to the
# plain versions alone (``*_ref``, the reference a check holds the kernels
# against on the card).


def _folded_layer(ops, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_heads, eps,
                  kmask=None):
    norm, _, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = norm(x2, eps, x.dtype)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads, kmask=kmask).reshape(b * n, d)
    y = gemm(attn, w_out, b_out, "residual_f32", residual=x2)
    ln2 = norm(y, eps, x.dtype)
    h = gemm(ln2, w1, b1, "gelu")
    return gemm(h, w2, b2, "residual", residual=y).reshape(b, n, d)


def _layer_stack(ops, x, stacked, num_heads, eps):
    for i in range(stacked["wqkv"].shape[0]):
        x = _folded_layer(
            ops, x, stacked["wqkv"][i], stacked["bqkv"][i], stacked["wo"][i],
            stacked["bo"][i], stacked["w1"][i], stacked["b1"][i],
            stacked["w2"][i], stacked["b2"][i], num_heads, eps)
    return x


def _attention_block(ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, eps,
                     kmask=None):
    _, ln_fn, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = ln_fn(x2, ln_scale, ln_bias, eps)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads, kmask=kmask).reshape(b * n, d)
    return gemm(attn, w_out, b_out, "residual", residual=x2).reshape(b, n, d)


def _masked_layer(ops, x, mask, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b,
                  w1, b1, w2, b2, num_heads, eps, phantom_mult, phantom_idx):
    norm, _, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    m = mask.reshape(b * n)
    ln = norm(x2, eps, x.dtype, ln1s, ln1b, m)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads, phantom_idx,
                   phantom_mult).reshape(b * n, d)
    y = gemm(attn, w_out, b_out, "masked_residual_f32", residual=x2, mask=m)
    ln2 = norm(y, eps, x.dtype, ln2s, ln2b, m)
    h = gemm(ln2, w1, b1, "gelu")
    return gemm(h, w2, b2, "residual", residual=y).reshape(b, n, d)


def _avit_layer(ops, x, active, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b, w1, b1,
                w2, b2, num_heads, eps):
    norm, _, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    a = active.reshape(b * n)
    ln = norm(x2, eps, x.dtype, ln1s, ln1b, a, premask=True)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads).reshape(b * n, d)
    y = gemm(attn, w_out, b_out, "residual_f32", residual=x2)
    ln2 = norm(y, eps, x.dtype, ln2s, ln2b, a, premask=True)
    h = gemm(ln2, w1, b1, "gelu")
    return gemm(h, w2, b2, "residual", residual=y).reshape(b, n, d)


def _masked_attention(ops, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                      num_heads, eps, phantom_mult, phantom_idx):
    _, ln_fn, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    m = mask.reshape(b * n)
    ln = ln_fn(x2, ln_scale, ln_bias, eps, m)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads, phantom_idx,
                   phantom_mult).reshape(b * n, d)
    return gemm(attn, w_out, b_out, "masked_residual", residual=x2, mask=m).reshape(b, n, d)


def _mlp_block(ops, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps):
    _, ln_fn, gemm, _ = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = ln_fn(x2, ln_scale, ln_bias, eps, None if mask is None else mask.reshape(b * n))
    h = gemm(ln, w1, b1, "gelu")
    return gemm(h, w2, b2, "residual", residual=x2).reshape(b, n, d)


_KERNELS = (norm_rows, ln_rows, gemm_bias_epilogue, attn_scores_pv)
_PLAIN = (norm_rows_ref, ln_rows_ref, gemm_bias_epilogue_ref, attn_scores_pv_ref)


def fused_layer_block_folded(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                             num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """One pre-LN layer with the LN affines folded into w_qkv/b_qkv and
    w1/b1 (Pallas ``fused_layer_block_folded``, :788). x: (B, N, D). Seven
    launches on CUDA: 2 norm_rows, 4 gemm_bias_epilogue, 1 attn_scores_pv."""
    return _folded_layer(_KERNELS, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                         num_heads, eps)


def fused_layer_block_folded_ref(x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                 num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_layer_block_folded`."""
    return _folded_layer(_PLAIN, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                         num_heads, eps)


def encoder_layers_one_call(x, stacked: dict, num_heads: int,
                            eps: float = 1e-5) -> torch.Tensor:
    """The whole folded stack (Pallas ``encoder_layers_one_call``, :804):
    ``stacked`` holds wqkv/bqkv/wo/bo/w1/b1/w2/b2 with a leading layer
    axis. On the card this is a chain of the per-layer launches, so it
    equals the per-layer calls exactly. x is not modified."""
    return _layer_stack(_KERNELS, x, stacked, num_heads, eps)


def encoder_layers_one_call_ref(x, stacked: dict, num_heads: int,
                                eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`encoder_layers_one_call`."""
    return _layer_stack(_PLAIN, x, stacked, num_heads, eps)


def fused_attention_block(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                          num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x + OutProj(MHSA(LN(x))) with two-pass LN and unfolded affine
    (Pallas ``fused_attention_block``, :283). x: (B, N, D)."""
    return _attention_block(_KERNELS, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                            b_out, num_heads, eps)


def fused_attention_block_ref(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                              num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_attention_block`."""
    return _attention_block(_PLAIN, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                            b_out, num_heads, eps)


def masked_layer_block(x, mask, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b,
                       w1, b1, w2, b2, num_heads: int, eps: float = 1e-6,
                       phantom_mult: float = 0.0, phantom_idx: int = -1) -> torch.Tensor:
    """The ResidualViT layer (Pallas ``masked_layer_block``, :767:
    ``_layer_kernel`` mode ``masked``, unfolded affines). x: (B, N, D),
    mask: (B, N, 1) in x's dtype. mask * LN on both sublayers (one-pass
    statistics), the attention output masked, the fp32 mid residual
    y = (attn Wo + bo) * mask + x, and an unmasked MLP output
    y + fc2(gelu(fc1(mask * LN(y)))). ``phantom_idx >= 0`` weights that key
    by ``phantom_mult`` (the compaction engine's phantom slot, any
    multiplier, 0 included). Seven launches on CUDA: 2 ``norm_rows.masked``,
    4 ``gemm_bias_epilogue``, 1 ``attn_scores_pv``."""
    return _masked_layer(_KERNELS, x, mask, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out,
                         ln2s, ln2b, w1, b1, w2, b2, num_heads, eps, phantom_mult, phantom_idx)


def masked_layer_block_ref(x, mask, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b,
                           w1, b1, w2, b2, num_heads: int, eps: float = 1e-6,
                           phantom_mult: float = 0.0, phantom_idx: int = -1) -> torch.Tensor:
    """Plain version of :func:`masked_layer_block`."""
    return _masked_layer(_PLAIN, x, mask, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out,
                         ln2s, ln2b, w1, b1, w2, b2, num_heads, eps, phantom_mult, phantom_idx)


def masked_attention_block(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                           num_heads: int, eps: float = 1e-6, phantom_mult: float = 0.0,
                           phantom_idx: int = -1) -> torch.Tensor:
    """x + mask * OutProj(MHSA(mask * LN(x))) with two-pass LN, rounded to
    x's dtype (Pallas ``masked_attention_block``, :442). x: (B, N, D), mask:
    (B, N, 1). Four launches on CUDA: ``ln_rows.masked``, GEMM ``bias``,
    ``attn_scores_pv``, GEMM ``masked_residual``."""
    return _masked_attention(_KERNELS, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                             b_out, num_heads, eps, phantom_mult, phantom_idx)


def masked_attention_block_ref(x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                               num_heads: int, eps: float = 1e-6, phantom_mult: float = 0.0,
                               phantom_idx: int = -1) -> torch.Tensor:
    """Plain version of :func:`masked_attention_block`."""
    return _masked_attention(_PLAIN, x, mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                             b_out, num_heads, eps, phantom_mult, phantom_idx)


def masked_mlp_block(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                     eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu(fc1(mask * LN(x)))) with two-pass LN; the output is not
    masked (Pallas ``masked_mlp_block``, :468). Three launches on CUDA:
    ``ln_rows.masked``, GEMM ``gelu``, GEMM ``residual``."""
    return _mlp_block(_KERNELS, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)


def masked_mlp_block_ref(x, mask, ln_scale, ln_bias, w1, b1, w2, b2,
                         eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`masked_mlp_block`."""
    return _mlp_block(_PLAIN, x, mask, ln_scale, ln_bias, w1, b1, w2, b2, eps)


def fused_mlp_block(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """x + fc2(tanh-gelu(fc1(LN(x)))) with two-pass LN and unfolded affine,
    rounded to x's dtype (Pallas ``fused_mlp_block``, :343, body
    ``_mlp_block_kernel`` :317). x: (B, N, D). Three launches on CUDA:
    ``ln_rows``, GEMM ``gelu``, GEMM ``residual`` (bf16 residual)."""
    return _mlp_block(_KERNELS, x, None, ln_scale, ln_bias, w1, b1, w2, b2, eps)


def fused_mlp_block_ref(x, ln_scale, ln_bias, w1, b1, w2, b2,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`fused_mlp_block`."""
    return _mlp_block(_PLAIN, x, None, ln_scale, ln_bias, w1, b1, w2, b2, eps)


def keymasked_attention_block(x, key_mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                              num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x + OutProj(MHSA(LN(x))) with key exclusion (Pallas
    ``keymasked_attention_block``, :536, body ``_keymasked_attn_kernel``
    :494). x: (B, N, D); key_mask: (B, 1, N), 1 = attend, 0 = exclude, in
    x's dtype. Four launches on CUDA: ``ln_rows``, GEMM ``bias``,
    ``attn_scores_pv.kmask``, GEMM ``residual`` (bf16 residual)."""
    return _attention_block(_KERNELS, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                            num_heads, eps, key_mask)


def keymasked_attention_block_ref(x, key_mask, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                                  b_out, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`keymasked_attention_block`."""
    return _attention_block(_PLAIN, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                            num_heads, eps, key_mask)


def keymasked_layer_block_folded(x, key_mask, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                 num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """One pre-LN layer with the LN affines folded and key exclusion (Pallas
    ``keymasked_layer_block_folded``, :887: ``_layer_kernel`` mode
    ``keymasked``, folded). The key mask only gates the attention scores,
    so the folded LN stays exact; one-pass norms and the fp32 mid residual
    as :func:`fused_layer_block_folded`. x: (B, N, D); key_mask: (B, 1, N)
    in x's dtype. Seven launches on CUDA, the attention's
    ``attn_scores_pv.kmask``."""
    return _folded_layer(_KERNELS, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                         num_heads, eps, key_mask)


def keymasked_layer_block_folded_ref(x, key_mask, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                                     num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`keymasked_layer_block_folded`."""
    return _folded_layer(_PLAIN, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2,
                         num_heads, eps, key_mask)


def avit_layer_block(x, active, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b, w1, b1,
                     w2, b2, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The A-ViT layer (Pallas ``avit_layer_block``, :904: ``_layer_kernel``
    mode ``avit``, unfolded affines). x: (B, N, D); active: (B, N, 1) in
    x's dtype, any value (the ACT engine's 0/1 still-computing mask).
    LN(x * a) * a on both sublayers (one-pass statistics), unmasked
    residual adds with the fp32 mid residual y = attn Wo + bo + x, and
    y + fc2(gelu(fc1(LN(y * a) * a))). Tokens with a = 0 stay keys with
    the bias-only values, as in the Pallas kernel. Seven launches on CUDA:
    2 ``norm_rows.avit``, 4 ``gemm_bias_epilogue``, 1 ``attn_scores_pv``."""
    return _avit_layer(_KERNELS, x, active, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b,
                       w1, b1, w2, b2, num_heads, eps)


def avit_layer_block_ref(x, active, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b, w1,
                         b1, w2, b2, num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of :func:`avit_layer_block`."""
    return _avit_layer(_PLAIN, x, active, ln1s, ln1b, w_qkv, b_qkv, w_out, b_out, ln2s, ln2b,
                       w1, b1, w2, b2, num_heads, eps)
