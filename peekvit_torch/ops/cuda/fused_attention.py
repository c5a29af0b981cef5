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
serves the trainable block's backward (fused_attention_vjp.py).

Dispatch is by device only. A wrapper uses the plain version for CPU
tensors; for CUDA tensors it launches its kernel or raises (wrong dtype,
shape, contiguity, a failed build or launch). Nothing sends a CUDA tensor
to a plain version. ``LAUNCHES`` counts kernel launches by kernel and
variant; :func:`reset_launch_counts` zeroes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from peekvit_torch.ops.cuda import _build

LOG2E = 1.4426950408889634  # exp(x) = exp2(x * LOG2E)

LAUNCHES: dict[str, int] = {}
_EPILOGUES = {"bias": 0, "gelu": 1, "residual_f32": 2, "residual": 3}
_NT_EPILOGUES = {"none": 4, "none_f32": 5}  # W read as (N, K), no bias


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


def norm_rows_ref(x: torch.Tensor, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of :func:`norm_rows` (Pallas ``_norm_rows``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    ms = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(out_dtype)


def ln_rows_ref(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Plain version of :func:`ln_rows`: two-pass LN with affine, rounded
    to x's dtype (Pallas ``_attn_block_kernel`` :253-258)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float().reshape(-1) + bias.float().reshape(-1)
    return out.to(x.dtype)


def _norm_launch(key, x, scale, bias, eps, two_pass):
    _require(x.dtype in (torch.bfloat16, torch.float32),
             f"{key}: input must be bf16 or fp32, got {x.dtype}")
    _require(x.is_contiguous() and x.data_ptr() % 16 == 0,
             f"{key}: input must be contiguous and 16-byte aligned")
    d = x.shape[-1]
    _require(d % 8 == 0, f"{key}: row width {d} must be a multiple of 8")
    if two_pass:
        _check_bf16(f"{key} scale", scale)
        _check_bf16(f"{key} bias", bias)
        _require(scale.numel() == d and bias.numel() == d, f"{key}: affine must have {d} values")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    err = _build.library("norm_rows")(
        x.data_ptr(), int(x.dtype == torch.float32),
        scale.data_ptr() if two_pass else None, bias.data_ptr() if two_pass else None,
        out.data_ptr(), x.numel() // d, d, float(eps), int(two_pass), _stream())
    _launched(key, err)
    return out


def norm_rows(x: torch.Tensor, eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """Row normalization with one-pass statistics and no affine, rounded to
    ``out_dtype``. x: (..., D), bf16 or fp32. On CUDA the output must be bf16."""
    if _on_cpu(x):
        return norm_rows_ref(x, eps, out_dtype)
    _require(out_dtype == torch.bfloat16, "norm_rows: the kernel writes bf16 only")
    key = "norm_rows.f32" if x.dtype == torch.float32 else "norm_rows.bf16"
    return _norm_launch(key, x, None, None, eps, two_pass=False)


def ln_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """Two-pass LayerNorm with affine, rounded to x's dtype (the split path's
    LN). On CUDA, x, scale and bias are bf16."""
    if _on_cpu(x, scale, bias):
        return ln_rows_ref(x, scale, bias, eps)
    _check_bf16("ln_rows x", x)
    return _norm_launch("ln_rows", x, scale.reshape(-1), bias.reshape(-1), eps,
                        two_pass=True)


# --------------------------------------------------------- gemm_bias_epilogue


def gemm_bias_epilogue_ref(a, w, bias, epilogue: str, residual=None):
    """Plain version of :func:`gemm_bias_epilogue`: fp32 products and sums,
    one rounding at the end."""
    acc = torch.matmul(a.float(), w.float()) + bias.float().reshape(-1)
    if epilogue == "gelu":
        acc = F.gelu(acc, approximate="tanh")
    elif epilogue in ("residual_f32", "residual"):
        acc = acc + residual.float()
    elif epilogue != "bias":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return acc if epilogue == "residual_f32" else acc.to(a.dtype)


def gemm_bias_epilogue(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       epilogue: str, residual: torch.Tensor | None = None) -> torch.Tensor:
    """C = a @ w + bias with a fused epilogue. a: (R, K), w: (K, N) (the
    (in, out) layout), bias: (N,) or (1, N). ``epilogue``:

    - ``"bias"``: -> a.dtype (qkv);
    - ``"gelu"``: tanh-gelu -> a.dtype (fc1);
    - ``"residual_f32"``: + residual -> fp32 (out-proj, the mid-layer y);
    - ``"residual"``: + residual -> a.dtype (fc2, split-path out-proj).

    The residual is (R, N), fp32 or a.dtype."""
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    needs_res = epilogue.startswith("residual")
    _require((residual is not None) == needs_res,
             f"epilogue {epilogue!r} {'needs' if needs_res else 'takes no'} residual")
    if _on_cpu(a, w, bias, residual):
        return gemm_bias_epilogue_ref(a, w, bias, epilogue, residual)
    key = f"gemm_bias_epilogue.{epilogue}"
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[0],
             f"{key}: shapes {tuple(a.shape)} @ {tuple(w.shape)} do not chain")
    m, k = a.shape
    n = w.shape[1]
    _require(k % 32 == 0, f"{key}: K={k} must be a multiple of 32")
    _require(n % 8 == 0, f"{key}: N={n} must be a multiple of 8")
    bias = bias.reshape(-1)
    _require(bias.numel() == n, f"{key}: bias has {bias.numel()} values, want {n}")
    for name, t in (("a", a), ("w", w), ("bias", bias)):
        _check_bf16(f"{key} {name}", t)
    res_f32 = 0
    if needs_res:
        _require(residual.shape == (m, n), f"{key}: residual must be {(m, n)}")
        _require(residual.dtype in (torch.float32, torch.bfloat16),
                 f"{key}: residual must be fp32 or bf16")
        _require(residual.is_contiguous() and residual.data_ptr() % 16 == 0,
                 f"{key}: residual must be contiguous and 16-byte aligned")
        res_f32 = int(residual.dtype == torch.float32)
    out_dtype = torch.float32 if epilogue == "residual_f32" else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        residual.data_ptr() if needs_res else None, out.data_ptr(),
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
    _require(a.dim() == 2 and w.dim() == 2 and a.shape[1] == w.shape[1],
             f"{key}: shapes {tuple(a.shape)} @ {tuple(w.shape)}^T do not chain")
    m, k = a.shape
    n = w.shape[0]
    _require(k % 32 == 0, f"{key}: K={k} must be a multiple of 32")
    _require(n % 8 == 0, f"{key}: N={n} must be a multiple of 8")
    for name, t in (("a", a), ("w", w)):
        _check_bf16(f"{key} {name}", t)
    out_dtype = torch.float32 if epilogue == "none_f32" else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _build.library("gemm_bias_epilogue")(
        a.data_ptr(), w.data_ptr(), None, None, out.data_ptr(), m, n, k,
        _NT_EPILOGUES[epilogue], 0, _stream())
    _launched(key, err)
    return out


# -------------------------------------------------------------- attn_scores_pv


def attn_scores_pv_ref(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of :func:`attn_scores_pv` (Pallas ``_attn_scores_pv``
    without kmask/kweight, applied per image and head)."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    dt = qkv.dtype
    heads = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]  # (B, H, N, hd)
    scale = 1.0 / (hd ** 0.5)
    q = (q.float() * (scale * LOG2E)).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp2(logits.clamp(-80.0, 115.0).to(dt).float()).to(dt).float()
    pv = torch.matmul(e, v.float())
    s = e.sum(-1, keepdim=True)
    out = pv * (1.0 / s)
    return out.to(dt).permute(0, 2, 1, 3).reshape(b, n, d)


def attn_scores_pv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per image and head over packed qkv
    (B, N, 3D) (head h at columns h*hd, D + h*hd, 2D + h*hd) -> (B, N, D),
    with the Pallas fast-softmax numerics. On CUDA: bf16, head dim 64."""
    if _on_cpu(qkv):
        return attn_scores_pv_ref(qkv, num_heads)
    _check_bf16("attn_scores_pv qkv", qkv)
    _require(qkv.dim() == 3 and qkv.shape[-1] % 3 == 0, "attn_scores_pv: qkv must be (B, N, 3D)")
    b, n, three_d = qkv.shape
    d = three_d // 3
    _require(d == num_heads * 64,
             f"attn_scores_pv: the kernel is built for head dim 64, got D={d}, H={num_heads}")
    out = torch.empty((b, n, d), dtype=torch.bfloat16, device=qkv.device)
    qscale = (1.0 / math.sqrt(64)) * LOG2E
    err = _build.library("attn_scores_pv")(
        qkv.data_ptr(), out.data_ptr(), b, n, d, num_heads, qscale, _stream())
    _launched("attn_scores_pv", err)
    return out


# ------------------------------------------------------------ layer compositions
#
# One composition of the layer, bound twice: to the wrappers (the engine's
# path: kernels on CUDA tensors, plain versions on CPU tensors) and to the
# plain versions alone (``*_ref``, the reference a check holds the kernels
# against on the card).


def _folded_layer(ops, x, w_qkv, b_qkv, w_out, b_out, w1, b1, w2, b2, num_heads, eps):
    norm, _, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = norm(x2, eps, x.dtype)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads).reshape(b * n, d)
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


def _attention_block(ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, eps):
    _, ln_fn, gemm, attn_fn = ops
    b, n, d = x.shape
    x2 = x.reshape(b * n, d)
    ln = ln_fn(x2, ln_scale, ln_bias, eps)
    qkv = gemm(ln, w_qkv, b_qkv, "bias")
    attn = attn_fn(qkv.reshape(b, n, 3 * d), num_heads).reshape(b * n, d)
    return gemm(attn, w_out, b_out, "residual", residual=x2).reshape(b, n, d)


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
