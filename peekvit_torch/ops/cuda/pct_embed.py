"""The PCT embedding kernel: point clouds to encoder tokens, gather-free
(counterpart of peekvit_tpu/ops/pallas/pct_embed.py).

The ARPE embedding (reference models/pct.py:60-90) is, per point i::

    max-pool_{j in kNN(i)} elu(BN1(lin1([x_i, x_i - x_j]))) -> lin2 -> BN2 -> elu

With BN1's running-statistics affine folded into lin1 (``prepare_pct_
engine_params``: W' = W * inv * scale per output channel, b' = (b -
mean) * inv * scale + bias) the neighbour term splits as
elu(c_i + max_{j in kNN(i)} g_j) per channel, c_i = x_i (Wa' + Wb') + b1',
g_j = -x_j Wb', and the kNN set is every j with d2_ij at most the row's
k-th smallest distance, found by 30 bisection steps on [0, max_j d2_ij]:
no top-k, no gather. Points tied at the k-th distance are all included.

:func:`arpe_tokens` takes the Pallas kernel's contract (``_arpe_kernel``,
:55-105), not its lane padding: points (B, N, 3) fp32, the BN-folded pack
``wc`` = Wa' + Wb' (3, 6), ``wb`` = Wb' (3, 6), ``b1`` (6,), ``w2``
(6, d), ``b2`` (d,), all fp32, and k; it returns (B, N, d) tokens in fp32
or rounded once to bf16 (the JAX engine casts the fp32 output to the
compute dtype, inference.py:555-557). On CUDA it launches
``csrc/arpe_tokens.cu`` (N up to 1024), which finds each row's k-th
smallest distance v_k by one exact radix selection and replays the 30
steps deciding each by v_k <= mid (the count reaches k exactly then), so
its thresholds are the counting bisection's; on CPU tensors it runs
:func:`arpe_tokens_ref`.

The plain version fixes the order of every fp32 operation that decides a
neighbour set, and the kernel repeats it with ``__fmul_rn`` /
``__fadd_rn`` (no FMA contraction): sq = (x x + y y) + z z,
<p_i, p_j> = (x_i x_j + y_i y_j) + z_i z_j, d2 = (sq_i + sq_j) -
2 <p_i, p_j>, mid = 0.5 (lo + hi), g = -((x wb0 + y wb1) + z wb2); c and
the lin2 sum (the six channels in order, then + b2) likewise. So the two
select the same neighbours, the masked max agrees exactly, and only the
exponentials of the two elus differ by rounding. No ``torch.matmul``
takes part: its K = 3 sums would run in another order.
"""

from __future__ import annotations

import torch

from peekvit_torch.ops.cuda import _build
from peekvit_torch.ops.cuda.fused_attention import _launched, _on_cpu, _require, _stream

BISECT_ITERS = 30      # pct_embed.py:39 _BISECT_ITERS
MAX_POINTS = 1024      # the kernel keeps a row's distances in registers, 32 per lane
NEG = -3.4e38          # the Pallas kernel's masked-max fill
CHANNELS = 6           # lin1's width: [point | diff] of 3 coordinates


def elu(x: torch.Tensor) -> torch.Tensor:
    """elu as the Pallas kernel takes it (``_elu``, :50-52):
    exp(min(x, 0)) - 1 below 0, not expm1."""
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _xyz_dot(x, y, z, w):
    """(x w0 + y w1) + z w2 for coordinates (..., 1) and a (3, c) weight."""
    return x * w[0] + y * w[1] + z * w[2]


def arpe_tokens_ref(points: torch.Tensor, wc: torch.Tensor, wb: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, k: int,
                    out_dtype: torch.dtype = torch.float32, knn_stats: bool = False):
    """Plain version of :func:`arpe_tokens`: materialises the (B, N, N)
    distances, runs the same 30 bisection steps and takes a
    ``torch.where`` max per channel, in the kernel's order of operations."""
    p = points.float()
    wc, wb, b1, w2, b2 = (t.float() for t in (wc, wb, b1.reshape(-1), w2, b2.reshape(-1)))
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]          # (B, N, 1)
    sq = x * x + y * y + z * z                                 # (B, N, 1)
    xt, yt, zt = (c.transpose(1, 2) for c in (x, y, z))        # (B, 1, N)
    dot = x * xt + y * yt + z * zt                             # (B, N, N)
    d2 = (sq + sq.transpose(1, 2)) - 2.0 * dot
    lo = torch.zeros_like(sq)
    hi = d2.amax(-1, keepdim=True)
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = (d2 <= mid).sum(-1, keepdim=True) >= k
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    mask = d2 <= hi
    g = -_xyz_dot(x, y, z, wb)                                 # (B, N, 6)
    neigh = torch.stack([torch.where(mask, g[..., ch][:, None, :], NEG).amax(-1)
                         for ch in range(g.shape[-1])], dim=-1)
    h = elu(_xyz_dot(x, y, z, wc) + b1 + neigh)
    acc = h[..., 0:1] * w2[0]
    for ch in range(1, h.shape[-1]):
        acc = acc + h[..., ch:ch + 1] * w2[ch]
    tokens = elu(acc + b2).to(out_dtype)
    if knn_stats:
        return tokens, hi[..., 0], mask.sum(-1).to(torch.int32)
    return tokens


def arpe_tokens(points: torch.Tensor, wc: torch.Tensor, wb: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, k: int,
                out_dtype: torch.dtype = torch.float32, knn_stats: bool = False):
    """ARPE tokens of point clouds (B, N, 3) -> (B, N, d) in ``out_dtype``
    (fp32 or bf16), from the BN-folded pack (module docstring). With
    ``knn_stats`` also returns each row's kNN threshold (the bisection's
    final upper end, fp32 (B, N)) and its neighbour count (int32 (B, N)).
    On CUDA every input is fp32 and contiguous, 1 <= k <= N <= 1024."""
    if _on_cpu(points, wc, wb, b1, w2, b2):
        return arpe_tokens_ref(points, wc, wb, b1, w2, b2, k, out_dtype, knn_stats)
    key = "arpe_tokens"
    _require(points.dim() == 3 and points.shape[-1] == 3, f"{key}: points must be (B, N, 3)")
    bsz, n, _ = points.shape
    b1, b2 = b1.reshape(-1), b2.reshape(-1)
    d = w2.shape[-1]
    for name, t, shape in (("points", points, (bsz, n, 3)), ("wc", wc, (3, CHANNELS)),
                           ("wb", wb, (3, CHANNELS)), ("b1", b1, (CHANNELS,)),
                           ("w2", w2, (CHANNELS, d)), ("b2", b2, (d,))):
        _require(tuple(t.shape) == shape, f"{key}: {name} has shape {tuple(t.shape)}, want {shape}")
        _require(t.dtype == torch.float32 and t.is_contiguous(),
                 f"{key}: {name} must be contiguous fp32")
    _require(n <= MAX_POINTS, f"{key}: the kernel takes at most {MAX_POINTS} points, got {n}")
    _require(1 <= k <= n, f"{key}: k={k} must lie in [1, {n}]")
    _require(out_dtype in (torch.float32, torch.bfloat16), f"{key}: out_dtype must be fp32 or bf16")
    out = torch.empty((bsz, n, d), dtype=out_dtype, device=points.device)
    kth = cnt = None
    if knn_stats:
        kth = torch.empty((bsz, n), dtype=torch.float32, device=points.device)
        cnt = torch.empty((bsz, n), dtype=torch.int32, device=points.device)
    err = _build.library("arpe_tokens")(
        points.data_ptr(), wc.data_ptr(), wb.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        None if kth is None else kth.data_ptr(), None if cnt is None else cnt.data_ptr(),
        bsz, n, d, int(k), _stream())
    _launched(key, err)
    return (out, kth, cnt) if knn_stats else out
