"""The plain versions of the two kernels redesigned for Hopper's wgmma and
TMA, ``attn_scores_pv`` (all four modes) and the int8 GEMM
``gemm_s8_epilogue`` (all six epilogues), at the shapes where the CUDA
kernels change their chunking, padding or tiling, on the CPU.

``attn_scores_pv_ref`` is held against JAX's ``_attn_scores_pv`` per image
and head at token counts around the kernel's 16-key slices and 64-key
chunks (1, 15-17, 63-65, 197, 208, 256, 257) at head dim 64 and at 64 and
1024 tokens at head dim 32, plain, with the phantom key weight (mult 0 and
45) and with a key mask whose excluded rows hold NaN and Inf: fp32 within
2e-5, bf16 within 3e-2 (the two packages' fp32 sums in another order can
flip a bf16 rounding of a logit or of the output). ``gemm_s8_epilogue_ref``
is held against an exact int64 product and against ``_qmatmul`` and the
epilogue's steps in JAX at ragged M, N and K (K = 16 is below one 128-byte
stage of the kernel's ring): bit for bit where both packages take the same
fp32 steps, within 1e-6 for the tanh-gelu (the two packages' tanh). On the
CPU each wrapper is its plain version, bit for bit, and counts no launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.ops.pallas import quant_blocks as jq
from peekvit_tpu.ops.pallas.fused_attention import _attn_scores_pv
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import quant_blocks as tq

D = 128  # two heads of 64, four of 32
IMAGES = 2
TOKENS = [(64, n) for n in (1, 15, 16, 17, 63, 64, 65, 197, 208, 256, 257)] + [(32, 64),
                                                                              (32, 1024)]
MODES = ("plain", "kweight0", "kweight45", "kmask")
JAX_MODES = {"plain": "plain", "kweight0": "kweight", "kweight45": "kweight", "kmask": "kmask"}
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _jax_heads(qkv, num_heads, mode, kvec):
    """``_attn_scores_pv`` per image and head of a packed qkv (B, N, 3D),
    with ``kvec`` (B, N) the key mask ("kmask") or the key weight
    ("kweight") -> (B, N, D) in qkv's dtype."""
    b, n, three_d = qkv.shape
    hd = three_d // 3 // num_heads
    heads = qkv.reshape(b, n, 3, num_heads, hd).transpose(2, 0, 3, 1, 4)  # (3, B, H, N, hd)

    def one(q, k, v, kv):
        kw = {"kmask": kv} if mode == "kmask" else (
            {"kweight": kv[None, :]} if mode == "kweight" else {})
        return _attn_scores_pv(q, k, v, 1.0 / hd ** 0.5, **kw).astype(qkv.dtype)

    out = jax.vmap(jax.vmap(one, (0, 0, 0, None)), (0, 0, 0, 0))(heads[0], heads[1], heads[2],
                                                                   kvec)
    return out.transpose(0, 2, 1, 3).reshape(b, n, three_d // 3)


@functools.lru_cache(maxsize=None)
def _jax_every_mode(hd, n):
    """JAX's attention on every mode's inputs (_inputs), in fp32 and in
    bf16: {(mode, dtype): (B, N, D) fp32}, from one jitted function, so one
    compilation per (head dim, N) serves its eight cases."""
    inputs = [_inputs(hd, n, mode) for mode in MODES]

    @jax.jit
    def every(qkv, kvec):
        return {(mode, name): _jax_heads(qkv[i].astype(jdt), D // hd, JAX_MODES[mode], kvec[i])
                for i, mode in enumerate(MODES) for name, (jdt, _, _) in DTYPES.items()}

    out = every(jnp.asarray(np.stack([q for q, _ in inputs])),
                jnp.asarray(np.stack([k for _, k in inputs])))
    return {key: np.asarray(v, np.float32) for key, v in out.items()}


def _inputs(hd, n, mode):
    """Seeded qkv (B, N, 3D) and, for "kmask", the (B, N) mask with about
    half of each image's keys excluded (key 0 kept) and every excluded row
    poisoned with NaN, +Inf and -Inf."""
    rng = np.random.default_rng(1000 * hd + n)
    qkv = rng.normal(size=(IMAGES, n, 3 * D)).astype(np.float32)
    kvec = np.ones((IMAGES, n), np.float32)
    if mode == "kmask":
        kvec = (rng.uniform(size=(IMAGES, n)) < 0.5).astype(np.float32)
        kvec[:, 0] = 1.0
        poison = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                            size=(IMAGES, n, 3 * D))
        qkv = np.where(kvec[..., None] > 0, qkv, poison)
    elif mode.startswith("kweight"):
        kvec[:, n - 1] = float(mode[len("kweight"):])
    return qkv, kvec


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("hd,n", TOKENS)
def test_attn_scores_pv_against_jax_at_the_kernel_edges(hd, n, mode, dtype):
    """The plain attention against ``_attn_scores_pv`` per image and head
    (the phantom key, at the last token, weighted by ``kweight``; the key
    mask selecting, with NaN / Inf in the excluded rows: only the attended
    rows are compared, and they equal those of the same input with the
    excluded rows made finite); the wrapper is the plain version, bit for
    bit, with no launch."""
    _, tdt, tol = DTYPES[dtype]
    heads = D // hd
    qkv, kvec = _inputs(hd, n, mode)
    x = torch.from_numpy(qkv).to(tdt)
    kw = {}
    if mode == "kmask":
        kw = {"kmask": torch.from_numpy(kvec).to(tdt)}
    elif mode.startswith("kweight"):
        kw = {"phantom_idx": n - 1, "phantom_mult": float(kvec[0, n - 1])}
    tfa.reset_launch_counts()
    got = tfa.attn_scores_pv(x, heads, **kw)
    assert tfa.LAUNCHES == {} and got.dtype == tdt and got.shape == (IMAGES, n, D)
    torch.testing.assert_close(got, tfa.attn_scores_pv_ref(x, heads, **kw), rtol=0, atol=0,
                               equal_nan=True)
    want = _jax_every_mode(hd, n)[(mode, dtype)]
    rows = kvec > 0 if mode == "kmask" else np.ones((IMAGES, n), bool)
    got_np = got.float().numpy()
    # a phantom of weight 0 as the only key leaves an empty softmax: 0 / 0
    # in both packages
    assert np.isfinite(got_np[rows]).all() == (n > 1 or mode != "kweight0")
    np.testing.assert_allclose(got_np[rows], want[rows], rtol=tol, atol=tol, equal_nan=True)
    if mode == "kmask":
        clean = torch.from_numpy(np.where(np.isfinite(qkv), qkv, 0.5).astype(np.float32)).to(tdt)
        assert torch.equal(tfa.attn_scores_pv(clean, heads, **kw)[torch.from_numpy(rows)],
                           got[torch.from_numpy(rows)])


S8_M = (1, 127, 129, 300)
S8_N = (8, 136, 264)
S8_K = (16, 144, 784)
EPILOGUES = ("bias", "gelu_f32", "residual_f32", "residual", "masked_residual_f32",
             "masked_residual")


def _s8_inputs(m, n, k, epilogue):
    rng = np.random.default_rng(m * 10007 + n * 101 + k)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    sa = rng.uniform(0.001, 0.05, size=(m, 1)).astype(np.float32)
    sw = rng.uniform(0.001, 0.05, size=(1, n)).astype(np.float32)
    bias = rng.normal(scale=0.1, size=n).astype(np.float32)
    res = rng.normal(size=(m, n)).astype(np.float32)
    mask = rng.uniform(size=m).astype(np.float32)
    mask[::3] = 0.0
    # the residual in the type the engines pass: bf16 beside a bf16 output
    res_dtype = torch.float32 if epilogue in ("residual", "masked_residual_f32") else torch.bfloat16
    res_t = torch.from_numpy(res).to(res_dtype) if "residual" in epilogue else None
    mask_t = torch.from_numpy(mask).to(torch.bfloat16) if epilogue.startswith("masked") else None
    return a, w, sa, sw, bias, res_t, mask_t


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("k", S8_K)
@pytest.mark.parametrize("n", S8_N)
@pytest.mark.parametrize("m", S8_M)
def test_gemm_s8_epilogue_ref_at_the_kernel_edges(m, n, k, epilogue):
    """The plain int8 GEMM at ragged M, N and K: its fp32 value is the
    exact int64 product rounded once, then _qmatmul's dequant order
    (float(acc) * s_row * s_col, + bias, the epilogue) as JAX computes it;
    the (in, out) view of an (out, in) copy (the kernel's layout) gives the
    same bits; the wrapper is the plain version, bit for bit, with no
    launch."""
    a, w, sa, sw, bias, res, mask = _s8_inputs(m, n, k, epilogue)
    bias_t = torch.from_numpy(bias).to(torch.bfloat16)
    args = (torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(w),
            torch.from_numpy(sw), bias_t, epilogue)
    tfa.reset_launch_counts()
    got = tq.gemm_s8_epilogue(*args, residual=res, mask=mask)
    assert tfa.LAUNCHES == {} and got.shape == (m, n)
    assert torch.equal(got, tq.gemm_s8_epilogue_ref(*args, residual=res, mask=mask))
    laid = tq.kernel_layout(torch.from_numpy(w))
    assert laid.t().is_contiguous() and torch.equal(laid, torch.from_numpy(w))
    assert torch.equal(tq.gemm_s8_epilogue(args[0], args[1], laid, *args[3:], residual=res,
                                           mask=mask), got)

    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() < 2 ** 24  # exact in fp32 too: the rounding is the identity
    acc = jq._qmatmul(jnp.asarray(a), jnp.asarray(sa), jnp.asarray(w), jnp.asarray(sw))
    np.testing.assert_array_equal(
        np.asarray(acc), (exact.astype(np.float32) * sa) * sw)
    v = acc + jnp.asarray(bias_t.float().numpy())
    if epilogue == "gelu_f32":
        v = jax.nn.gelu(v)
    if mask is not None:
        v = v * jnp.asarray(mask.float().numpy())[:, None]
    if res is not None:
        v = v + jnp.asarray(res.float().numpy())
    want = np.asarray(v, np.float32)
    if got.dtype == torch.bfloat16:
        want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32)
    tol = 1e-6 if epilogue == "gelu_f32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("k", S8_K)
def test_gemm_s8_epilogue_ref_static_scale(k):
    """A static cap's scale (one Python float for every row) at every K,
    M = 129 and N = 136, against _qmatmul fed that scale per row."""
    m, n = 129, 136
    a, w, _, sw, bias, _, _ = _s8_inputs(m, n, k, "bias")
    bias_t = torch.from_numpy(bias).to(torch.bfloat16)
    scale = tq.static_scale(2.5)
    got = tq.gemm_s8_epilogue(torch.from_numpy(a), scale, torch.from_numpy(w),
                              torch.from_numpy(sw), bias_t, "bias")
    sa = np.full((m, 1), scale, np.float32)
    v = jq._qmatmul(jnp.asarray(a), jnp.asarray(sa), jnp.asarray(w), jnp.asarray(sw))
    want = (v + jnp.asarray(bias_t.float().numpy())).astype(jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
