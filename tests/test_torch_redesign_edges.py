"""The plain versions of the two kernels redesigned for Hopper's wgmma and
TMA, ``attn_softmax_bwd`` and the GEMM epilogues ``masked_rowdot`` and
``gelu_grad``, at the shapes where the CUDA kernels change their padding,
tiling or instance, on the CPU.

``attn_softmax_bwd_ref`` is held against the head core of the Pallas
saved-qkv backward (``_attn_bwd_kernel_saved``) in interpret mode; the
two GEMM epilogues' partials keep the kernel's grouping (one partial per
128 columns, one per 128 rows), pinned here at ragged sizes and summed
against the plain totals."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from peekvit_tpu.ops.pallas import fused_attention_vjp as jvjp
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp


def _pallas_dqkv(qkv, dattn, heads):
    """dqkv of the Pallas saved-qkv backward in interpret mode, one image a
    grid step, fed Wo = I so that its dattn = g Wo^T is ``dattn`` itself
    (an exact product: one term per output)."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    dt = qkv.dtype
    full = lambda shape: pl.BlockSpec(  # noqa: E731
        shape, lambda i: tuple(0 for _ in shape), memory_space=pltpu.VMEM)
    io = pl.BlockSpec((1, n, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    io3 = pl.BlockSpec((1, n, 3 * d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    lnp = pl.BlockSpec((1, 8, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    x = jnp.ones((b, n, d), dt)
    out = pl.pallas_call(
        functools.partial(jvjp._attn_bwd_kernel_saved, num_heads=heads, eps=1e-5),
        out_shape=(jax.ShapeDtypeStruct((b, n, d), dt), jax.ShapeDtypeStruct((b, n, 3 * d), dt),
                   jax.ShapeDtypeStruct((b, n, d), dt),
                   jax.ShapeDtypeStruct((b, 8, d), jnp.float32),
                   jax.ShapeDtypeStruct((b, 8, d), jnp.float32)),
        grid=(b,),
        in_specs=[io, io, io3, full((1, d)), full((1, d)), full((d, 3 * d)), full((d, d))],
        out_specs=(io, io3, io, lnp, lnp),
        interpret=True,
    )(x, dattn, qkv, jnp.ones((1, d), dt), jnp.zeros((1, d), dt), jnp.zeros((d, 3 * d), dt),
      jnp.eye(d, dtype=dt))
    return out[1]


@pytest.mark.parametrize("n", [1, 16, 17, 65, 197, 257])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_attn_softmax_bwd_at_the_kernel_edges(n, dtype, tol):
    """``attn_softmax_bwd`` at the token counts where the CUDA kernel
    changes its padding, tiling or instance (16 / 17: one or two 16-row
    chunks; 65: a second 64-row tile; 197: ViT-B/16; 257: the kept kernel's
    first count past the wgmma kernel's 256), head dim 64 as the kernel's,
    against the Pallas saved-qkv backward's dqkv in interpret mode on the
    same qkv and dattn (fp32 2e-5, bf16 3e-2); on the CPU the wrapper is
    its plain version, bit for bit, and counts no launch."""
    rng = np.random.default_rng(n)
    d, heads = 128, 2
    qkv = rng.normal(size=(1, n, 3 * d)).astype(np.float32)
    dattn = rng.normal(size=(1, n, d)).astype(np.float32)
    want = _pallas_dqkv(jnp.asarray(qkv, getattr(jnp, dtype)),
                        jnp.asarray(dattn, getattr(jnp, dtype)), heads)
    tq, td = (torch.tensor(t).to(getattr(torch, dtype)) for t in (qkv, dattn))
    tfa.reset_launch_counts()
    got = tvjp.attn_softmax_bwd(tq, td, heads)
    assert tfa.LAUNCHES == {} and got.dtype == tq.dtype and got.shape == (1, n, 3 * d)
    assert torch.equal(got, tvjp.attn_softmax_bwd_ref(tq, td, heads))
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


RAGGED = [(1, 8), (127, 120), (129, 136), (257, 264)]


def _t(rng, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)


@pytest.mark.parametrize("m,n", RAGGED)
def test_masked_rowdot_partials_per_128_columns(m, n):
    """Epilogue 8's partials at ragged M and N: (M, ceil(N / 128)), partial
    p the row sums of g * (a w + b) over columns [128 p, 128 p + 128), and
    their sum the plain row total."""
    rng = np.random.default_rng(m + n)
    k = 32
    a, w, b, g = _t(rng, m, k), _t(rng, k, n, scale=0.2), _t(rng, n), _t(rng, m, n)
    mask = torch.tensor(rng.uniform(size=m), dtype=torch.float32)
    dproj, parts = tfa.gemm_masked_rowdot(a, w, b, g, mask)
    groups = -(-n // tfa.ROWDOT_TILE)
    assert parts.shape == (m, groups) and parts.dtype == torch.float32
    prod = g.double() * (a.double() @ w.double() + b.double())
    for p in range(groups):
        torch.testing.assert_close(parts[:, p].double(), prod[:, 128 * p:128 * (p + 1)].sum(-1),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(parts.sum(-1).double(), prod.sum(-1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dproj, g * mask[:, None])


@pytest.mark.parametrize("m,n", RAGGED)
def test_gelu_grad_partials_per_128_rows(m, n):
    """Epilogue 10's partials at ragged M and N: (ceil(M / 128), N),
    partial t the column sums of the fp32 dhpre over rows [128 t,
    128 t + 128), and their sum the plain column total (db1)."""
    rng = np.random.default_rng(m * n)
    k = 32
    a, w, hpre = _t(rng, m, k), _t(rng, n, k, scale=0.2), _t(rng, m, n)
    dhpre_b, parts = tfa.gemm_nt_gelu_grad(a, w, hpre)
    tiles = -(-m // tfa.GELU_GRAD_TILE)
    assert parts.shape == (tiles, n) and parts.dtype == torch.float32
    x = hpre.double().requires_grad_()
    dhpre, = torch.autograd.grad(F.gelu(x, approximate="tanh"), x,
                                 a.double() @ w.double().t())
    for t in range(tiles):
        torch.testing.assert_close(parts[t].double(), dhpre[128 * t:128 * (t + 1)].sum(0),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(parts.sum(0).double(), dhpre.sum(0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dhpre_b.double(), dhpre, rtol=1e-5, atol=1e-5)
