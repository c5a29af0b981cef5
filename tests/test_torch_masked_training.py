"""The port's masked trainable attention block against the JAX package's,
on the CPU.

``masked_attention_block_trainable`` (the ResidualViT attention sublayer
with the gate mask a differentiable operand) goes through both packages on
the same numpy inputs, its output and all eight gradients; the two new
kernel variants' plain versions are held against their direct formulas.
JAX runs as its own tests run it (``interpret=True``). On the CPU the
port's wrappers run their plain versions; chip_smoke.py holds the kernels
against them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.ops.pallas.fused_attention_vjp import (
    masked_attention_block_trainable as jax_masked_block,
)
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp

GRAD_NAMES = ["dx", "dmask", "dlns", "dlnb", "dwqkv", "dbqkv", "dwo", "dbo"]
HEADS = 4
EPS = 1e-6


def _inputs(seed=3, b=2, n=13, d=32, zero_rows=0):
    """tests/test_pallas_vjp.py:136-145 inputs (N = 13, mask uniform in
    [0, 1)); ``zero_rows`` sets that many mask rows of image 0 to exactly 0,
    as a relu gate does."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.5).astype(np.float32)

    x = f(b, n, d)
    m = rng.uniform(0.0, 1.0, size=(b, n, 1)).astype(np.float32)
    m[0, 1:1 + zero_rows] = 0.0
    args = (x, m, 1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, 3 * d), 0.05 * f(3 * d),
            0.2 * f(d, d), 0.05 * f(d))
    return args, f(b, n, d)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("save_qkv", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_block_matches_jax(save_qkv, dtype):
    """Forward and all eight gradients, dmask included, against the Pallas
    custom VJP. fp32: 2e-5 on the output and 5e-4 on the gradients, the
    JAX package's own pins (tests/test_pallas_vjp.py:158-171); bf16: 3e-2,
    the repo's bf16 kernel tolerance (tests/test_pallas.py:42)."""
    args, g = _inputs(zero_rows=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    want = jax_masked_block(*jargs, HEADS, EPS, True, save_qkv)
    want_grads = jax.grad(
        lambda *a: jnp.sum((jax_masked_block(*a, HEADS, EPS, True, save_qkv) * jg)
                           .astype(jnp.float32)),
        argnums=tuple(range(8)))(*jargs)

    targs = [torch.tensor(a).to(tdt).requires_grad_() for a in args]
    tfa.reset_launch_counts()
    got = tvjp.masked_attention_block_trainable(*targs, HEADS, EPS, save_qkv)
    (got.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    assert tfa.LAUNCHES == {}  # CPU tensors: plain versions, no launch
    assert got.dtype == tdt and got.shape == args[0].shape
    out_tol, grad_tol = (2e-5, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=out_tol, atol=out_tol)
    for name, t, w in zip(GRAD_NAMES, targs, want_grads):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape, name
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("save_qkv", [False, True])
def test_masked_block_ref_twin_equals_block_on_cpu(save_qkv):
    """masked_attention_block_trainable_ref (the card's reference) is, on
    the CPU, the block itself bit for bit; with the mask at 1 everywhere
    the output is the unmasked block's."""
    args, g = _inputs(seed=5)
    outs = []
    for fn in (tvjp.masked_attention_block_trainable, tvjp.masked_attention_block_trainable_ref):
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        out = fn(*targs, HEADS, EPS, save_qkv)
        (out * torch.tensor(g)).sum().backward()
        outs.append([out] + [t.grad for t in targs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    x, _, *params = (torch.tensor(a) for a in args)
    ones = torch.ones(x.shape[:2] + (1,))
    with torch.no_grad():
        masked = tvjp.masked_attention_block_trainable(x, ones, *params, HEADS, EPS, save_qkv)
        plain = tvjp.attention_block_trainable(x, *params, HEADS, EPS, save_qkv)
    torch.testing.assert_close(masked, plain)


def test_masked_kernel_plain_versions():
    """The two new variants' plain versions against direct formulas, and
    the wrappers on CPU tensors count no launch."""
    rng = np.random.default_rng(7)
    r, k, d = 9, 32, 16

    def t(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32)

    # gemm_masked_rowdot: bf16(g * mask) and the row sums of g * (a @ w + b)
    a, w, b, g = t(r, k), t(k, d), t(d), t(r, d)
    mask = torch.tensor(rng.uniform(size=r), dtype=torch.float32)
    mask[2] = 0.0
    tfa.reset_launch_counts()
    dproj, parts = tfa.gemm_masked_rowdot(a, w, b, g, mask)
    torch.testing.assert_close(dproj, g * mask[:, None])
    torch.testing.assert_close(parts.sum(-1), (g * (a @ w + b)).sum(-1))
    dproj16, _ = tfa.gemm_masked_rowdot(*(v.to(torch.bfloat16) for v in (a, w, b, g, mask)))
    assert dproj16.dtype == torch.bfloat16
    # ln_bwd_rows_masked: autograd of (LN(x) * gamma + beta) * mask, plus
    # the residual cotangent on dx and the rowdot on dmask
    x = t(r, d).requires_grad_()
    gamma = (1.0 + 0.1 * t(d)).requires_grad_()
    beta = (0.1 * t(d)).requires_grad_()
    m = mask.clone().requires_grad_()
    ds1, resid, rowdot = t(r, d), t(r, d), t(r, 3)
    s1 = torch.nn.functional.layer_norm(x, (d,), gamma, beta, EPS) * m[:, None]
    s1.backward(ds1)
    dx, dm, pw, pb = tvjp.ln_bwd_rows_masked(x.detach(), ds1, resid, gamma.detach(),
                                             beta.detach(), mask, rowdot, EPS)
    torch.testing.assert_close(dx, x.grad + resid)
    torch.testing.assert_close(dm, m.grad + rowdot.sum(-1))
    torch.testing.assert_close(pw.sum(0), gamma.grad)
    torch.testing.assert_close(pb.sum(0), beta.grad)
    assert dm.dtype == mask.dtype and dx[2].abs().max() > 0  # mask 0: dx is the residual
    torch.testing.assert_close(dx[2], resid[2])
    assert tfa.LAUNCHES == {}
    with pytest.raises(ValueError):
        tfa.gemm_masked_rowdot(a, w, b, g, mask.to("meta"))
