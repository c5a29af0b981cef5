"""The port's masked-layer kernels (their plain versions on the CPU)
against the JAX package's Pallas functions of the same name, in
interpret mode: ``masked_layer_block``, ``masked_attention_block``,
``masked_mlp_block`` with the phantom key weight off and on, and the
attention core's key weight against ``_attn_scores_pv(kweight=)``.

Inputs come from numpy with a seed and go through both packages. The
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there). Tolerances: fp32 at 2e-4 (sums in another
order); bf16 at 3e-2 (tests/test_pallas.py:42: the two sides round the
same values to bf16 after sums taken in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_torch.ops.cuda import fused_attention as tfa

B, N, D, H, M = 2, 19, 64, 4, 128  # N not a multiple of 8
EPS = 1e-6
TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (phantom_mult, phantom_idx): off, and a slot weighted by 5 dropped tokens
PHANTOMS = {"no_phantom": (0.0, -1), "phantom": (5.0, N - 2)}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    # a gate mask as the engine builds it: 1 on the class token and the
    # budget token (last), 0 on the phantom slot, gated image tokens in
    # [0, 1) with a third of them exactly 0
    gate = np.maximum(rng.uniform(-0.5, 1.0, size=(B, N, 1)), 0.0)
    gate[:, 0] = gate[:, -1] = 1.0
    gate[:, N - 2] = 0.0
    x = normal(B, N, D, scale=1.5, shift=0.3)
    x[:, N - 2] = 0.0
    return {
        "x": x, "mask": gate.astype(np.float32),
        "ln1s": normal(D, scale=0.2, shift=1.0), "ln1b": normal(D, scale=0.1),
        "ln2s": normal(D, scale=0.2, shift=1.0), "ln2b": normal(D, scale=0.1),
        "wqkv": normal(D, 3 * D, scale=D ** -0.5), "bqkv": normal(3 * D, scale=0.1),
        "wo": normal(D, D, scale=D ** -0.5), "bo": normal(D, scale=0.1),
        "w1": normal(D, M, scale=D ** -0.5), "b1": normal(M, scale=0.1),
        "w2": normal(M, D, scale=M ** -0.5), "b2": normal(D, scale=0.1),
    }


def _both(a, names, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a[k], jdt) for k in names],
            [torch.from_numpy(a[k]).to(tdt) for k in names])


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


LAYER = ("x", "mask", "ln1s", "ln1b", "wqkv", "bqkv", "wo", "bo", "ln2s", "ln2b",
         "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("phantom", PHANTOMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_layer_block(arrays, dtype, phantom):
    mult, idx = PHANTOMS[phantom]
    j, t = _both(arrays, LAYER, dtype)
    want = jfa.masked_layer_block(*j, H, EPS, True, 1, mult, idx)
    got = tfa.masked_layer_block(*t, H, EPS, mult, idx)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    _close(got, want, dtype)
    # the plain twin is the same composition over the same plain versions
    assert torch.equal(tfa.masked_layer_block_ref(*t, H, EPS, mult, idx), got)


@pytest.mark.parametrize("phantom", PHANTOMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_attention_block(arrays, dtype, phantom):
    mult, idx = PHANTOMS[phantom]
    j, t = _both(arrays, LAYER[:8], dtype)
    want = jfa.masked_attention_block(*j, H, EPS, True, 1, mult, idx)
    got = tfa.masked_attention_block(*t, H, EPS, mult, idx)
    assert got.dtype == t[0].dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_mlp_block(arrays, dtype):
    names = ("x", "mask", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
    j, t = _both(arrays, names, dtype)
    want = jfa.masked_mlp_block(*j, EPS, True, 1)
    got = tfa.masked_mlp_block(*t, EPS)
    assert got.dtype == t[0].dtype
    _close(got, want, dtype)


def test_masked_rows_stay_zero(arrays):
    """A row with mask 0 gives a zero normalized row and a zero attention
    output before the residual (the reference's gated-off token)."""
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x2, m = t["x"].reshape(B * N, D), t["mask"].reshape(B * N)
    off = m == 0
    assert off.any()
    ln = tfa.norm_rows(x2, EPS, torch.float32, t["ln1s"], t["ln1b"], m)
    assert torch.all(ln[off] == 0) and torch.all(ln[~off] != 0)
    ln2 = tfa.ln_rows(x2, t["ln1s"], t["ln1b"], EPS, m)
    assert torch.all(ln2[off] == 0)
    y = tfa.gemm_bias_epilogue(ln, t["wo"], t["bo"], "masked_residual_f32", residual=x2, mask=m)
    assert torch.equal(y[off], x2[off])


@pytest.mark.parametrize("mult", [0.0, 1.0, 7.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_scores_pv_phantom_weight(arrays, dtype, mult):
    """The plain attention with key ``idx`` weighted by ``mult`` against
    JAX's ``_attn_scores_pv(kweight=)`` per image and head. mult 0 (a
    phantom standing for no dropped token) removes the key: the port gates
    the weight on phantom_idx >= 0, not on mult > 0."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(B, N, 3 * D)).astype(np.float32)
    idx, hd = N - 2, D // H
    got = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H, idx, mult)
    kweight = jnp.ones((1, N), jnp.float32).at[0, idx].set(mult)
    q = jnp.asarray(qkv, jdt)
    for b in range(B):
        for h in range(H):
            cols = [slice(part * D + h * hd, part * D + (h + 1) * hd) for part in range(3)]
            want = jfa._attn_scores_pv(*(q[b][:, c] for c in cols), 1.0 / hd ** 0.5,
                                       kweight=kweight).astype(jdt)
            _close(got[b, :, h * hd:(h + 1) * hd], want, dtype)
    no_phantom = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H)
    if mult == 1.0:
        assert torch.equal(got, no_phantom)
    else:
        assert not torch.allclose(got, no_phantom)


def test_wrappers_refuse_bad_arguments(arrays):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x2, m = t["x"].reshape(B * N, D), t["mask"].reshape(B * N)
    with pytest.raises(ValueError, match="affine"):
        tfa.norm_rows(x2, EPS, torch.float32, mask=m)  # a mask needs the affine
    with pytest.raises(ValueError, match="affine"):
        tfa.norm_rows(x2, EPS, torch.float32, t["ln1s"], t["ln1b"])  # unmasked: folded
    with pytest.raises(ValueError, match="needs mask"):
        tfa.gemm_bias_epilogue(x2, t["wo"], t["bo"], "masked_residual", residual=x2)
    with pytest.raises(ValueError, match="takes no mask"):
        tfa.gemm_bias_epilogue(x2, t["wo"], t["bo"], "residual", residual=x2, mask=m)
    with pytest.raises(ValueError, match="phantom_idx"):
        tfa.attn_scores_pv(torch.zeros(B, N, 3 * D), H, N, 2.0)
