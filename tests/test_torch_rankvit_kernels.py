"""The port's RankViT kernels (their plain versions on the CPU) against the
JAX package's Pallas functions of the same name, in interpret mode:
``fused_mlp_block``, ``keymasked_attention_block``,
``keymasked_layer_block_folded`` and the attention core's key mask
against ``_attn_scores_pv(kmask=)``; and the port's mirror of
tests/test_pallas.py:140 (excluded rows holding NaN and Inf stay inert).

Inputs come from numpy with a seed and go through both packages. The
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there). Tolerances: fp32 at 2e-4 (sums in another
order); bf16 at 3e-2 (tests/test_pallas.py:42: the two sides round the
same values to bf16 after sums taken in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_torch.ops.cuda import fused_attention as tfa

B, N, D, H, M = 2, 19, 64, 4, 128  # N not a multiple of 8
EPS = 1e-5
TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    # a padded RankViT key mask: the class token attended, the image keys
    # of each image excluded at random (about half), a different set per image
    km = (rng.uniform(size=(B, 1, N)) < 0.5).astype(np.float32)
    km[:, :, 0] = 1.0
    assert not np.array_equal(km[0], km[1])
    return {
        "x": normal(B, N, D, scale=1.5, shift=0.3), "km": km,
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


MLP = ("x", "ln2s", "ln2b", "w1", "b1", "w2", "b2")
ATTN = ("x", "km", "ln1s", "ln1b", "wqkv", "bqkv", "wo", "bo")
LAYER = ("x", "km", "wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_mlp_block(arrays, dtype):
    j, t = _both(arrays, MLP, dtype)
    want = jfa.fused_mlp_block(*j, EPS, True, 1)
    got = tfa.fused_mlp_block(*t, EPS)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    _close(got, want, dtype)
    assert torch.equal(tfa.fused_mlp_block_ref(*t, EPS), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_keymasked_attention_block(arrays, dtype):
    """Against the Pallas block; the mask matters (the block without it
    differs), and the plain twin is the same composition."""
    j, t = _both(arrays, ATTN, dtype)
    want = jfa.keymasked_attention_block(*j, H, EPS, True, 1)
    got = tfa.keymasked_attention_block(*t, H, EPS)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    _close(got, want, dtype)
    assert torch.equal(tfa.keymasked_attention_block_ref(*t, H, EPS), got)
    unmasked = tfa.fused_attention_block(t[0], *t[2:], H, EPS)
    assert not torch.allclose(unmasked, got, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_keymasked_layer_block_folded(arrays, dtype):
    """The folded key-masked layer against the Pallas one, with the LN
    affines folded from the same weights on both sides; all-ones keys give
    the plain folded layer exactly."""
    jdt, tdt = DTYPES[dtype]
    a = dict(arrays)
    wqkv, bqkv = tfa.fold_ln_into_weights(*(torch.from_numpy(a[k]) for k in
                                            ("ln1s", "ln1b", "wqkv", "bqkv")))
    w1, b1 = tfa.fold_ln_into_weights(*(torch.from_numpy(a[k]) for k in
                                        ("ln2s", "ln2b", "w1", "b1")))
    a.update(wqkv=wqkv.numpy(), bqkv=bqkv.numpy().reshape(-1), w1=w1.numpy(),
             b1=b1.numpy().reshape(-1))
    j, t = _both(a, LAYER, dtype)
    want = jfa.keymasked_layer_block_folded(*j, H, EPS, True, 1)
    got = tfa.keymasked_layer_block_folded(*t, H, EPS)
    assert got.dtype == tdt and got.shape == (B, N, D)
    _close(got, want, dtype)
    assert torch.equal(tfa.keymasked_layer_block_folded_ref(*t, H, EPS), got)
    ones = torch.ones_like(t[1])
    assert torch.equal(tfa.keymasked_layer_block_folded(t[0], ones, *t[2:], H, EPS),
                       tfa.fused_layer_block_folded(t[0], *t[2:], H, EPS))


@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_scores_pv_key_mask(arrays, dtype):
    """The plain attention with the key mask against JAX's
    ``_attn_scores_pv(kmask=)`` per image and head."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(B, N, 3 * D)).astype(np.float32)
    km = arrays["km"]
    hd = D // H
    got = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H,
                             kmask=torch.from_numpy(km).to(tdt))
    q = jnp.asarray(qkv, jdt)
    for b in range(B):
        for h in range(H):
            cols = [slice(part * D + h * hd, part * D + (h + 1) * hd) for part in range(3)]
            want = jfa._attn_scores_pv(*(q[b][:, c] for c in cols), 1.0 / hd ** 0.5,
                                       kmask=jnp.asarray(km[b, 0], jdt)).astype(jdt)
            _close(got[b, :, h * hd:(h + 1) * hd], want, dtype)
    # (B, N) and (B, 1, N) masks are the same mask; all ones is no mask
    flat = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H,
                              kmask=torch.from_numpy(km[:, 0]).to(tdt))
    assert torch.equal(flat, got)
    ones = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H,
                              kmask=torch.ones(B, N, dtype=tdt))
    assert torch.equal(ones, tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H))


def test_keymasked_blocks_inert_to_garbage_in_excluded_rows():
    """tests/test_pallas.py:140 for the port: excluded key rows holding NaN
    and Inf change no valid row (fp32, 1e-6) and leave them finite, in the
    split attention block and in the folded layer; and the plain attention
    with NaN and Inf in excluded k and v rows (a selected 0, not 0 * NaN,
    and v scrubbed) gives the clean result on every query."""
    rng = np.random.default_rng(9)
    b, n, d, h, m = 2, 12, 32, 4, 64
    x = torch.from_numpy(rng.normal(size=(b, n, d)).astype(np.float32))
    km = torch.ones(b, 1, n)
    km[:, :, -4:] = 0.0
    bad = x.clone()
    bad[:, -4:-2] = float("nan")
    bad[:, -2:] = float("inf")
    args = (torch.ones(d), torch.zeros(d),
            torch.from_numpy((rng.normal(size=(d, 3 * d)) * 0.1).astype(np.float32)),
            torch.zeros(3 * d),
            torch.from_numpy((rng.normal(size=(d, d)) * 0.1).astype(np.float32)),
            torch.zeros(d))
    want = tfa.keymasked_attention_block(x, km, *args, h, 1e-5)
    got = tfa.keymasked_attention_block(bad, km, *args, h, 1e-5)
    np.testing.assert_allclose(got[:, :-4].numpy(), want[:, :-4].numpy(), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got[:, :-4]).all()

    wargs = (args[2], args[3], args[4], args[5],
             torch.from_numpy((rng.normal(size=(d, m)) * 0.1).astype(np.float32)),
             torch.zeros(m),
             torch.from_numpy((rng.normal(size=(m, d)) * 0.1).astype(np.float32)),
             torch.zeros(d))
    want2 = tfa.keymasked_layer_block_folded(x, km, *wargs, h, 1e-5)
    got2 = tfa.keymasked_layer_block_folded(bad, km, *wargs, h, 1e-5)
    np.testing.assert_allclose(got2[:, :-4].numpy(), want2[:, :-4].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got2[:, :-4]).all()

    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * d)).astype(np.float32))
    poisoned = qkv.clone()
    poisoned[:, -4:-2, d:] = float("nan")   # k and v of two excluded keys
    poisoned[:, -2:, d:] = float("-inf")
    clean = tfa.attn_scores_pv(qkv, h, kmask=km)
    dirty = tfa.attn_scores_pv(poisoned, h, kmask=km)
    assert torch.equal(clean, dirty)


def test_key_mask_refusals(arrays):
    qkv = torch.zeros(B, N, 3 * D)
    with pytest.raises(ValueError, match="exclusive"):
        tfa.attn_scores_pv(qkv, H, N - 1, 2.0, kmask=torch.ones(B, N))
    with pytest.raises(ValueError, match="kmask has"):
        tfa.attn_scores_pv(qkv, H, kmask=torch.ones(B, N - 1))
