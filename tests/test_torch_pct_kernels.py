"""The port's PCT kernels (their plain versions on the CPU) against the JAX
package's Pallas functions, in interpret mode: ``arpe_tokens`` against
``peekvit_tpu.ops.pallas.pct_embed.arpe_tokens`` (fed JAX's lane-padded
pack, the port the same pack unpadded), and the attention core and the
folded layer at head dim 32 (PCT's d = 128 over 4 heads) against
``_attn_scores_pv`` and ``fused_layer_block_folded``.

Inputs come from numpy with a seed and go through both packages. The
kernels themselves run only on the card (chip_smoke.py holds them against
these plain versions there). Tolerances: ARPE tokens in fp32 at 1e-5
(JAX takes its K = 3 and K = 6 sums as lane-padded dot products in
another order: ulps of c, g and the lin2 sum, and of the elus); the
attention and the layer at 2e-4 in fp32 and 3e-2 in bf16, as
tests/test_torch_kernels.py (tests/test_pallas.py:42).

The kNN set is a threshold on the fp32 distances. An ulp of d2 taken in
another order could flip a neighbour that sits exactly at the k-th
distance, so the random clouds are normal draws, where no two distances
of a row lie within an ulp; the cloud with duplicated points has exact
ties at the k-th distance (the same arithmetic on the same values on both
sides), and both include every tied point.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_tpu.ops.pallas.pct_embed import arpe_tokens as jax_arpe_tokens
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import pct_embed as tpe

B, N, D, H, M = 2, 64, 128, 4, 256  # the toy PCT: head dim 32
K = int(32 * N / 512)               # the ARPE k at 64 points: 4
EPS = 1e-5
TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, *shape, scale=1.0, shift=0.0):
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


def _pack(rng, d=D):
    """A BN-folded ARPE pack as the port takes it: wc, wb (3, 6), b1 (6,),
    w2 (6, d), b2 (d,)."""
    return (_normal(rng, 3, 6, scale=0.7), _normal(rng, 3, 6, scale=0.7),
            _normal(rng, 6, scale=0.3), _normal(rng, 6, d, scale=0.4), _normal(rng, d, scale=0.1))


def _jax_arpe(points, pack, k):
    """JAX's Pallas kernel on its lane-padded inputs (the layout of
    prepare_pct_engine_params: points (B, N, 8), channels padded to 128)."""
    wc, wb, b1, w2, b2 = pack
    d = w2.shape[-1]
    pts = np.zeros(points.shape[:2] + (8,), np.float32)
    pts[..., :3] = points
    wc_p = np.zeros((8, 128), np.float32)
    wc_p[:3, :6] = wc
    wb_p = np.zeros((8, 128), np.float32)
    wb_p[:3, :6] = wb
    b1_p = np.zeros((1, 128), np.float32)
    b1_p[0, :6] = b1
    w2_p = np.zeros((128, d), np.float32)
    w2_p[:6] = w2
    out = jax_arpe_tokens(jnp.asarray(pts), jnp.asarray(wc_p), jnp.asarray(wb_p),
                          jnp.asarray(b1_p), jnp.asarray(w2_p), jnp.asarray(b2.reshape(1, d)),
                          k, 6, True)
    return np.asarray(out, np.float32)


def _tied_cloud(rng):
    """21 points, each three times, and one more (N = 64): with k = 4 a
    point's three copies sit at distance 0 and the next copies all at one
    distance, so the k-th distance is tied three ways."""
    base = _normal(rng, 21, 3)
    cloud = np.concatenate([np.repeat(base, 3, axis=0), _normal(rng, 1, 3) + 5.0])
    return cloud[rng.permutation(N)]


@pytest.mark.parametrize("cloud", ["random", "ties"])
def test_arpe_tokens_ref_matches_pallas(cloud):
    rng = np.random.default_rng(0)
    if cloud == "random":
        points = _normal(rng, B, N, 3)
    else:
        points = np.stack([_tied_cloud(rng) for _ in range(B)])
    pack = _pack(rng)
    want = _jax_arpe(points, pack, K)
    got, thr, count = tpe.arpe_tokens(torch.from_numpy(points), *map(torch.from_numpy, pack), K,
                                      knn_stats=True)
    assert got.dtype == torch.float32 and got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # every row's set holds at least k points, and the distances at most
    # the threshold are exactly the set the counts report
    assert (count >= K).all()
    if cloud == "ties":
        assert (count > K).any()  # tied points past the k-th all included
        d2 = ((points[:, :, None] - points[:, None]) ** 2).sum(-1)
        kth = np.sort(d2, axis=-1)[..., K - 1]
        want_count = (d2 <= kth[..., None] + 1e-5).sum(-1)
        np.testing.assert_array_equal(count.numpy(), want_count)
    # bf16 output: the fp32 tokens rounded once (JAX's cast of the kernel output)
    got16 = tpe.arpe_tokens(torch.from_numpy(points), *map(torch.from_numpy, pack), K,
                            out_dtype=torch.bfloat16)
    assert torch.equal(got16, got.to(torch.bfloat16))


def test_arpe_tokens_contract():
    """The masked max over the kNN set equals the literal form on a
    tie-free cloud: top-k neighbours gathered, [x_i, x_i - x_j] through the
    folded lin1, elu, max, lin2, elu (the module's ARPE with both BNs
    folded), to fp32 rounding."""
    rng = np.random.default_rng(1)
    points = torch.from_numpy(_normal(rng, B, N, 3))
    wc, wb, b1, w2, b2 = map(torch.from_numpy, _pack(rng))
    wa = wc - wb
    idx = torch.topk(-torch.cdist(points, points), K, dim=-1).indices
    knn = points[torch.arange(B)[:, None, None], idx]
    centre = points[:, :, None, :].expand(-1, -1, K, -1)
    feats = torch.cat([centre, centre - knn], dim=-1)
    h = torch.nn.functional.elu(feats @ torch.cat([wa, wb]) + b1).amax(2)
    want = torch.nn.functional.elu(h @ w2 + b2)
    got = tpe.arpe_tokens(points, wc, wb, b1, w2, b2, K)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [64, 19])
def test_attn_scores_pv_hd32(dtype, n):
    """attn_scores_pv_ref at head dim 32 against JAX's _attn_scores_pv per
    image and head (scale 32^-0.5). In bf16 both sides round the fp32
    logits to bf16 before exp2, and the logits' sums run in another order:
    a logit on a rounding boundary can round either way, which moves its
    key's weight by one bf16 step of the logit (2^-3 in log2 units at
    |logit| >= 16). So the bf16 case takes q, k, v at unit scale, the
    scale the layer's LN -> qkv GEMM feeds the kernel (logits within about
    8, a step of at most 2^-5); fp32 takes them at scale 2."""
    rng = np.random.default_rng(3)
    qkv = _normal(rng, B, n, 3 * D, scale=2.0 if dtype == "fp32" else 1.0)
    jdt, tdt = DTYPES[dtype]
    hd = D // H
    q = jnp.asarray(qkv, jdt)
    want = np.zeros((B, n, D), np.float32)
    for b in range(B):
        for h in range(H):
            cols = slice(h * hd, (h + 1) * hd)
            out = jfa._attn_scores_pv(q[b, :, cols], q[b, :, D:][:, cols], q[b, :, 2 * D:][:, cols],
                                      1.0 / (hd ** 0.5))
            want[b, :, cols] = np.asarray(out.astype(jdt), np.float32)
    got = tfa.attn_scores_pv(torch.from_numpy(qkv).to(tdt), H)
    assert got.dtype == tdt and got.shape == (B, n, D)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_layer_block_folded_d128_h4(dtype):
    """The folded layer at PCT's widths against the Pallas layer kernel in
    interpret mode."""
    rng = np.random.default_rng(4)
    arrays = [_normal(rng, B, N, D, scale=1.5, shift=0.3),
              _normal(rng, D, 3 * D, scale=D ** -0.5), _normal(rng, 3 * D, scale=0.1),
              _normal(rng, D, D, scale=D ** -0.5), _normal(rng, D, scale=0.1),
              _normal(rng, D, M, scale=D ** -0.5), _normal(rng, M, scale=0.1),
              _normal(rng, M, D, scale=M ** -0.5), _normal(rng, D, scale=0.1)]
    jdt, tdt = DTYPES[dtype]
    want = jfa.fused_layer_block_folded(*[jnp.asarray(a, jdt) for a in arrays], H, EPS, True)
    got = tfa.fused_layer_block_folded(*[torch.from_numpy(a).to(tdt) for a in arrays], H, EPS)
    assert got.dtype == tdt and got.shape == (B, N, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_attn_scores_pv_head_dims():
    """The kernel is instantiated at head dims 64, 32 and 48: the wrapper
    says which it takes, and the plain version's query scale follows the
    head dim (32^-0.5 log2 e), as JAX's."""
    assert tfa.HEAD_DIMS == (64, 32, 48)
    assert tfa._qscale(64) == 0.125 * tfa.LOG2E
    assert tfa._qscale(32) == (1.0 / (32 ** 0.5)) * jfa.LOG2E
    assert tfa._qscale(48) == (1.0 / (48 ** 0.5)) * jfa.LOG2E
