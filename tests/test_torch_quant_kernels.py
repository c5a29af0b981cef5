"""The port's int8 (w8a8) kernels (their plain versions on the CPU) against
the JAX package's: ``quantize_linear``, ``quant_rows`` against
``_quant_rows`` (after ``_ln_f32``), the plain s8 GEMM against an exact
integer product and ``_qmatmul``, and the four compositions
(``quant_layer_block``, ``quant_keymasked_layer_block``,
``quant_attention_block``, ``quant_mlp_block``) against the Pallas
functions in interpret mode.

Inputs come from numpy with a seed and go through both packages. The CUDA
kernels run only on the card (chip_smoke.py holds them against these
plain versions there).

Tolerances of the compositions: the port and JAX round at the same points
and agree bit for bit up to the attention, but the bf16 attention output
differs by one bf16 step (2^-8 relative) where the two packages' fp32
sums, in another order, straddle a rounding boundary; requantized, such a
flip moves a row's dynamic scale and with it every code of the row, and
the change runs on through the out-projection, LN2, fc1 and fc2. Fed
JAX's attention output, the compositions match the Pallas functions
within 5e-3 of max|out| (most cases to ~1e-6; one dynamic code flipped by
an ulp of the LN output moves the output by ~2e-3 of max). Free-running:
fp32 1e-2 of max|out| (measured up to 6.8e-3 with these inputs), bf16
3e-2 (tests/test_pallas.py:42)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.ops.pallas import quant_blocks as jq
from peekvit_tpu.ops.pallas.fused_attention import _attn_scores_pv
from peekvit_torch.ops.cuda import quant_blocks as tq
from peekvit_torch.ops.cuda.fused_attention import LAUNCHES, reset_launch_counts

B, N, D, H, M = 2, 17, 64, 4, 256
EPS = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 1e-2, "bf16": 3e-2}
PINNED_TOL = 5e-3
CAPS = ((2.5, 1.0), (2.5, 1.5))  # ((attn LN, attn out), (mlp LN, gelu h)): some values saturate


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    km = (rng.uniform(size=(B, 1, N)) < 0.5).astype(np.float32)
    km[:, :, 0] = 1.0
    a = {
        "x": normal(B, N, D, scale=1.5, shift=0.3), "km": km,
        "ln1s": normal(D, scale=0.2, shift=1.0), "ln1b": normal(D, scale=0.1),
        "ln2s": normal(D, scale=0.2, shift=1.0), "ln2b": normal(D, scale=0.1),
        "bqkv": normal(3 * D, scale=0.1), "bo": normal(D, scale=0.1),
        "b1": normal(M, scale=0.1), "b2": normal(D, scale=0.1),
    }
    for name, shape in (("wqkv", (D, 3 * D)), ("wo", (D, D)), ("w1", (D, M)), ("w2", (M, D))):
        wq, s = jq.quantize_linear(jnp.asarray(normal(*shape, scale=shape[0] ** -0.5)))
        a[name], a["s" + name[1:]] = np.asarray(wq), np.asarray(s)
    return a


LAYER = ("x", "ln1s", "ln1b", "wqkv", "sqkv", "bqkv", "wo", "so", "bo", "ln2s", "ln2b",
         "w1", "s1", "b1", "w2", "s2", "b2")
ATTN = ("x", "ln1s", "ln1b", "wqkv", "sqkv", "bqkv", "wo", "so", "bo")
MLP = ("x", "ln2s", "ln2b", "w1", "s1", "b1", "w2", "s2", "b2")
_SCALES = {"sqkv", "so", "s1", "s2"}


def _both(a, names, dtype):
    """JAX and torch arguments: int8 weights and fp32 scales as they are,
    the rest in the compute dtype."""
    jdt, tdt = DTYPES[dtype]

    def conv(k):
        v = a[k]
        if v.dtype == np.int8 or k in _SCALES:
            return jnp.asarray(v), torch.from_numpy(v)
        return jnp.asarray(v, jdt), torch.from_numpy(v).to(tdt)

    j, t = zip(*(conv(k) for k in names))
    return list(j), list(t)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_heads(qkv, num_heads, masked, kmask):
    """``_attn_scores_pv`` vmapped over images and heads of a packed qkv
    (B, N, 3D), -> (B, N, D) bf16."""
    b, n, three_d = qkv.shape
    d = three_d // 3
    hd = d // num_heads
    q, k, v = jnp.moveaxis(qkv.reshape(b, n, 3, num_heads, hd), 1, 3)[:, :3].transpose(
        1, 0, 2, 3, 4)

    def one(q, k, v, km):
        return _attn_scores_pv(q, k, v, 1.0 / hd ** 0.5,
                               kmask=km if masked else None).astype(jnp.bfloat16)

    out = jax.vmap(jax.vmap(one, (0, 0, 0, None)), (0, 0, 0, 0))(q, k, v, kmask)
    return jnp.moveaxis(out, 1, 2).reshape(b, n, d)


def _jax_attention(qkv, num_heads, phantom_idx=-1, phantom_mult=0.0, kmask=None):
    """The Pallas attention core (``_attn_scores_pv``) per image and head,
    as a torch function: pins the attention of a torch composition to
    JAX's bf16 values."""
    b, n, _ = qkv.shape
    km = jnp.ones((b, n)) if kmask is None else jnp.asarray(kmask.reshape(b, n).float().numpy())
    q = jnp.asarray(qkv.float().numpy()).astype(jnp.bfloat16)
    out = _jax_heads(q, num_heads, kmask is not None, km)
    return torch.from_numpy(np.asarray(out, np.float32)).to(torch.bfloat16)


_PINNED = (tq.quant_rows_ref, tq.gemm_s8_epilogue_ref, _jax_attention)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


# ------------------------------------------------------------ quantize_linear


def test_quantize_linear_bit_equal_with_ties():
    """Codes and scales bit-equal to JAX's, exact .5 ties included (column
    absmax 127 -> scale 1.0, so k + 0.5 rounds half to even)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    w[0, :] = 127.0
    w[1:9, :] = np.array([2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 126.5, -1.5], np.float32)[:, None]
    jw, js = jq.quantize_linear(jnp.asarray(w))
    tw, ts = tq.quantize_linear(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (1, 40)
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tw[1:9, 0].tolist() == [2, -2, 4, -4, 0, 0, 126, -2]
    lw = tq.kernel_layout(tw)
    assert torch.equal(lw, tw) and lw.t().is_contiguous()


# ----------------------------------------------------------------- quant_rows


def _jax_quant_rows(x, cap, ln):
    def fn(x):
        v = x if ln is None else jq._ln_f32(x, ln[0][None], ln[1][None], EPS)
        return jq._quant_rows(v, cap)

    return jax.jit(fn)(x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln", [False, True], ids=["rows", "ln"])
@pytest.mark.parametrize("cap", [None, 1.25], ids=["dynamic", "static"])
def test_quant_rows_matches_jax(arrays, dtype, ln, cap):
    """Codes equal to JAX's; the dynamic scales within one fp32 ulp of the
    absmax (XLA folds the division by 127 into a multiply by its
    reciprocal; the port divides), plus, after the LN, an ulp or two of
    the LN output itself (its sums in another order): 2^-21 relative. The
    static scale equal."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(64, D)) * 1.5 + 0.3).astype(np.float32)
    jln = tln = None
    if ln:
        jln = (jnp.asarray(arrays["ln1s"], jdt), jnp.asarray(arrays["ln1b"], jdt))
        tln = (torch.from_numpy(arrays["ln1s"]).to(tdt), torch.from_numpy(arrays["ln1b"]).to(tdt))
    jc, js = _jax_quant_rows(jnp.asarray(x, jdt), cap, jln)
    tx = torch.from_numpy(x).to(tdt)
    tc, ts = tq.quant_rows(tx, cap, *(tln or (None, None)), EPS)
    assert tc.dtype == torch.int8 and tc.shape == tx.shape
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    if cap is None:
        assert ts.dtype == torch.float32 and ts.shape == (64, 1)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -21, atol=0)
    else:
        assert ts == float(js) == tq.static_scale(cap)
        if not ln:
            assert (np.abs(tc.numpy()) == 127).any()  # some values beyond the cap saturate
    assert tq.quant_rows_ref(tx, cap, *(tln or (None, None)), EPS)[0].equal(tc)


def test_quant_rows_floor_and_saturation():
    """A zero row takes the 1e-12 floor and codes 0; beyond a static cap
    every value saturates at +-127."""
    x = torch.zeros(3, 16)
    x[1] = torch.linspace(-4.0, 4.0, 16)
    x[2] = 1e-30
    codes, s = tq.quant_rows(x)
    assert s[0, 0].item() == np.float32(1e-12) and codes[0].abs().sum() == 0
    assert codes[1].abs().max() == 127 and codes[2].abs().max() == 0
    jc, js = jq._quant_rows(jnp.asarray(x.numpy()))
    assert np.array_equal(codes.numpy(), np.asarray(jc))
    codes, s = tq.quant_rows(x, cap=1.0)
    assert codes[1, 0] == -127 and codes[1, -1] == 127 and (codes[1].abs() == 127).sum() == 12
    assert s == tq.static_scale(1.0) == np.float32(1.0) / np.float32(127.0)
    assert tq.static_scale(0.0) == np.float32(1e-12) / np.float32(127.0)


# ------------------------------------------------------------- gemm_s8_epilogue


def test_plain_s8_gemm_is_exact():
    """The plain GEMM's sums are exact at K = 3072 with every code at the
    int8 extreme (|acc| up to 127^2 * 3072 > 2^24, where an fp32 product
    of the codes is not exact): float(acc) equals the int64 product
    rounded once to fp32."""
    rng = np.random.default_rng(3)
    a = rng.choice(np.array([-127, 127, 126, -125], np.int8), size=(8, 3072))
    w = rng.choice(np.array([-127, 127, 125, -126], np.int8), size=(3072, 16))
    a[0] = 127
    w[:, 0] = 127
    exact = a.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() > 2 ** 24
    got = tq.gemm_s8_epilogue_ref(torch.from_numpy(a), 1.0, torch.from_numpy(w),
                                  torch.ones(1, 16), torch.zeros(16), "residual_f32",
                                  residual=torch.zeros(8, 16))
    assert np.array_equal(got.numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("epilogue", ["bias", "gelu_f32", "residual_f32", "residual"])
def test_gemm_s8_epilogue_matches_qmatmul(arrays, epilogue):
    """The dequant order of ``_qmatmul`` (float(acc) * s_row * s_col, then
    + bias, then the epilogue), fp32 inputs, dynamic row scales."""
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, size=(34, D)).astype(np.int8)
    sa = rng.uniform(0.001, 0.05, size=(34, 1)).astype(np.float32)
    res = rng.normal(size=(34, 3 * D)).astype(np.float32)
    wq, sw, b = arrays["wqkv"], arrays["sqkv"], arrays["bqkv"]
    v = jq._qmatmul(jnp.asarray(a), jnp.asarray(sa), jnp.asarray(wq), jnp.asarray(sw)) + b
    want = {"bias": v.astype(jnp.bfloat16), "gelu_f32": jax.nn.gelu(v),
            "residual_f32": v + res, "residual": v + res}[epilogue]
    got = tq.gemm_s8_epilogue(torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(wq),
                              torch.from_numpy(sw), torch.from_numpy(b), epilogue,
                              residual=torch.from_numpy(res) if "residual" in epilogue else None,
                              out_dtype=torch.float32)
    assert got.dtype == (torch.bfloat16 if epilogue == "bias" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- compositions


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS], ids=["dynamic", "static"])
def test_quant_layer_block(arrays, dtype, caps):
    j, t = _both(arrays, LAYER, dtype)
    want = jq.quant_layer_block(*j, H, EPS, True, 1, caps)
    got = tq.quant_layer_block(*t, H, EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(tq.quant_layer_block_ref(*t, H, EPS, caps=caps), got)
    if dtype == "fp32":
        pinned = tq._q_layer(_PINNED, t[0], None, *t[1:], H, EPS, caps)
        assert _rel_err(pinned, want) <= PINNED_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_keymasked_layer_block(arrays, dtype):
    """Against the Pallas mode ``keymasked``; the mask matters, and rows
    of excluded keys poisoned with NaN/Inf leave the valid rows as they
    were (tests/test_pallas.py:140's contract)."""
    jdt, tdt = DTYPES[dtype]
    j, t = _both(arrays, LAYER, dtype)
    jkm, tkm = jnp.asarray(arrays["km"], jdt), torch.from_numpy(arrays["km"]).to(tdt)
    want = jq.quant_keymasked_layer_block(j[0], jkm, *j[1:], H, EPS, True, 1, None)
    got = tq.quant_keymasked_layer_block(t[0], tkm, *t[1:], H, EPS)
    assert _rel_err(got, want) <= TOL[dtype]
    unmasked = tq.quant_layer_block(*t, H, EPS)
    assert (got - unmasked).abs().max() > 1e-2
    if dtype == "fp32":
        pinned = tq._q_layer(_PINNED, t[0], tkm, *t[1:], H, EPS, None)
        assert _rel_err(pinned, want) <= PINNED_TOL
    keep = torch.from_numpy(arrays["km"][:, 0] > 0)
    bad = t[0].clone()
    bad[~keep] = torch.where(torch.arange(int((~keep).sum()))[:, None] % 2 == 0,
                             float("nan"), float("inf")).to(tdt)
    poisoned = tq.quant_keymasked_layer_block(bad, tkm, *t[1:], H, EPS)
    assert torch.isfinite(poisoned[keep]).all()
    assert torch.equal(poisoned[keep], got[keep])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS[0]], ids=["dynamic", "static"])
def test_quant_attention_block(arrays, dtype, caps):
    j, t = _both(arrays, ATTN, dtype)
    want = jq.quant_attention_block(*j, H, EPS, True, 2, caps)
    got = tq.quant_attention_block(*t, H, EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(tq.quant_attention_block_ref(*t, H, EPS, caps=caps), got)
    if dtype == "fp32":
        pinned = tq._q_attention(_PINNED, *t, H, EPS, caps)
        assert _rel_err(pinned, want) <= PINNED_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS[1]], ids=["dynamic", "static"])
def test_quant_mlp_block(arrays, dtype, caps):
    """No attention in the MLP sublayer: fp32 within 1e-5 of max|out|."""
    j, t = _both(arrays, MLP, dtype)
    want = jq.quant_mlp_block(*j, EPS, True, 2, caps)
    got = tq.quant_mlp_block(*t, EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= (1e-5 if dtype == "fp32" else TOL[dtype])
    assert torch.equal(tq.quant_mlp_block_ref(*t, EPS, caps=caps), got)


def test_cpu_tensors_take_the_plain_versions(arrays):
    """On CPU tensors no kernel launches: the launch counts stay empty."""
    _, t = _both(arrays, LAYER, "bf16")
    reset_launch_counts()
    tq.quant_layer_block(*t, H, EPS)
    assert LAUNCHES == {}
    with pytest.raises(ValueError, match="needs residual"):
        tq.gemm_s8_epilogue(*(torch.zeros(2, 16, dtype=torch.int8), 1.0,
                              torch.zeros(16, 8, dtype=torch.int8), torch.ones(1, 8),
                              torch.zeros(8)), "residual")
