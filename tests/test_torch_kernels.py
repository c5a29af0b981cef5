"""The port's kernel plain versions and layer compositions against the JAX
package's Pallas functions (interpret mode, fp32) on the CPU.

Inputs come from numpy with a seed and go through both packages. On the
CPU the port's wrappers run their plain versions (the kernels run only on
the card: chip_smoke.py holds them against these plain versions there).
Tolerance: fp32 at rtol = atol = 1e-5 (sums in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import _layer_norm as jax_layer_norm
from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_torch.ops.cuda import fused_attention as tfa

B, N, D, H, M = 2, 17, 64, 4, 128  # N deliberately not a multiple of 8
EPS = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    return {
        "x": normal(B, N, D, scale=1.5, shift=0.3),
        "ln1s": normal(D, scale=0.2, shift=1.0), "ln1b": normal(D, scale=0.1),
        "ln2s": normal(D, scale=0.2, shift=1.0), "ln2b": normal(D, scale=0.1),
        "wqkv": normal(D, 3 * D, scale=D ** -0.5), "bqkv": normal(3 * D, scale=0.1),
        "wo": normal(D, D, scale=D ** -0.5), "bo": normal(D, scale=0.1),
        "w1": normal(D, M, scale=D ** -0.5), "b1": normal(M, scale=0.1),
        "w2": normal(M, D, scale=M ** -0.5), "b2": normal(D, scale=0.1),
    }


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _folded(a):
    """Folded weights (JAX fold_ln_into_weights) as numpy, shared by both."""
    wq, bq = jfa.fold_ln_into_weights(a["ln1s"], a["ln1b"], a["wqkv"], a["bqkv"])
    w1, b1 = jfa.fold_ln_into_weights(a["ln2s"], a["ln2b"], a["w1"], a["b1"])
    return [np.asarray(v) for v in (wq, bq, a["wo"], a["bo"], w1, b1, a["w2"], a["b2"])]


def test_fold_ln_into_weights(arrays):
    a = arrays
    want = jfa.fold_ln_into_weights(a["ln1s"], a["ln1b"], a["wqkv"], a["bqkv"])
    got = tfa.fold_ln_into_weights(_t(a["ln1s"]), _t(a["ln1b"]), _t(a["wqkv"]), _t(a["bqkv"]))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w)


@pytest.mark.parametrize("source", ["x", "y"])
def test_norm_rows_ref(arrays, source):
    x = arrays["x"].reshape(B * N, D)
    if source == "y":  # the fp32 mid-layer residual: larger offset and spread
        x = 3.0 * x + 2.0
    want = jfa._norm_rows(jnp.asarray(x), EPS)
    _close(tfa.norm_rows_ref(_t(x), EPS, torch.float32), want)
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    tfa.reset_launch_counts()
    _close(tfa.norm_rows(_t(x), EPS, torch.float32), want)
    assert tfa.LAUNCHES == {}


def test_ln_rows_ref(arrays):
    a = arrays
    x = a["x"].reshape(B * N, D)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(a["ln1s"]), jnp.asarray(a["ln1b"]), EPS)
    _close(tfa.ln_rows(_t(x), _t(a["ln1s"]), _t(a["ln1b"]), EPS), want)


@pytest.mark.parametrize("epilogue", ["bias", "gelu", "residual_f32", "residual"])
def test_gemm_bias_epilogue_ref(arrays, epilogue):
    """The four products of _layer_kernel (:680, :711-713, :698-702, :714-716)."""
    a = arrays
    x = a["x"].reshape(B * N, D)
    w, b = (a["w1"], a["b1"]) if epilogue == "gelu" else (a["wo"], a["bo"])
    res = 0.5 * x + 1.0
    acc = jnp.dot(jnp.asarray(x), jnp.asarray(w), preferred_element_type=jnp.float32)
    acc = acc + jnp.asarray(b)
    if epilogue == "gelu":
        acc = jax.nn.gelu(acc)
    elif epilogue != "bias":
        acc = acc + jnp.asarray(res)
    got = tfa.gemm_bias_epilogue(_t(x), _t(w), _t(b), epilogue,
                                 residual=_t(res) if epilogue.startswith("residual") else None)
    assert got.dtype == torch.float32
    _close(got, acc)


def test_gemm_bias_epilogue_rejects_bad_residual(arrays):
    x = _t(arrays["x"].reshape(B * N, D))
    with pytest.raises(ValueError):
        tfa.gemm_bias_epilogue(x, _t(arrays["wo"]), _t(arrays["bo"]), "residual")
    with pytest.raises(ValueError):
        tfa.gemm_bias_epilogue(x, _t(arrays["wo"]), _t(arrays["bo"]), "swish")


def test_attn_scores_pv_ref(arrays):
    """Against the Pallas packed-qkv kernel built on _attn_scores_pv."""
    rng = np.random.default_rng(1)
    qkv = rng.normal(size=(B, N, 3 * D)).astype(np.float32) * 2.0
    want = jfa.fused_mhsa(jnp.asarray(qkv), H, True)
    _close(tfa.attn_scores_pv(_t(qkv), H), want)


def test_fused_layer_block_folded(arrays):
    a = arrays
    w = _folded(a)
    want = jfa.fused_layer_block_folded(jnp.asarray(a["x"]), *map(jnp.asarray, w), H, EPS, True)
    got = tfa.fused_layer_block_folded(_t(a["x"]), *map(_t, w), H, EPS)
    _close(got, want)


def test_encoder_layers_one_call(arrays):
    """Held against JAX's per-layer fused_layer_block_folded chain: JAX's
    one-call stack is exact only compiled (inference.py:361-375)."""
    a = arrays
    layers = [_folded(a), [v * 0.9 for v in _folded(a)]]
    want = jnp.asarray(a["x"])
    for w in layers:
        want = jfa.fused_layer_block_folded(want, *map(jnp.asarray, w), H, EPS, True)
    names = ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2")
    stacked = {k: torch.stack([_t(w[i]) for w in layers]) for i, k in enumerate(names)}
    got = tfa.encoder_layers_one_call(_t(a["x"]), stacked, H, EPS)
    _close(got, want)


def test_fused_attention_block(arrays):
    a = arrays
    args = [a[k] for k in ("x", "ln1s", "ln1b", "wqkv", "bqkv", "wo", "bo")]
    want = jfa.fused_attention_block(*map(jnp.asarray, args), H, EPS, True)
    _close(tfa.fused_attention_block(*map(_t, args), H, EPS), want)


def test_wrappers_refuse_other_devices(arrays):
    """Only CPU tensors reach a plain version; any other device launches
    the kernel or raises."""
    x = torch.empty(B * N, D, device="meta")
    with pytest.raises(ValueError):
        tfa.norm_rows(x, EPS, torch.bfloat16)
