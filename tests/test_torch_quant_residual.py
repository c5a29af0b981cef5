"""The port's ResidualViT int8 (w8a8) serving against the JAX package's, on
the CPU: ``quant_rows`` with the row mask against ``_quant_rows(_ln_f32(x)
* mask)``, the two masked-residual s8 epilogues against ``_qmatmul``, the
three masked compositions (``quant_masked_layer_block``,
``quant_masked_attention_block``, ``quant_masked_mlp_block``) against the
Pallas functions in interpret mode, ``quantize_residualvit_params``,
``collect_residualvit_activation_stats`` and
``InferenceEngine(residualvit, quantized=True, device="cpu")`` against the
JAX engine (``quantized=True, compute_dtype=float32, interpret=True``).

Inputs come from numpy with a seed. The masks are continuous, as the
gate's relu(sig - thr): zeros and fractions. The tolerances are
``tests/test_torch_quant_kernels.py``'s (and its reasons): the bf16
attention output differs by one bf16 step where the two packages' fp32
sums straddle a rounding boundary, and requantized such a flip moves a
row's scale; so the compositions hold fp32 1e-2 and bf16 3e-2 of max|out|
free-running and 5e-3 with the attention pinned to JAX's
``_attn_scores_pv``, and the engines 5e-2 of max|logit| with top-1 equal
on every decided image (``tests/test_torch_quant_engine.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu import inference as ji
from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.ops.pallas import quant_blocks as jq
from peekvit_torch import InferenceEngine
from peekvit_torch import inference as ti
from peekvit_torch.models.adapters import module_params
from peekvit_torch.ops.cuda import quant_blocks as tq
from peekvit_torch.ops.cuda.fused_attention import LAUNCHES, reset_launch_counts
from tests.test_torch_quant_engine import _agree
from tests.test_torch_quant_kernels import (
    ATTN, B, CAPS, D, DTYPES, H, LAYER, M, MLP, N, PINNED_TOL, TOL, _PINNED, _both, _rel_err,
)
from tests.test_torch_residualvit import SMALL, _images, _pair

EPS = 1e-6  # the ResidualViT block LN


@pytest.fixture(scope="module")
def arrays():
    """quant_kernels' layer arrays plus a gate-like row mask (B, N, 1):
    about a third exactly 0, the rest fractions in (0, 0.8)."""
    rng = np.random.default_rng(10)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    a = {"x": normal(B, N, D, scale=1.5, shift=0.3),
         "mask": np.maximum(rng.uniform(-0.4, 0.8, size=(B, N, 1)), 0.0).astype(np.float32),
         "ln1s": normal(D, scale=0.2, shift=1.0), "ln1b": normal(D, scale=0.1),
         "ln2s": normal(D, scale=0.2, shift=1.0), "ln2b": normal(D, scale=0.1),
         "bqkv": normal(3 * D, scale=0.1), "bo": normal(D, scale=0.1),
         "b1": normal(M, scale=0.1), "b2": normal(D, scale=0.1)}
    a["mask"][:, 0] = 1.0  # the class token's row
    for name, shape in (("wqkv", (D, 3 * D)), ("wo", (D, D)), ("w1", (D, M)), ("w2", (M, D))):
        wq, s = jq.quantize_linear(jnp.asarray(normal(*shape, scale=shape[0] ** -0.5)))
        a[name], a["s" + name[1:]] = np.asarray(wq), np.asarray(s)
    assert (a["mask"] == 0).any() and ((a["mask"] > 0) & (a["mask"] < 1)).any()
    return a


def _mask(a, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a["mask"], jdt), torch.from_numpy(a["mask"]).to(tdt)


# ----------------------------------------------------------------- quant_rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [None, 1.25], ids=["dynamic", "static"])
def test_quant_rows_masked_matches_jax(arrays, dtype, cap):
    """Codes equal to ``_quant_rows(_ln_f32(x) * mask)``'s, the mask taken
    before the rounding (static caps included); the dynamic scales within
    2^-21 of JAX's (its division by 127 folded into a multiply); a row of
    mask 0 takes the 1e-12 floor and zero codes."""
    jdt, tdt = DTYPES[dtype]
    x = arrays["x"].reshape(B * N, D)
    jm, tm = _mask(arrays, dtype)
    jln = (jnp.asarray(arrays["ln1s"], jdt), jnp.asarray(arrays["ln1b"], jdt))
    tln = (torch.from_numpy(arrays["ln1s"]).to(tdt), torch.from_numpy(arrays["ln1b"]).to(tdt))
    jc, js = jax.jit(lambda x, m: jq._quant_rows(
        jq._ln_f32(x, jln[0][None], jln[1][None], EPS) * m.astype(jnp.float32), cap))(
        jnp.asarray(x, jdt), jm.reshape(-1, 1))
    tc, ts = tq.quant_rows(torch.from_numpy(x).to(tdt), cap, *tln, EPS, mask=tm)
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    zero = arrays["mask"].reshape(-1) == 0
    assert (tc[torch.from_numpy(zero)] == 0).all()
    if cap is None:
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -21, atol=0)
        assert (ts[torch.from_numpy(zero)] == np.float32(1e-12)).all()
    else:
        assert ts == float(js)
    unmasked, _ = tq.quant_rows(torch.from_numpy(x).to(tdt), cap, *tln, EPS)
    assert not torch.equal(unmasked, tc)


# ---------------------------------------------------------- gemm_s8_epilogue


@pytest.mark.parametrize("epilogue", ["masked_residual_f32", "masked_residual"])
def test_gemm_s8_masked_epilogues_match_qmatmul(arrays, epilogue):
    """((_qmatmul + bias) * mask) + x in the Pallas order, fp32 inputs:
    within 1e-6; the f32 epilogue is fp32 whatever ``out_dtype``."""
    rng = np.random.default_rng(11)
    a = rng.integers(-127, 128, size=(B * N, D)).astype(np.int8)
    sa = rng.uniform(0.001, 0.05, size=(B * N, 1)).astype(np.float32)
    res = rng.normal(size=(B * N, D)).astype(np.float32)
    mask = arrays["mask"].reshape(-1, 1)
    wq, sw, b = arrays["wo"], arrays["so"], arrays["bo"]
    want = (jq._qmatmul(jnp.asarray(a), jnp.asarray(sa), jnp.asarray(wq), jnp.asarray(sw))
            + b) * mask + res
    got = tq.gemm_s8_epilogue(torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(wq),
                              torch.from_numpy(sw), torch.from_numpy(b), epilogue,
                              residual=torch.from_numpy(res), out_dtype=torch.float32,
                              mask=torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="needs mask"):
        tq.gemm_s8_epilogue(torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(wq),
                            torch.from_numpy(sw), torch.from_numpy(b), epilogue,
                            residual=torch.from_numpy(res))


# --------------------------------------------------------------- compositions


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS], ids=["dynamic", "static"])
def test_quant_masked_layer_block(arrays, dtype, caps):
    j, t = _both(arrays, LAYER, dtype)
    jm, tm = _mask(arrays, dtype)
    want = jq.quant_masked_layer_block(j[0], jm, *j[1:], H, EPS, True, 1, caps)
    got = tq.quant_masked_layer_block(t[0], tm, *t[1:], H, EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(tq.quant_masked_layer_block_ref(t[0], tm, *t[1:], H, EPS, caps=caps),
                       got)
    assert (got - tq.quant_layer_block(*t, H, EPS, caps=caps)).abs().max() > 1e-2
    if dtype == "fp32":
        assert _rel_err(tq._q_layer(_PINNED, t[0], None, *t[1:], H, EPS, caps, tm),
                        want) <= PINNED_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS[0]], ids=["dynamic", "static"])
def test_quant_masked_attention_block(arrays, dtype, caps):
    """Site 15: x + mask * OutProj(MHSA(q8(mask * LN(x)))), in x's dtype."""
    j, t = _both(arrays, ATTN, dtype)
    jm, tm = _mask(arrays, dtype)
    want = jq.quant_masked_attention_block(j[0], jm, *j[1:], H, EPS, True, 2, caps)
    got = tq.quant_masked_attention_block(t[0], tm, *t[1:], H, EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(tq.quant_masked_attention_block_ref(t[0], tm, *t[1:], H, EPS, caps=caps),
                       got)
    zero = torch.from_numpy(arrays["mask"][..., 0] == 0)
    assert torch.equal(got[zero], t[0][zero])  # a gated-off row passes through
    if dtype == "fp32":
        assert _rel_err(tq._q_attention(_PINNED, *t, H, EPS, caps, tm), want) <= PINNED_TOL


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("caps", [None, CAPS[1]], ids=["dynamic", "static"])
def test_quant_masked_mlp_block(arrays, dtype, caps):
    """Site 16: the residual unmasked; no attention, so fp32 within 1e-5."""
    j, t = _both(arrays, MLP, dtype)
    jm, tm = _mask(arrays, dtype)
    want = jq.quant_masked_mlp_block(j[0], jm, *j[1:], EPS, True, 2, caps)
    got = tq.quant_masked_mlp_block(t[0], tm, *t[1:], EPS, caps=caps)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= (1e-5 if dtype == "fp32" else TOL[dtype])
    assert torch.equal(tq.quant_masked_mlp_block_ref(t[0], tm, *t[1:], EPS, caps=caps), got)


def test_cpu_tensors_take_the_plain_versions(arrays):
    _, t = _both(arrays, LAYER, "bf16")
    _, tm = _mask(arrays, "bf16")
    reset_launch_counts()
    tq.quant_masked_layer_block(t[0], tm, *t[1:], H, EPS)
    assert LAUNCHES == {}
    with pytest.raises(ValueError, match="needs the LN"):
        tq.quant_rows(t[0].reshape(B * N, D), mask=tm)


# ---------------------------------------------------------- tree, calibration

CASES = {"learnable": ("residualvit", "learnable"), "constant": ("residualvit", 0.5),
         "ee_learnable": ("eeresidualvit", "learnable")}


@pytest.fixture(scope="module")
def pairs():
    """One seeded JAX/port model pair per budget-token mode (random head,
    class token and gates), made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            name, bt = CASES[case]
            jm, tm, _ = _pair(name, dict(SMALL, add_budget_token=bt), 3)
            rng = np.random.default_rng(103)
            tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
            tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
            jm.params = jax.tree.map(jnp.asarray, tree)
            with torch.no_grad():
                tm.class_tokens.copy_(torch.from_numpy(tree["class_tokens"]))
            cache[case] = (jm, tm)
        return cache[case]

    return get


def _flat(tree):
    return dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree,
        is_leaf=lambda t: isinstance(t, torch.Tensor))))


def test_quantize_residualvit_params_bit_equal(pairs):
    """The int8 tree equals JAX's leaf for leaf (gates, budget-token gates,
    budget tokens and exit heads kept as they are); prepared, the gates and
    scales stay fp32 and each int8 weight is in the kernel layout."""
    jm, tm = pairs("ee_learnable")
    want = _flat(ji.quantize_residualvit_params(jm.params))
    q = ti.quantize_residualvit_params(module_params(tm))
    got = _flat(q)
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.dtype == want[path].dtype and np.array_equal(leaf, want[path]), path
    assert "residual_gate" in q["encoder"]["layers_0"] and "learnable_budget_token_2" in q
    p = ti.prepare_engine_params(q, torch.bfloat16)
    lp = p["encoder"]["layers_1"]
    assert lp["residual_gate"]["projection"]["kernel"].dtype == torch.float32
    assert lp["budget_token_gate"]["kernel"].dtype == torch.float32
    assert lp["so"].dtype == torch.float32 and lp["w1_q"].t().is_contiguous()
    assert p["encoder"]["early_exit_heads_0_head"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("case", ["learnable", "constant"])
def test_calibration_matches_jax(pairs, case):
    """Caps and smoothing vectors of the gated, masked fp32 forward against
    JAX's at rtol 1e-4, on the raw and on the smoothed weights."""
    jm, tm = pairs(case)
    x = _images(5, 3, 32)
    kw = dict(patch_size=8, num_heads=4, num_class_tokens=1, num_registers=0, gate_temp=1.0,
              gate_bias=0.0, budget_token=CASES[case][1], percentile=99.0)
    jc, js = ji.collect_residualvit_activation_stats(jm.params, jnp.asarray(x), **kw)
    tp = module_params(tm)
    tc, ts = ti.collect_residualvit_activation_stats(tp, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(np.array(tc), np.array(jc), rtol=1e-4)
    for (a, b), (c, d) in zip(js, ts):
        np.testing.assert_allclose(c.numpy(), a, rtol=1e-4)
        np.testing.assert_allclose(d.numpy(), b, rtol=1e-4)
    jc2, _ = ji.collect_residualvit_activation_stats(ji.smooth_vit_params(jm.params, js),
                                                     jnp.asarray(x), **kw)
    tc2, _ = ti.collect_residualvit_activation_stats(ti.smooth_vit_params(tp, ts),
                                                     torch.from_numpy(x), **kw)
    np.testing.assert_allclose(np.array(tc2), np.array(jc2), rtol=1e-4)


# -------------------------------------------------------------------- engine

ENGINE_CASES = {
    "learnable-dynamic": ("learnable", {}),
    "learnable-calibrated": ("learnable", {"calib": True}),
    "constant-static": ("constant", {"calib": True, "calib_static_caps": True}),
    "ee-static": ("ee_learnable", {"calib": True, "calib_static_caps": True}),
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_matches_jax_engine(pairs, case):
    """Free-running, at two budgets (the EE model: every one of its
    outputs): 5e-2 of max|logit| and top-1 on decided images."""
    model_case, kw = ENGINE_CASES[case]
    jm, tm = pairs(model_case)
    x = _images(5, 3, 32)
    kw = dict(kw)
    if kw.pop("calib", False):
        kw["calib_images"] = x[:2]
    ee = model_case.startswith("ee")
    je = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, quantized=True,
                   ee_outputs=ee, **kw)
    te = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True,
                         ee_outputs=ee, **kw)
    assert (te.caps is None) == ("calib_static_caps" not in kw)
    for budget in ((0.5,) if ee else (0.25, 0.75)):
        want, got = je(jnp.asarray(x), budget=budget), te(x, budget=budget)
        if ee:
            assert len(got) == len(want) == SMALL["num_layers"] + 1
        else:
            want, got = (want,), (got,)
        for g, w in zip(got, want):
            _agree(g, w)
