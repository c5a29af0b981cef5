"""The port's int8 (w8a8) serving against the JAX package's, on the CPU:
``quantize_vit_params`` bit-equal, the prepared int8 tree, the
calibration (SmoothQuant vectors, the smoothed weights, the static caps)
and ``InferenceEngine(quantized=True, device="cpu")`` for the ViT
(dynamic, ``calib_images=``, ``calib_static_caps=True``) and the RankViT
(exact drop across the 128-token merged/split switch, padded drop)
against the JAX engine run as its own tests run it (``interpret=True``,
fp32); then one ViT-B-width check of the port alone on pretrained-like
outlier channels. Inputs come from numpy with a seed.

The two packages round at the same points, but the bf16 attention
output differs by one bf16 step where their fp32 sums, in another order,
straddle a rounding boundary; requantized, such a flip moves a row's
scale and runs on through the layers, and under a token drop it can swap
a near-tie at the keep boundary. So each engine is checked twice:

- pinned: the port's attention replaced by JAX's (``_attn_scores_pv``
  on the same bf16 qkv), logits within 5e-3 of max|logit| (measured
  2e-7 to 1.6e-3; one code flipped by an ulp of an LN output costs
  ~2e-3);
- free-running: within 5e-2 of max|logit| and top-1 equal on every
  decided image (top-2 margin above twice the largest difference);
  measured 1.6% (dynamic), 2.3% (calibrated), 3.1% (static caps), 2.5%
  (RankViT at budget 0.5). The padded drop at budget 0.25 (36 valid of
  144 tokens) is checked pinned only: free-running it measured 8.3%, the
  kept sets' near-ties."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu import inference as ji
from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch import inference as ti
from peekvit_torch.models.adapters import module_params, params_from_jax, params_to_jax
from peekvit_torch.ops.cuda import fused_attention as tfa
from tests.test_torch_quant_kernels import _jax_attention

VIT = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
           num_classes=7)
# 144 image tokens, ranked layers 1 and 2: budget 0.5 keeps 72 at layer 1,
# so one forward runs the merged layer (145 tokens) and the split
# sublayers (73 and 37 tokens)
RANK = dict(image_size=48, patch_size=4, num_layers=3, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=10, rankvit_layers=[1, 2])
GEOM = dict(patch_size=8, num_heads=4, num_class_tokens=1, num_registers=0, ln_eps=1e-5)
TOL = 5e-2


def _pair(family, args, seed):
    """A seeded JAX model with a random head and class token, and the
    port's model with its weights."""
    jm = jax_build_model(family, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return jm, params_from_jax(build_model(family, args, device="cpu"), tree)


def _images(seed, b, size):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def vit_pair():
    jm, tm = _pair("vit", VIT, 1)
    return jm, tm, _images(2, 3, 32)


@pytest.fixture(scope="module")
def rank_pair():
    jm, tm = _pair("rankvit", RANK, 3)
    return jm, tm, _images(5, 2, 48)


def _pinned(monkeypatch, forward):
    """``forward()`` with the port's attention replaced by JAX's."""
    monkeypatch.setattr(tfa, "attn_scores_pv_ref", _jax_attention)
    out = forward()
    monkeypatch.undo()
    return out


def _close_pinned(got, want):
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 5e-3 * np.abs(want).max()


def _agree(got, want):
    """Logits within TOL of max|logit|; top-1 equal on decided images."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    delta = np.abs(got - want).max()
    assert delta <= TOL * np.abs(want).max(), (delta, np.abs(want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * delta
    assert np.array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


# ------------------------------------------------------------ tree and calibration


def test_quantize_vit_params_bit_equal(vit_pair):
    jm, tm, _ = vit_pair
    want = ji.quantize_vit_params(jm.params)
    got = ti.quantize_vit_params(module_params(tm))
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(flat_g) == len(flat_w)
    for path, leaf in flat_g:
        w = np.asarray(flat_w[path])
        assert leaf.dtype == w.dtype and leaf.shape == w.shape, path
        assert np.array_equal(leaf, w), path


def test_prepared_int8_tree(vit_pair):
    """The dequant scales stay fp32 under a bf16 compute dtype; each int8
    kernel is the (in, out) view of an (out, in) copy; no LN fold, no
    stacked layers; the embed fold stays (JAX inference.py:160, :190)."""
    _, tm, _ = vit_pair
    q = ti.quantize_vit_params(module_params(tm))
    p = ti.prepare_engine_params(q, torch.bfloat16, fold_ln=True)
    lp = p["encoder"]["layers_0"]
    assert "_stacked_layers" not in p["encoder"] and "_folded_qkv" not in lp
    assert p["_embed_special"].dtype == torch.bfloat16 and "_embed_img_bias" in p
    for w, s in (("wqkv_q", "sqkv"), ("wo_q", "so"), ("w1_q", "s1"), ("w2_q", "s2")):
        assert lp[s].dtype == torch.float32 and torch.equal(lp[s], q["encoder"]["layers_0"][s])
        assert lp[w].dtype == torch.int8 and lp[w].t().is_contiguous()
        assert torch.equal(lp[w], q["encoder"]["layers_0"][w])
    assert lp["bqkv"].dtype == torch.bfloat16 and lp["ln_1"]["scale"].dtype == torch.bfloat16


def test_calibration_matches_jax(vit_pair):
    """Smoothing vectors, the smoothed weights and the static caps against
    JAX's at rtol 1e-4."""
    jm, tm, x = vit_pair
    calib = x[:2]
    js = ji.compute_smoothing_vectors(jm.params, jnp.asarray(calib), **GEOM)
    tp = module_params(tm)
    ts = ti.compute_smoothing_vectors(tp, torch.from_numpy(calib), **GEOM)
    assert len(ts) == len(js) == VIT["num_layers"]
    for (a, b), (c, d) in zip(js, ts):
        np.testing.assert_allclose(c.numpy(), a, rtol=1e-4)
        np.testing.assert_allclose(d.numpy(), b, rtol=1e-4)
    jsm = ji.smooth_vit_params(jm.params, js)
    tsm = ti.smooth_vit_params(tp, ts)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jsm):
        node = tsm
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf), rtol=1e-4, atol=1e-7)
    jc = ji.collect_activation_caps(jsm, jnp.asarray(calib), percentile=99.0, **GEOM)
    tc = ti.collect_activation_caps(tsm, torch.from_numpy(calib), percentile=99.0, **GEOM)
    np.testing.assert_allclose(np.array(tc), np.array(jc), rtol=1e-4)
    assert tp["encoder"]["layers_0"]["ln_1"]["scale"].equal(
        module_params(tm)["encoder"]["layers_0"]["ln_1"]["scale"])  # the source is not modified


# ------------------------------------------------------------------- engines


@pytest.mark.parametrize("mode", ["dynamic", "calibrated", "static"])
def test_vit_engine_matches_jax(vit_pair, mode):
    jm, tm, x = vit_pair
    kw = {"dynamic": {}, "calibrated": dict(calib_images=x[:2]),
          "static": dict(calib_images=x[:2], calib_static_caps=True)}[mode]
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, quantized=True, **kw)(
        jnp.asarray(x))
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True, **kw)
    got = engine(x)
    assert got.shape == (3, VIT["num_classes"]) and got.dtype == torch.float32
    assert (engine.caps is not None) == (mode == "static")
    _agree(got, want)


def test_vit_engine_with_jax_attention(vit_pair, monkeypatch):
    """With the attention pinned to JAX's bf16 values, the dynamic and the
    static-caps int8 engines match the JAX engine: every other step rounds
    where JAX rounds."""
    jm, tm, x = vit_pair
    for kw in ({}, dict(calib_images=x[:2], calib_static_caps=True)):
        want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, quantized=True, **kw)(
            jnp.asarray(x))
        engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True,
                                 **kw)
        _close_pinned(_pinned(monkeypatch, lambda: engine(x)), want)


def test_vit_engine_bf16_and_plain_twin(vit_pair):
    """bf16 against the JAX bf16 int8 engine (3e-2 of max, the bf16 kernel
    tolerance of tests/test_pallas.py:42 on top of the requantized
    flips); the engine on the CPU is its plain twin exactly."""
    jm, tm, x = vit_pair
    want = JaxEngine(jm, compute_dtype=jnp.bfloat16, interpret=True, quantized=True)(
        jnp.asarray(x))
    engine = InferenceEngine(tm, device="cpu", quantized=True)
    got = engine(x)
    _agree(got, want)
    plain = ti.vit_forward_quant_plain(engine.params, torch.from_numpy(x),
                                       compute_dtype=torch.bfloat16, **GEOM)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("budget", [0.5, 1.0])
def test_rankvit_exact_engine_matches_jax(rank_pair, budget, monkeypatch):
    jm, tm, x = rank_pair
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, quantized=True)(
        jnp.asarray(x), budget=budget)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True)
    kept = {}
    got = ti.rankvit_forward_quant(engine.params, torch.from_numpy(x), budget=budget,
                                   kept_out=kept, **engine._forward)
    assert torch.equal(engine(x, budget=budget), got)
    _agree(got, want)
    _close_pinned(_pinned(monkeypatch, lambda: engine(x, budget=budget)), want)
    if budget == 0.5:
        assert {i: tuple(v.shape) for i, v in kept.items()} == {1: (2, 72), 2: (2, 36)}
        fwd = dict(engine._forward, compute_dtype=torch.float32)
        plain = ti.rankvit_forward_quant_plain(engine.params, torch.from_numpy(x), budget=budget,
                                               kept_idx=kept, **fwd)
        assert torch.equal(plain, got)


@pytest.mark.parametrize("budget", [0.25, 0.5])
def test_rankvit_padded_engine_matches_jax(rank_pair, budget, monkeypatch):
    jm, tm, x = rank_pair
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, quantized=True,
                     max_budget=1.0)(jnp.asarray(x), budget=budget)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True,
                             max_budget=1.0)
    _close_pinned(_pinned(monkeypatch, lambda: engine(x, budget=budget)), want)
    if budget == 0.5:
        _agree(engine(x, budget=budget), want)
    with pytest.raises(ValueError, match="exceeds"):
        InferenceEngine(tm, device="cpu", quantized=True, max_budget=0.5)(x, budget=0.75)


def test_int8_engine_guards(rank_pair):
    """quantized=True on a ResidualViT is served, but not with compact=
    (JAX's bf16 single-program refusal); max_budget= with quantized=True
    takes a RankViT, as in JAX."""
    _, tm, _ = rank_pair
    small = dict(image_size=32, patch_size=8, num_layers=1, num_heads=2, hidden_dim=32,
                 mlp_dim=64, num_classes=5)
    residual = build_model("residualvit", dict(small, residual_layers=["attention+mlp"],
                                               gate_type="sigmoid", add_budget_token="learnable"),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="bf16 single-program"):
        InferenceEngine(residual, device="cpu", quantized=True, compact=0.5)
    assert InferenceEngine(residual, device="cpu", quantized=True)._quantized
    with pytest.raises(NotImplementedError, match="RankViT models only"):
        InferenceEngine(build_model("vit", small, device="cpu"), device="cpu", quantized=True,
                        max_budget=0.5)
    assert InferenceEngine(tm, device="cpu", quantized=True)._quantized


# ------------------------------------------------------------ ViT-B width, port alone


@pytest.fixture
def one_thread():
    """One intra-op thread: under the parallel test run, a ViT-B/16 forward
    on every core of every worker spends its time waiting for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_b16_calibrated_int8_rankvit_tracks_fp32_under_outliers(one_thread):
    """tests/test_full_scale.py:280-317's budget-1.0 contract on the port
    alone: ViT-B/16 weights with pretrained-like outlier channels
    (tests/realistic_weights.py), the calibrated int8 RankViT engine on the
    CPU against the port's fp32 module: max|delta| < 5% of the logit
    spread, top-1 equal."""
    from tests.realistic_weights import make_outlier_vit_params

    b16 = dict(image_size=224, patch_size=16, num_layers=12, num_heads=12, hidden_dim=768,
               mlp_dim=3072, num_classes=1000, rankvit_layers=[4, 8])
    model = build_model("rankvit", b16, seed=9, device="cpu")
    tree = make_outlier_vit_params(params_to_jax(model), seed=9)
    params_from_jax(model, jax.tree.map(np.asarray, tree))
    x = _images(42, 2, 224)
    with torch.no_grad():
        want, _ = model(torch.from_numpy(x), budget=1.0)
    engine = InferenceEngine(model, compute_dtype=torch.float32, device="cpu", quantized=True,
                             calib_images=x)
    got = engine(x, budget=1.0)
    spread = want.abs().max()
    assert (got - want).abs().max() < 0.05 * spread
    assert torch.equal(got.argmax(-1), want.argmax(-1))
