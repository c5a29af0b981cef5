"""The port's reconstruction families against the JAX package's, on the CPU:
the EncDec ResidualViT (``encdecresidualvit``) and the MAE ViT
(``maevit``) with their decoders, and the attention core at head dim 48,
which the EncDec decoder runs at its shipped width (d 192 over 4 heads).

Weights: a seeded JAX tree loads strictly and comes back exactly. Modules:
the port's forward against linen in eval at 2e-4 (both sides erf-gelu and
the max-subtracted softmax), and MAE's train forward with JAX's shuffle
permutation fed through the port's one helper. Engines: ``InferenceEngine``
against the JAX engine run as its own tests run it (``interpret=True``,
fp32), logits-only and ``recon_outputs=True`` at JAX's own tolerances
(tests/test_inference.py:461-541: logits 2e-4 / 1e-3, reconstruction
1e-3, mask image 1e-5), and one bf16 case at 3e-2. Then the guards, and
``attn_scores_pv_ref`` at head dim 48 against the Pallas
``_attn_scores_pv`` at the kernel's edge token counts (fp32 2e-5, bf16
3e-2), one jitted JAX reference per shape.

Toy widths keep head dim 48 in the EncDec decoder: image 32, patch 8,
decoder 96 over 2 heads (the JAX decoder needs the encoder's width, so the
encoder is 96 wide too, over 3 heads). Inputs come from numpy with a seed.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.models.registry import init_rngs, resolve_model_class
from peekvit_tpu.ops.pallas.fused_attention import _attn_scores_pv
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.inference import (maevit_forward_fused, maevit_forward_plain,
                                     residualvit_forward_plain)
from peekvit_torch.models import maevit as tmae
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh

ENCDEC = dict(image_size=32, patch_size=8, num_layers=2, num_heads=3, hidden_dim=96,
              mlp_dim=128, num_classes=7, residual_layers=["attention+mlp"] * 2,
              gate_type="sigmoid", gate_bias=0.0, add_budget_token="learnable",
              decoder_hidden_dim=96, decoder_num_layers=2, decoder_num_heads=2,
              decoder_mlp_dim=64)
MAE = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
           num_classes=10, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
           num_decoder_layers=1, num_decoder_heads=2, num_registers=1)
BUDGET = 0.5
MODULE_TOL = dict(rtol=2e-4, atol=2e-4)


def _images(seed, b=3):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _jax_model(name, args, seed):
    """jax_build_model(name, args, seed=seed), its init jitted (one
    compilation, where the eager init dispatches op by op)."""
    module = resolve_model_class(name)(**args)
    budget = 1.0 if module.accepts_budget else None
    init = jax.jit(lambda rngs, x: module.init(rngs, x, train=False, budget=budget,
                                               noise_value=None)["params"])
    params = init(init_rngs(seed), jnp.zeros((1, 32, 32, 3), jnp.float32))
    return jax_build_model(name, args, seed=seed, params=params)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """A seeded JAX model with random heads, mask token and gates (as
    tests/test_inference.py:461-541), the port's model with its weights,
    and the tree."""
    args = ENCDEC if name == "encdecresidualvit" else MAE
    jm = _jax_model(name, args, 3)
    rng = np.random.default_rng(7)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    heads = ("head",) if name == "encdecresidualvit" else ("head", "decoder_head")
    for leaf in heads:
        tree[leaf]["kernel"][:] = rng.normal(0, 0.1, tree[leaf]["kernel"].shape)
    mask_token = tree["decoder"]["mask_token"] if name == "encdecresidualvit" else \
        tree["mask_token"]
    mask_token[:] = rng.normal(0, 0.3, mask_token.shape)
    for lp in tree["encoder"].values():
        if isinstance(lp, dict) and "residual_gate" in lp:
            kern = lp["residual_gate"]["projection"]["kernel"]
            kern[:] = rng.normal(0, 0.5, kern.shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_jax(build_model(name, args, device="cpu"), tree)
    return jm, tm, tree


@functools.lru_cache(maxsize=None)
def _jax_outputs(name, kind):
    """The JAX references, once each: the linen eval forward ("module"),
    the fp32 engine logits-only ("logits") and with recon_outputs
    ("recon"), the bf16 engine with recon_outputs ("recon_bf16")."""
    jm, _, _ = _pair(name)
    x = jnp.asarray(_images(11))
    kw = {"budget": BUDGET} if name == "encdecresidualvit" else {}
    if kind == "module":
        return jax.tree.map(np.asarray, jm(x, **kw)[0])
    dtype = jnp.bfloat16 if kind == "recon_bf16" else jnp.float32
    engine = JaxEngine(jm, compute_dtype=dtype, interpret=True,
                       recon_outputs=kind.startswith("recon"))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), engine(x, **kw))


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("name", ["encdecresidualvit", "maevit"])
def test_params_round_trip(name):
    """The JAX tree loads strictly (every key, every shape: a missing leaf
    raises) and comes back exactly through params_to_jax."""
    _, tm, tree = _pair(name)
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bad = jax.tree.map(lambda a: a, tree)
    del (bad["decoder"] if name == "encdecresidualvit" else bad)["mask_token"]
    with pytest.raises(KeyError):
        params_from_jax(build_model(name, ENCDEC if name == "encdecresidualvit" else MAE,
                                    device="cpu"), bad)


# ------------------------------------------------------------------- modules


def test_encdec_module_matches_linen():
    """Logits, reconstruction and mask image of the eval forward against
    linen's, with the aux masks and the one budget."""
    jm, tm, _ = _pair("encdecresidualvit")
    x = _images(11)
    want = _jax_outputs("encdecresidualvit", "module")
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x), budget=BUDGET)
    _, jaux = jm(jnp.asarray(x), budget=BUDGET)
    assert len(got) == 3 and got[1].shape == (3, 32, 32, 3) and got[2].shape == (3, 32, 32, 1)
    for g, w in zip(got, want):
        _close(g, w, MODULE_TOL["rtol"])
    assert set(aux["masks"]) == set(jaux["masks"]) == {"layer_0", "layer_1"}
    for key in aux["masks"]:
        _close(aux["masks"][key], jaux["masks"][key], MODULE_TOL["rtol"])
    last = aux["masks"]["layer_1"]
    assert 0 < float((last > 0).float().mean()) < 1  # gates both open and shut
    assert aux["current_budget"].dim() == 0 and float(aux["current_budget"]) == BUDGET


def test_maevit_module_matches_linen():
    """The eval forward (every patch, no shuffle) against linen's."""
    _, tm, _ = _pair("maevit")
    want = _jax_outputs("maevit", "module")
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(_images(11)))
    assert aux == {} and got[1].shape == (3, 32, 32, 3)
    for g, w in zip(got, want):
        _close(g, w, MODULE_TOL["rtol"])


def test_maevit_train_forward_matches_linen(monkeypatch):
    """The train forward (shuffle, drop int(0.25 * 16) = 4 patches, mask
    tokens, un-shuffle) against linen's under JAX's own permutation, fed
    through the port's permutation helper; the backward permutation is
    JAX's too. Without the patch the port draws its own from the
    generator."""
    jm, tm, _ = _pair("maevit")
    x = _images(12, b=2)
    (jl, jr), jaux = jm(jnp.asarray(x), train=True, rngs={"shuffle": jax.random.key(5)})
    perm = torch.from_numpy(np.asarray(jaux["forward_perm"]).astype(np.int64))
    drawn = tmae._shuffle_permutation(16, torch.Generator().manual_seed(0), "cpu")
    assert sorted(drawn.tolist()) == list(range(16))
    monkeypatch.setattr(tmae, "_shuffle_permutation", lambda n, gen, device: perm)
    with torch.no_grad():
        (tl, tr), aux = tm(torch.from_numpy(x), train=True)
    np.testing.assert_array_equal(aux["backward_perm"].numpy(), np.asarray(jaux["backward_perm"]))
    _close(tl, jl, MODULE_TOL["rtol"])
    _close(tr, jr, MODULE_TOL["rtol"])
    with torch.no_grad():
        (el, _), _ = tm(torch.from_numpy(x))
    assert not torch.allclose(el, tl)  # the dropped patches change the logits


def test_encdec_bridges_differing_widths():
    """Where the decoder's width differs from the encoder's (the shipped
    residualvitwithdecoder.yaml: 256 -> 192), the JAX module raises at
    construction (its decoder mixes hidden-wide tokens with a decoder-wide
    mask token); the port bridges with ``decoder_embed``, and its engine
    matches its module."""
    args = dict(ENCDEC, hidden_dim=64, num_heads=2)
    with pytest.raises(TypeError, match="broadcasting"):
        _jax_model("encdecresidualvit", args, 0)
    tm = build_model("encdecresidualvit", args, seed=1, device="cpu")
    assert tuple(tm.decoder_embed.kernel.shape) == (64, 96)
    x = _images(13)
    with torch.no_grad():
        tm.head.kernel.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
        want, _ = tm(torch.from_numpy(x), budget=BUDGET)
    got = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu",
                          recon_outputs=True)(x, budget=BUDGET)
    # the engine's tanh-gelu against the module's erf: JAX's 1e-3
    # (tests/test_inference.py:453-458)
    _close(got[0], want[0], 1e-3)
    _close(got[1], want[1], 1e-3)
    _close(got[2], want[2], 1e-5)


# ------------------------------------------------------------------- engines


@pytest.mark.parametrize("name", ["encdecresidualvit", "maevit"])
def test_engine_matches_jax_engine(name):
    """InferenceEngine against the JAX engine (fp32, interpret=True),
    logits-only and with recon_outputs, at JAX's tolerances; the plain
    twin equals the engine on the CPU."""
    _, tm, _ = _pair(name)
    x = _images(11)
    kw = {"budget": BUDGET} if name == "encdecresidualvit" else {}
    logit_tol = 2e-4 if name == "encdecresidualvit" else 1e-3
    logits = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x, **kw)
    _close(logits, _jax_outputs(name, "logits"), logit_tol)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", recon_outputs=True)
    got = engine(x, **kw)
    want = _jax_outputs(name, "recon")
    assert len(got) == len(want) == (3 if name == "encdecresidualvit" else 2)
    _close(got[0], want[0], logit_tol)
    _close(got[1], want[1], 1e-3)
    if name == "encdecresidualvit":
        _close(got[2], want[2], 1e-5)
        plain = residualvit_forward_plain(engine.params, torch.from_numpy(x), BUDGET,
                                          **engine._forward)
    else:
        plain = maevit_forward_plain(engine.params, torch.from_numpy(x), **engine._forward)
        assert all(torch.equal(a, b) for a, b in zip(
            maevit_forward_fused(engine.params, torch.from_numpy(x), **engine._forward), got))
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    # the linen outputs too (the engine's tanh-gelu against the module's erf)
    for g, w in zip(got, _jax_outputs(name, "module")):
        _close(g, w, 2e-3)


def test_encdec_engine_bf16_matches_jax_engine():
    """The bf16 engines with recon_outputs: the port's against JAX's at the
    repo's bf16 tolerance (tests/test_pallas.py:42)."""
    _, tm, _ = _pair("encdecresidualvit")
    got = InferenceEngine(tm, device="cpu", recon_outputs=True)(_images(11), budget=BUDGET)
    want = _jax_outputs("encdecresidualvit", "recon_bf16")
    assert [t.dtype for t in got] == [torch.float32] * 3
    for g, w in zip(got, want):
        _close(g, w, 3e-2)


def test_engine_guards():
    """The JAX engine's refusals (inference.py:2518-2544, :2631-2634,
    :2751-2754), recon under a tensor-parallel mesh (refused in JAX's words,
    inference.py:2575-2584) and under a data-parallel one."""
    _, enc, _ = _pair("encdecresidualvit")
    _, mae, _ = _pair("maevit")
    vit = build_model("vit", dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
                                  hidden_dim=32, mlp_dim=64, num_classes=5), device="cpu")
    res = build_model("residualvit", {k: v for k, v in ENCDEC.items()
                                      if not k.startswith("decoder_")}, device="cpu")
    for model, kwargs, match in (
            (mae, dict(quantized=True), "bf16 eval only"),
            (mae, dict(max_budget=0.5), "bf16 eval only"),
            (enc, dict(recon_outputs=True, quantized=True), "bf16-only"),
            (enc, dict(recon_outputs=True, compact=0.5), "bf16 single-program"),
            (vit, dict(recon_outputs=True), "reconstruction decoder"),
            (res, dict(recon_outputs=True), "reconstruction decoder"),
            (enc, dict(recon_outputs=True, mesh=types.SimpleNamespace(shape={"model": 2})),
             "serve other families / modes data-parallel"),
            (mae, dict(recon_outputs=True, mesh=types.SimpleNamespace(shape={"model": 2})),
             "serve other families / modes data-parallel")):
        with pytest.raises(NotImplementedError, match=match):
            InferenceEngine(model, device="cpu", **kwargs)
    # recon under a data-parallel mesh is ported: on a one-rank data axis
    # the engine is the single-device one
    one = Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, None, None, 0, 0, torch.device("cpu"))
    x = _images(3, b=2)
    for model, kw in ((mae, {}), (enc, dict(budget=BUDGET))):
        got = InferenceEngine(model, device="cpu", recon_outputs=True, mesh=one)(x, **kw)
        want = InferenceEngine(model, device="cpu", recon_outputs=True)(x, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="requires add_budget_token"):
        build_model("encdecresidualvit", dict(ENCDEC, add_budget_token=False), device="cpu")
    # dropout is ported (tests/test_torch_dropout.py)
    (logits, recon), _ = build_model("maevit", dict(MAE, dropout=0.1), device="cpu")(
        torch.from_numpy(_images(1, b=1)), train=True)
    assert torch.isfinite(logits).all() and torch.isfinite(recon).all()
    # the NoiseBlock is ported (an MoE builds with one); the MAE has none and
    # refuses the keyword, as JAX's module does
    moe = build_model("moevit", dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
                                     hidden_dim=32, mlp_dim=64, num_classes=5, noise_layer=0),
                      device="cpu")
    assert moe.noise_layer == 0
    with pytest.raises(TypeError, match="noise_layer"):
        build_model("maevit", MAE, noise_args={"layer": 0}, device="cpu")


# ------------------------------------------------- the attention at head dim 48

D48 = 96  # two heads of 48
# the 16-key slice and 64-key tile edges, the EncDec decoder's 400 tokens
# (401: one past), and the card's route edges at head dim 48: two CTAs an
# SM up to 512 tokens, the last wgmma length 1,088
HD48_TOKENS = (1, 15, 16, 17, 63, 64, 65, 400, 401, 512, 513, 1088, 1089)
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv48(n):
    return np.random.default_rng(4800 + n).normal(size=(2, n, 3 * D48)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_hd48(n):
    """``_attn_scores_pv`` per image and head on _qkv48(n), fp32 and bf16,
    from one jitted function."""

    def heads(qkv):
        b = qkv.shape[0]
        h = qkv.reshape(b, n, 3, 2, 48).transpose(2, 0, 3, 1, 4)
        one = lambda q, k, v: _attn_scores_pv(q, k, v, 1.0 / 48 ** 0.5).astype(qkv.dtype)  # noqa: E731
        out = jax.vmap(jax.vmap(one))(h[0], h[1], h[2])
        return out.transpose(0, 2, 1, 3).reshape(b, n, D48)

    every = jax.jit(lambda x: {name: heads(x.astype(jdt)) for name, (jdt, _, _) in DTYPES.items()})
    return {k: np.asarray(v, np.float32) for k, v in every(jnp.asarray(_qkv48(n))).items()}


def test_head_dim_48_is_instantiated():
    """The kernel's head dims, the launch key of head dim 48 (asked of the
    key function, not of a launch) and its query scale 48^-0.5 log2(e)."""
    assert tfa.HEAD_DIMS == (64, 32, 48)
    assert tfa.attn_scores_pv_key(48) == "attn_scores_pv.hd48"
    assert tfa.attn_scores_pv_key(48, kmask=True) == "attn_scores_pv.kmask.hd48"
    assert tfa.attn_scores_pv_key(64, phantom=True) == "attn_scores_pv.kweight"
    assert tfa.attn_scores_pv_key(32) == "attn_scores_pv.hd32"
    assert tfa._qscale(48) == (1.0 / 48 ** 0.5) * tfa.LOG2E


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", HD48_TOKENS)
def test_attn_scores_pv_hd48_against_jax(n, dtype):
    """The plain attention at head dim 48 against ``_attn_scores_pv`` per
    image and head at the 16-key slice and 64-key tile edges, the EncDec
    decoder's 400 tokens (401: one past) and the card's route edges (512 /
    513, 1,088 / 1,089), so that the plain version the card holds the
    kernel to is held to JAX at the same lengths; the wrapper is the plain
    version, bit for bit, with no launch."""
    _, tdt, tol = DTYPES[dtype]
    x = torch.from_numpy(_qkv48(n)).to(tdt)
    tfa.reset_launch_counts()
    got = tfa.attn_scores_pv(x, 2)
    assert tfa.LAUNCHES == {} and got.dtype == tdt and got.shape == (2, n, D48)
    assert torch.equal(got, tfa.attn_scores_pv_ref(x, 2))
    np.testing.assert_allclose(got.float().numpy(), _jax_hd48(n)[dtype], rtol=tol, atol=tol)
