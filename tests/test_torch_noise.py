"""The port's channel noise (the NoiseBlock) against the JAX package's, on
the CPU: ``ops/noise.py`` against JAX's ops, every module with a NoiseBlock
against linen, every noisy engine forward against the JAX engine run as
its own tests run it (``interpret=True``, fp32), the port's engine against
its own module under one generator, and the guards.

JAX's PRNG draws cannot be reproduced in torch, so the port is fed JAX's
own realization: where the JAX module takes the raw ``noise`` key (ViT,
the ResidualViT family, RankViT, MoE, and every engine), the test draws
``jax.random.normal`` / ``permutation`` from that key and hands the array
to the port's draw helpers (``ops/noise.standard_normal`` /
``token_permutation``); the A-ViT splits its key inside its scan, so there
both sides take one numpy draw. Tolerances: the ops 1e-6; modules 2e-4
(both erf-gelu and the max-subtracted softmax); bf16 engines
``rtol=atol=2e-4`` (tests/test_inference.py:34); the int8 engines
within 5e-3 of max|logit| with the attention pinned to JAX's, as
tests/test_torch_quant_engine.py holds them without noise (a bf16
rounding flip of the attention output, requantized, moves more than
2e-4); the engine against its module 1e-3 / 5e-4 (tanh against erf gelu,
tests/test_inference.py:624). Inputs come from numpy with a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.ops import noise as jnoise
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.models.adapters import params_to_jax
from peekvit_torch.ops import noise as tnoise
from peekvit_torch.ops.cuda import fused_attention as tfa
from tests.test_torch_quant_kernels import _jax_attention

BASE = dict(image_size=32, patch_size=8, num_layers=3, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5)
RESIDUAL = dict(BASE, residual_layers=["attention+mlp"] * 3, gate_type="sigmoid", gate_bias=0.0,
                add_budget_token="learnable")
FAMILIES = {  # name -> (registry name, args, eval budget)
    "vit": ("vit", BASE, None),
    "residualvit": ("residualvit", RESIDUAL, 0.5),
    "eeresidualvit": ("eeresidualvit", RESIDUAL, 0.5),
    "encdecresidualvit": ("encdecresidualvit", dict(RESIDUAL, decoder_num_layers=1,
                                                    decoder_num_heads=2, decoder_mlp_dim=64), 0.5),
    "rankvit": ("rankvit", dict(BASE, rankvit_layers=[1, 2]), 0.5),
    "moevit": ("moevit", dict(BASE, mlp_moes=[1, 1, 3], attn_moes=[1, 2, 1]), None),
    "adavit": ("adavit", dict(BASE, gate_scale=5.0, gate_center=0.0), None),
}
VALUES = {"gaussian": 6.0, "token_drop": 0.3}
LAYER = 1  # the first ranked layer of the RankViT


def _images(seed=0, b=3):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


def _port_model(name, args, noise_type, layer=LAYER):
    model = build_model(name, args, noise_args={"layer": layer, "noise_type": noise_type},
                        seed=5, device="cpu")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key in ("head.kernel", "class_tokens", "class_token"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _jax_model(name, args, tm, noise_type, layer=LAYER):
    module = resolve_model_class(name)(**args, noise_layer=layer, noise_type=noise_type)
    tree = jax.tree.map(jnp.asarray, params_to_jax(tm))
    return JaxModel(module=module, params=tree, model_class=name, model_args=args,
                    noise_args={"layer": layer, "noise_type": noise_type})


def _jax_draw(noise_type, key, shape):
    """JAX's own realization from ``key``: standard normals of the tokens'
    shape, or the permutation of their count."""
    if noise_type == "gaussian":
        return np.array(jax.random.normal(key, shape, dtype=jnp.float32))
    return np.array(jax.random.permutation(key, shape[1]))


def _feed_port(monkeypatch, draw):
    """The port's draw helpers return ``draw``."""
    monkeypatch.setattr(tnoise, "standard_normal",
                        lambda x, gen=None: torch.from_numpy(draw).to(x.device))
    monkeypatch.setattr(tnoise, "token_permutation",
                        lambda x, gen=None: torch.from_numpy(draw).to(x.device))


def _n_tokens(name, args):
    n = (args["image_size"] // args["patch_size"]) ** 2 + 1
    return n + 1 if "residual" in name else n  # the budget token


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ----------------------------------------------------------------- the ops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_snr_noise_matches_jax(dtype):
    """Signal power from the fp32 mean of x², 0 dB the no-noise sentinel, the
    noise cast to x's dtype before the add; the draw takes no gradient."""
    x = (np.random.default_rng(1).normal(size=(2, 17, 32)) * 1.5).astype(np.float32)
    key = jax.random.key(2)
    draw = _jax_draw("gaussian", key, x.shape)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    for snr in (0.0, -3.0, 5.0, 20.0):
        want = jnoise.gaussian_snr_noise(jx, snr, key)
        got = tnoise.gaussian_snr_noise(tx, snr, noise=torch.from_numpy(draw))
        assert got.dtype == tx.dtype
        _close(got.float(), want.astype(jnp.float32), 1e-6)
        # a tensor value takes the device path, a number the host's: one result
        assert torch.equal(tnoise.gaussian_snr_noise(tx, torch.tensor(snr),
                                                     noise=torch.from_numpy(draw)), got)
        if snr == 0.0:
            assert torch.equal(got, tx)
    t = tx.float().clone().requires_grad_()
    tnoise.gaussian_snr_noise(t, 5.0, torch.Generator().manual_seed(0)).sum().backward()
    assert torch.equal(t.grad, torch.ones_like(t))


def test_token_drop_noise_matches_jax():
    """floor(prob * N) tokens of every image zeroed, one permutation for the
    batch, keep = argsort(perm) >= num_mask; the keep mask takes no
    gradient."""
    for n in (17, 198):
        x = np.random.default_rng(n).normal(size=(2, n, 8)).astype(np.float32)
        key = jax.random.key(n)
        perm = _jax_draw("token_drop", key, x.shape)
        for prob in (0.0, 0.1, 0.3, 1.0):
            want = np.asarray(jnoise.token_drop_noise(jnp.asarray(x), prob, key))
            got = tnoise.token_drop_noise(torch.from_numpy(x), prob,
                                          noise=torch.from_numpy(perm)).numpy()
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                tnoise.token_drop_noise(torch.from_numpy(x), torch.tensor(prob),
                                        noise=torch.from_numpy(perm)).numpy(), want)
            dropped = (got == 0).all(axis=(0, 2))
            assert dropped.sum() == int(np.floor(np.float32(prob) * n))
    t = torch.ones(2, 17, 8, requires_grad=True)
    out = tnoise.apply_noise(t, "token_drop", 0.5, torch.Generator().manual_seed(1))
    out.sum().backward()
    assert torch.equal(t.grad, (out != 0).float())
    with pytest.raises(ValueError, match="unknown noise_type"):
        tnoise.apply_noise(t, "salt", 0.5)


def test_draws_run_on_the_tokens_device():
    """The default generator is seeded 0 on the tokens' device (two calls
    draw alike); a generator on another device than the tokens' raises."""
    x = torch.ones(2, 5, 4)
    a, b = (tnoise.apply_noise(x, "gaussian", 3.0) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, x)
    for noise_type in tnoise.NOISE_TYPES:
        with pytest.raises(ValueError, match="tokens' device"):
            tnoise.apply_noise(x.to("meta"), noise_type, 0.5, torch.Generator())


# ------------------------------------------------------------- the modules


@pytest.mark.parametrize("noise_type", list(VALUES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_module_matches_linen(family, noise_type, monkeypatch):
    """The eval forward with a NoiseBlock before layer 1 against linen's
    under the same realization: the outputs at 2e-4, and the noise moves
    them."""
    name, args, budget = FAMILIES[family]
    tm = _port_model(name, args, noise_type)
    jm = _jax_model(name, args, tm, noise_type)
    x = _images(3)
    key = jax.random.key(9)
    shape = (x.shape[0], _n_tokens(name, args), args["hidden_dim"])
    draw = _jax_draw(noise_type, key, shape)
    value = VALUES[noise_type]
    kw = {} if budget is None else {"budget": budget}
    jkw = dict(kw, noise_value=jnp.float32(value))
    if name == "adavit":  # make_rng inside the scan: both sides take one draw
        fed = jnp.asarray(draw)
        monkeypatch.setattr(jax.random, "normal", lambda k, s, dtype=jnp.float32: fed)
        monkeypatch.setattr(jax.random, "permutation", lambda k, n: fed)
    else:
        jkw["noise_rng"] = key
    want, _ = jax.jit(lambda p, x: jm.module.apply({"params": p}, x, train=False,
                                                   rngs={"noise": key}, **jkw))(
        jm.params, jnp.asarray(x))
    monkeypatch.undo()
    _feed_port(monkeypatch, draw)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), noise_value=value, **kw)
        clean, _ = tm(torch.from_numpy(x), **kw)
    got, want, clean = ((t if isinstance(t, tuple) else (t,)) for t in (got, want, clean))
    for g, w in zip(got, want):
        _close(g, w, 2e-4)
    main = -1 if family == "eeresidualvit" else 0  # the final exit; the logits
    assert float((got[main] - clean[main]).abs().max()) > 1e-3


# ------------------------------------------------------------- the engines

ENGINES = {  # case -> (family, noise type, engine keywords, budget)
    "vit_fused": ("vit", "gaussian", {}, None),
    "vit_quant": ("vit", "token_drop", dict(quantized=True), None),
    "rankvit_fused": ("rankvit", "gaussian", {}, 0.5),
    "rankvit_padded": ("rankvit", "token_drop", dict(max_budget=0.75), 0.5),
    "rankvit_padded_quant": ("rankvit", "gaussian", dict(quantized=True, max_budget=0.75), 0.5),
    "rankvit_quant": ("rankvit", "token_drop", dict(quantized=True), 0.5),
    "moevit_fused": ("moevit", "gaussian", {}, None),
    "moevit_quant": ("moevit", "token_drop", dict(quantized=True), None),
    "residualvit_quant": ("residualvit", "gaussian", dict(quantized=True), 0.5),
    "residualvit_fused": ("residualvit", "token_drop", {}, 0.5),
    "encdec_recon": ("encdecresidualvit", "gaussian", dict(recon_outputs=True), 0.5),
}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engine_matches_jax_engine(case, monkeypatch):
    """Each noisy engine forward (the NoiseBlock before layer 1, at the
    first ranked layer of the RankViT) against the JAX engine's under the
    same realization; the int8 engines with the attention pinned to
    JAX's."""
    family, noise_type, kw, budget = ENGINES[case]
    name, args, _ = FAMILIES[family]
    tm = _port_model(name, args, noise_type)
    jm = _jax_model(name, args, tm, noise_type)
    x = _images(4)
    key = jax.random.key(13)
    value = VALUES[noise_type]
    bkw = {} if budget is None else {"budget": budget}
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, **kw)(
        jnp.asarray(x), noise_value=value, noise_rng=key, **bkw)
    draw = _jax_draw(noise_type, key, (x.shape[0], _n_tokens(name, args), args["hidden_dim"]))
    _feed_port(monkeypatch, draw)
    if kw.get("quantized"):
        monkeypatch.setattr(tfa, "attn_scores_pv_ref", _jax_attention)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", **kw)
    got = engine(x, noise_value=value, **bkw)
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    for g, w in zip(got, want):
        if kw.get("quantized"):
            w = np.asarray(w, np.float32)
            assert np.abs(g.numpy() - w).max() <= 5e-3 * np.abs(w).max()
        else:
            _close(g, w, 2e-4)
    clean = engine(x, **bkw)
    clean = clean[0] if isinstance(clean, tuple) else clean
    assert float((got[0] - clean).abs().max()) > 1e-3


@pytest.mark.parametrize("family", ["vit", "residualvit", "rankvit", "moevit"])
def test_engine_matches_its_module_under_one_generator(family):
    """The port's engine and its module draw the same noise from the same
    generator state (both on the CPU here; on the card both on it)."""
    name, args, budget = FAMILIES[family]
    for noise_type, value in VALUES.items():
        tm = _port_model(name, args, noise_type)
        x = torch.from_numpy(_images(5))
        kw = {} if budget is None else {"budget": budget}
        engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
        got = engine(x, noise_value=value, noise_rng=torch.Generator().manual_seed(21), **kw)
        with torch.no_grad():
            want, _ = tm(x, noise_value=value, noise_rng=torch.Generator().manual_seed(21), **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=5e-4)
        # the defaults: value 0.0 (no noise) and a generator seeded 0
        np.testing.assert_allclose(engine(x, **kw).numpy(), tm(x, **kw)[0].detach().numpy(),
                                   rtol=1e-3, atol=5e-4)
        assert torch.equal(engine(x, noise_value=value, **kw),
                           engine(x, noise_value=value, noise_rng=tnoise.default_generator("cpu"),
                                  **kw))


def test_vit_engine_leaves_the_one_call_chain_only_with_noise(monkeypatch):
    """With a noise layer the ViT engine runs per layer (JAX :361-379);
    without one it keeps the one-call stack."""
    calls = []
    real = tfa.encoder_layers_one_call_ref
    monkeypatch.setattr(tfa, "encoder_layers_one_call_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    from peekvit_torch import inference as ti

    monkeypatch.setattr(ti, "encoder_layers_one_call",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _images(6)
    InferenceEngine(build_model("vit", BASE, device="cpu"), device="cpu")(x)
    assert calls == [1]
    InferenceEngine(_port_model("vit", BASE, "gaussian"), device="cpu")(x, noise_value=3.0)
    assert calls == [1]


def test_engine_guards():
    """JAX's four guards (compact=, a noise layer after the first ranked
    one, tensor-parallel serving, the A-ViT engine) raise in the port; a
    noise_value to an engine without a noise layer (MAE, PCT included)
    raises ValueError; MAE and PCT refuse a noise layer at construction."""
    res = _port_model("residualvit", RESIDUAL, "gaussian")
    with pytest.raises(NotImplementedError, match="NoiseBlock"):
        InferenceEngine(res, device="cpu", compact=0.5)
    late = _port_model("rankvit", dict(BASE, rankvit_layers=[1, 2]), "gaussian", layer=2)
    with pytest.raises(NotImplementedError, match="first ranked layer"):
        InferenceEngine(late, device="cpu")
    mesh = type("Mesh", (), {"shape": {"model": 2, "data": 1}})()
    with pytest.raises(NotImplementedError, match="NoiseBlock"):
        InferenceEngine(_port_model("vit", BASE, "gaussian"), device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match="ACT loop"):
        InferenceEngine(_port_model("adavit", FAMILIES["adavit"][1], "gaussian"), device="cpu")
    x = _images(7, b=1)
    with pytest.raises(ValueError, match="without a noise layer"):
        InferenceEngine(build_model("vit", BASE, device="cpu"), device="cpu")(x, noise_value=1.0)
    mae = dict(BASE, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
               num_decoder_layers=1, num_decoder_heads=2)
    with pytest.raises(ValueError, match="without a noise layer"):
        InferenceEngine(build_model("maevit", mae, device="cpu"), device="cpu")(
            x, noise_value=1.0)
    for family, args in (("maevit", mae), ("pct", dict(num_points=32, num_layers=1,
                                                         num_heads=2, hidden_dim=32,
                                                         mlp_dim=64, num_classes=5))):
        with pytest.raises(TypeError, match="noise_layer"):
            build_model(family, args, noise_args={"layer": 1}, device="cpu")
    with pytest.raises(ValueError, match="unknown noise_type"):
        build_model("vit", BASE, noise_args={"layer": 1, "noise_type": "salt"}, device="cpu")
