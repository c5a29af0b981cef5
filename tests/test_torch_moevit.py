"""The port's MoE ViT (``moevit``) against the JAX package's, on the CPU.

Weights: a seeded JAX tree loads strictly and comes back exactly, the
expert stacks with no transpose. Module: the eval forward and its one-hot
``gating_probs`` against linen at 2e-4, and the train forward with the
same Gumbel noise on both sides (JAX's draw patched), with a finite gate
gradient. Engines: the fp32 engine against the JAX engine run as its own
tests run it (``interpret=True``, fp32; tests/test_inference.py:358) at
2e-4, argmax equal; routed at capacity E against the port's dense engine
at 2e-5 (tests/test_moe_routed.py); one bf16 case at 3e-2; the int8
engine against the JAX int8 engine at 5e-2 of max|logit|, argmax equal
(tests/test_inference.py:728-730). ``_routed_moe_mlp`` against JAX's at
full capacity and at one row an expert, where overflow rows are exactly
0; GEMM s8 ``bias_f32``'s plain version and ``quant_experts`` against
``_quant_linear_xla`` bit for bit; the guards.

One config reaches every engine branch: 3 layers, ``mlp_moes=[1, 1, 3]``,
``attn_moes=[1, 2, 1]`` (the folded layer; an attention MoE beside the MLP
block; the attention block beside a 3-expert MLP); JAX's own ``[1, 2, 3] /
[1, 2, 1]`` is the module's second case. Each JAX engine run lives in one
test. Inputs come from numpy with a seed.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.inference import _routed_moe_mlp as jax_routed_moe_mlp
from peekvit_tpu.inference import quantize_moevit_params as jax_quantize_moevit_params
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.models.registry import init_rngs, resolve_model_class
from peekvit_tpu.ops import gates as jax_gates
from peekvit_tpu.ops.pallas.quant_blocks import _quant_linear_xla
from peekvit_torch import InferenceEngine, Trainer, build_model
from peekvit_torch import inference as tinf
from peekvit_torch.models.adapters import params_from_jax, params_to_jax, tree_map
from peekvit_torch.ops import gates as tgates
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import quant_blocks as tq
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.training.optim import AdamW

BASE = dict(image_size=32, patch_size=8, num_layers=3, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=10)
CONFIGS = {"mixed": dict(BASE, mlp_moes=[1, 1, 3], attn_moes=[1, 2, 1]),
           "jax": dict(BASE, mlp_moes=[1, 2, 3], attn_moes=[1, 2, 1])}
TOL = 2e-4


def _images(seed, b=4):
    return np.random.default_rng(seed).normal(size=(b, 32, 32, 3)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """A seeded JAX MoE model with its head at 0.05 (the init's zero head
    makes every logit 0; tests/test_inference.py:371), its init jitted once,
    the port's model with its weights, and the tree."""
    args = CONFIGS[name]
    module = resolve_model_class("moevit")(**args)
    init = jax.jit(lambda rngs, x: module.init(rngs, x, train=False, budget=None,
                                               noise_value=None)["params"])
    params = init(init_rngs(4), jnp.zeros((1, 32, 32, 3), jnp.float32))
    jm = jax_build_model("moevit", args, seed=4, params=params)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    rng = np.random.default_rng(1)
    tree["head"]["kernel"][:] = rng.normal(0, 0.05, tree["head"]["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_jax(build_model("moevit", args, device="cpu"), tree)
    return jm, tm, tree


def _jax_engine(jm, x, **kw):
    return np.asarray(JaxEngine(jm, interpret=True, **kw)(jnp.asarray(x)), np.float32)


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("name", list(CONFIGS))
def test_params_round_trip(name):
    """The JAX tree loads strictly (every key, every shape: the (E, ...)
    expert stacks and the gates included) and comes back exactly."""
    _, tm, tree = _pair(name)
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert back["encoder"]["layers_2"]["mlp"]["experts"]["fc1_kernel"].shape == (3, 32, 64)
    assert back["encoder"]["layers_1"]["self_attention"]["experts"]["in_proj_kernel"].shape == (
        2, 32, 96)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["encoder"]["layers_1"]["self_attention"]["gating_network"]
    with pytest.raises(KeyError):
        params_from_jax(build_model("moevit", CONFIGS[name], device="cpu"), bad)
    wrong = jax.tree.map(lambda a: a, tree)
    stack = wrong["encoder"]["layers_2"]["mlp"]["experts"]
    stack["fc1_kernel"] = stack["fc1_kernel"].transpose(0, 2, 1)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(build_model("moevit", CONFIGS[name], device="cpu"), wrong)


# ------------------------------------------------------------------- modules


@pytest.mark.parametrize("name", list(CONFIGS))
def test_module_matches_linen(name):
    """The eval forward's logits and its one-hot gating_probs (only the
    gated sublayers of the layers with experts) against linen's."""
    jm, tm, _ = _pair(name)
    x = _images(11)
    want, jaux = jm(jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    _close(got, want, TOL)
    jg, tg = jaux["gating_probs"], aux["gating_probs"]
    assert {k: set(v) for k, v in tg.items()} == {k: set(v) for k, v in jg.items()}
    assert "layer_0" not in tg and set(tg["layer_1"]) >= {"attn"}
    for layer, subs in jg.items():
        for sub, probs in subs.items():
            np.testing.assert_array_equal(tg[layer][sub].numpy(), np.asarray(probs))
            assert set(np.unique(np.asarray(probs))) <= {0.0, 1.0}


def test_train_forward_matches_linen(monkeypatch):
    """The train forward (the hard gumbel-softmax gates, straight-through)
    against linen's under the same Gumbel noise: JAX's draws are replaced by
    numpy draws, which the port takes in the same order (layer by layer, the
    attention's gate first). The gate kernels get a finite, nonzero
    gradient through the straight-through estimator."""
    jm, tm, _ = _pair("mixed")
    x = _images(12, b=2)
    rng = np.random.default_rng(5)
    shapes = [(2, 17, 2), (2, 17, 3)]  # layer 1's attention gate, layer 2's MLP gate
    noise = [rng.gumbel(size=s).astype(np.float32) for s in shapes]

    jax_draws = iter(noise)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(next(jax_draws)))
    want, jaux = jm(jnp.asarray(x), train=True)
    port_draws = iter([torch.from_numpy(a) for a in noise])
    monkeypatch.setattr(tgates, "_gumbel_noise", lambda shape, generator, device:
                        next(port_draws))
    tm.train()
    try:
        got, aux = tm(torch.from_numpy(x), train=True)
    finally:
        tm.eval()
    _close(got.detach(), want, TOL)
    for layer, subs in jaux["gating_probs"].items():
        for sub, probs in subs.items():
            _close(aux["gating_probs"][layer][sub].detach(), probs, TOL)
    got.square().sum().backward()
    for sub, layer in (("self_attention", "layers_1"), ("mlp", "layers_2")):
        grad = getattr(getattr(tm.encoder, layer), sub).gating_network.gate.kernel.grad
        assert grad is not None and torch.isfinite(grad).all() and grad.abs().sum() > 0
    tm.zero_grad(set_to_none=True)
    with torch.no_grad():  # eval draws no noise: the noise moved some tokens' experts
        _, eaux = tm(torch.from_numpy(x))
    assert any(torch.any(aux["gating_probs"][layer][sub].argmax(-1) != probs.argmax(-1))
               for layer, subs in eaux["gating_probs"].items() for sub, probs in subs.items())


def test_gumbel_softmax_matches_jax():
    """gumbel_softmax against JAX's: eval is one_hot(argmax), the first
    maximal index on a tie; train with the same noise, soft and hard
    (values, and the straight-through gradient of a weighted sum)."""
    logits = np.array([[1.0, 3.0, 3.0], [0.5, -1.0, 0.5], [2.0, 0.0, 1.0]], np.float32)
    want = np.asarray(jax_gates.gumbel_softmax(jnp.asarray(logits), None, train=False))
    got = tgates.gumbel_softmax(torch.from_numpy(logits), train=False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), [1, 0, 0])
    key = jax.random.key(3)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    weights = np.random.default_rng(0).normal(size=logits.shape).astype(np.float32)
    for hard in (True, False):
        def jfn(z, hard=hard):
            return jax_gates.gumbel_softmax(z, key, tau=0.7, hard=hard)

        want = np.asarray(jfn(jnp.asarray(logits)))
        want_g = np.asarray(jax.grad(lambda z: jnp.sum(jfn(z) * weights))(jnp.asarray(logits)))
        t = torch.from_numpy(logits).requires_grad_()
        got = tgates.gumbel_softmax(t, tau=0.7, hard=hard, noise=torch.from_numpy(noise))
        (got * torch.from_numpy(weights)).sum().backward()
        _close(got.detach(), want, 1e-6)
        _close(t.grad, want_g, 1e-5)
    a = tgates.gumbel_softmax(torch.zeros(64, 4), torch.Generator().manual_seed(1), hard=False)
    b = tgates.gumbel_softmax(torch.zeros(64, 4), torch.Generator().manual_seed(1), hard=False)
    assert torch.equal(a, b) and a.std(0).min() > 0


# ------------------------------------------------------------------- engines


def test_engine_matches_jax_engine():
    """The fp32 engine against the JAX engine (interpret, fp32) and linen at
    2e-4, argmax equal; routed at capacity E (cap = T: no overflow) against
    the port's dense engine at 2e-5; the plain twin fed the engine's
    choices equals it; other choices change it."""
    jm, tm, _ = _pair("mixed")
    x = _images(13)
    want = _jax_engine(jm, x, compute_dtype=jnp.float32)
    linen = np.asarray(jm(jnp.asarray(x))[0])
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    got = engine(x).numpy()
    _close(got, want, TOL)
    _close(got, linen, TOL)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    routed = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", routed=3.0)
    _close(routed(x).numpy(), got, 2e-5)
    assert routed._forward["routed_capacity"] == 3.0
    fwd = {k: v for k, v in engine._forward.items() if k != "compute_dtype"}
    chosen = {}
    xt = torch.from_numpy(x)
    fused = tinf.moevit_forward_fused(engine.params, xt, compute_dtype=torch.float32,
                                      expert_out=chosen, **fwd)
    assert set(chosen) == {(1, "attn"), (2, "mlp")} and chosen[(2, "mlp")].shape == (4, 17)
    assert torch.equal(fused, engine(x))
    plain = tinf.moevit_forward_plain(engine.params, xt, expert_ids=chosen, **fwd)
    assert torch.equal(plain, fused)
    flipped = {k: (v + 1) % (3 if k[1] == "mlp" else 2) for k, v in chosen.items()}
    other = tinf.moevit_forward_plain(engine.params, xt, expert_ids=flipped, **fwd)
    assert not torch.allclose(other, plain)


def test_bf16_engine_matches_jax_bf16_engine():
    """The bf16 engine against the JAX bf16 engine (interpret) at 3e-2, the
    repo's bf16 tolerance (tests/test_pallas.py:42), argmax equal; the
    prepared tree keeps the gates fp32 and folds only the layer whose
    sublayers have one expert each, and stacks no layer."""
    jm, tm, _ = _pair("mixed")
    x = _images(14, b=3)
    want = _jax_engine(jm, x, compute_dtype=jnp.bfloat16)
    engine = InferenceEngine(tm, compute_dtype=torch.bfloat16, device="cpu")
    got = engine(x).numpy()
    _close(got, want, 3e-2)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    enc = engine.params["encoder"]
    assert "_stacked_layers" not in enc
    assert "_folded_qkv" in enc["layers_0"] and "_folded_qkv" not in enc["layers_1"]
    assert "_folded_fc1" not in enc["layers_2"]
    gate = enc["layers_2"]["mlp"]["gating_network"]["gate"]
    assert gate["kernel"].dtype == torch.float32 and gate["bias"].shape == (1, 3)
    stack = enc["layers_2"]["mlp"]["experts"]
    assert stack["fc1_kernel"].dtype == torch.bfloat16 and stack["fc1_bias"].shape == (3, 64)


def test_quantized_engine_matches_jax():
    """The int8 engine against the JAX int8 engine (interpret, fp32) at 5e-2
    of max|logit|, argmax equal (tests/test_inference.py:728-730); the int8
    tree against JAX's leaf for leaf, exactly; each expert's int8 weight in
    the s8 GEMM's layout after preparation; a bf16 int8 engine gives finite
    logits of the same argmax."""
    jm, tm, tree = _pair("mixed")
    x = _images(15)
    want = _jax_engine(jm, x, compute_dtype=jnp.float32, quantized=True)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", quantized=True)
    got = engine(x).numpy()
    spread = np.abs(want).max()
    assert np.abs(got - want).max() < 0.05 * spread
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    jq = jax.tree.map(np.asarray, jax_quantize_moevit_params(jm.params))
    tq_tree = tinf.quantize_moevit_params(tree_map(torch.from_numpy, tree))
    flat_j = jax.tree_util.tree_leaves_with_path(jq)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tree_map(lambda t: t.numpy(),
                                                                    tq_tree)))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        assert flat_t[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_t[path], leaf)
    mlp = engine.params["encoder"]["layers_2"]["mlp"]
    assert mlp["w1_q"].shape == (3, 32, 64) and mlp["s1"].dtype == torch.float32
    assert all(mlp["w1_q"][e].t().is_contiguous() for e in range(3))
    assert engine.params["encoder"]["layers_0"]["self_attention"]["wqkv_q"].t().is_contiguous()
    low = InferenceEngine(tm, device="cpu", quantized=True)(x).numpy()
    assert np.isfinite(low).all() and np.abs(low - got).max() < 0.05 * spread


def test_routed_moe_mlp_matches_jax():
    """_routed_moe_mlp against JAX's and a dense per-token loop: equal at
    capacity E (cap = T); at one row an expert only the first token routed
    to each expert (token order) keeps its row, and every other row is
    exactly 0."""
    rng = np.random.default_rng(7)
    b, n, d, m, e = 2, 4, 8, 16, 2
    z = rng.normal(size=(b, n, d)).astype(np.float32)
    gating = {"gate": {"kernel": rng.normal(size=(d, e)).astype(np.float32),
                       "bias": np.zeros((e,), np.float32)}}
    experts = {"fc1_kernel": rng.normal(size=(e, d, m)), "fc1_bias": rng.normal(size=(e, m)),
               "fc2_kernel": rng.normal(size=(e, m, d)), "fc2_bias": rng.normal(size=(e, d))}
    experts = {k: v.astype(np.float32) for k, v in experts.items()}
    jt = functools.partial(jax.tree.map, jnp.asarray)
    tt = functools.partial(tree_map, torch.from_numpy)

    def port(cf):
        return tinf._routed_moe_mlp(torch.from_numpy(z), tt(gating), tt(experts),
                                    lambda t: t, cf).numpy()

    def jax_ref(cf):
        return np.asarray(jax_routed_moe_mlp(jnp.asarray(z), jt(gating), jt(experts),
                                             lambda t: t, cf))

    eid = (z.reshape(-1, d) @ gating["gate"]["kernel"]).argmax(-1)
    dense = []
    for i, tok in enumerate(z.reshape(-1, d)):
        h = torch.nn.functional.gelu(torch.from_numpy(tok @ experts["fc1_kernel"][eid[i]]
                                                      + experts["fc1_bias"][eid[i]]))
        dense.append(h.numpy() @ experts["fc2_kernel"][eid[i]] + experts["fc2_bias"][eid[i]])
    dense = np.stack(dense)
    full = port(float(e))
    _close(full, jax_ref(float(e)), 1e-5)
    _close(full.reshape(-1, d), dense, 1e-5)
    tiny = port(e / (b * n)).reshape(-1, d)
    _close(tiny, jax_ref(e / (b * n)).reshape(-1, d), 1e-5)
    assert len(set(eid.tolist())) == e
    seen = set()
    for i in range(b * n):
        if eid[i] not in seen:
            seen.add(eid[i])
            _close(tiny[i], dense[i], 1e-5)
        else:
            np.testing.assert_array_equal(tiny[i], np.zeros(d, np.float32))


# -------------------------------------------------------------- int8 linears


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_bias_f32_matches_quant_linear_xla(dtype):
    """GEMM s8 bias_f32's plain version on quant_rows' codes, and
    quant_experts (one quantization shared by the experts), against JAX's
    _quant_linear_xla per expert, bit for bit; fp32 out; on the CPU the
    wrappers take the plain versions and count no launch."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(8)
    e, k, n = 3, 144, 40
    x = rng.normal(size=(2, 17, k)).astype(np.float32)
    w = rng.normal(0, k ** -0.5, size=(e, k, n)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(e, n)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    stack = [tq.quantize_linear(torch.from_numpy(w[i])) for i in range(e)]
    wq, sw = torch.stack([s[0] for s in stack]), torch.stack([s[1] for s in stack])
    bt = torch.from_numpy(b).to(tdt)
    tfa.reset_launch_counts()
    outs = tq.quant_experts(xt, wq, sw, bt)
    ref = tq.quant_experts_ref(xt, wq, sw, bt)
    codes, scale = tq.quant_rows(xt.reshape(-1, k))
    for i in range(e):
        want = np.asarray(_quant_linear_xla(xj, jnp.asarray(wq[i].numpy()),
                                            jnp.asarray(sw[i].numpy()),
                                            jnp.asarray(bt[i].float().numpy()).astype(jdt)))
        assert outs[i].dtype == torch.float32 and outs[i].shape == (2, 17, n)
        np.testing.assert_array_equal(outs[i].numpy(), want)
        np.testing.assert_array_equal(ref[i].numpy(), want)
        one = tq.gemm_s8_epilogue_ref(codes, scale, wq[i], sw[i], bt[i], "bias_f32")
        np.testing.assert_array_equal(one.numpy(), want.reshape(-1, n))
        kern = tq.gemm_s8_epilogue(codes, scale, tq.kernel_layout(wq[i]), sw[i], bt[i],
                                   "bias_f32")
        assert torch.equal(kern, one)
    assert sum(tfa.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="takes no residual"):
        tq.gemm_s8_epilogue_ref(codes, scale, wq[0], sw[0], bt[0], "bias_f32",
                                residual=torch.zeros(34, n))


# -------------------------------------------------------------------- guards


def test_guards(monkeypatch):
    """The JAX engine's refusals for MoE and routed=, the modes MoE has no
    counterpart of, and the device guards."""
    _, tm, _ = _pair("mixed")
    vit = build_model("vit", BASE, device="cpu")
    with pytest.raises(NotImplementedError, match="VisionTransformerMoE engines only"):
        InferenceEngine(vit, device="cpu", routed=True)
    with pytest.raises(NotImplementedError, match="bf16-only"):
        InferenceEngine(tm, device="cpu", routed=True, quantized=True)
    for bad in (-1.0, 0.0):
        with pytest.raises(ValueError, match="capacity factor"):
            InferenceEngine(tm, device="cpu", routed=bad)
    assert InferenceEngine(tm, device="cpu", routed=True)._forward["routed_capacity"] == 2.0
    for kwargs, match in ((dict(max_budget=0.5), "does not apply to MoE"),
                          (dict(mesh=types.SimpleNamespace(shape={"model": 2}), routed=True),
                           "tensor-parallel"),
                          (dict(mesh=types.SimpleNamespace(shape={"model": 2})),
                           "tensor-parallel"),
                          (dict(quantized=True, calib_images=_images(0, b=1)),
                           "takes no calibration"),
                          (dict(recon_outputs=True), "reconstruction decoder"),
                          (dict(compact=0.5), "ResidualViT family"),
                          (dict(ee_outputs=True), "EEResidualVisionTransformer")):
        with pytest.raises(NotImplementedError, match=match):
            InferenceEngine(tm, device="cpu", **kwargs)
    noisy = build_model("moevit", dict(CONFIGS["mixed"], noise_layer=1), device="cpu")
    assert (noisy.noise_layer, noisy.noise_type) == (1, "gaussian")  # the NoiseBlock, ported
    # dropout is ported (tests/test_torch_dropout.py), and so is the
    # data-parallel engine (tests/test_torch_data_parallel.py): on a
    # one-rank data axis it is the single-device engine
    logits, _ = build_model("moevit", dict(CONFIGS["mixed"], dropout=0.1), device="cpu")(
        torch.from_numpy(_images(1, b=1)), train=True)
    assert torch.isfinite(logits).all()
    one = Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, None, None, 0, 0, torch.device("cpu"))
    x = _images(2, b=2)
    assert torch.equal(InferenceEngine(tm, device="cpu", compute_dtype=torch.float32,
                                       mesh=one)(x),
                       InferenceEngine(tm, device="cpu", compute_dtype=torch.float32)(x))
    # MoE training, ported: the module path (JAX's linen step), never fused
    trainer = Trainer(tm, AdamW(lr=1e-4), device="cpu")
    assert trainer._fused_kind() is None
    metrics = trainer.train_step(_images(2, b=2), np.array([0, 1]))
    assert trainer._train_kind == "module" and np.isfinite(float(metrics["total_loss"]))
    with pytest.raises(ValueError, match="indivisible"):
        build_model("moevit", dict(CONFIGS["mixed"], image_size=30), device="cpu")
    for alias in ("visiontransformermoe", "VisionTransformerMoE", "vitmoe", "MoEVisionTransformer"):
        assert type(build_model(alias, CONFIGS["mixed"], device="cpu")).__name__ == \
            "VisionTransformerMoE"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="item 15"):
        InferenceEngine(tm, compute_dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("moevit", CONFIGS["mixed"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tm)
