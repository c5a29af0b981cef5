"""The port's ResidualViT family against the JAX package's, on the CPU:
weights (a seeded JAX tree loaded with params_from_jax), the module's eval
forward against linen, and the InferenceEngine (exact masked path, early
exits, token compaction) against the JAX engine run as its own tests run
it (``interpret=True``, fp32). Images come from numpy with a seed."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.utils.flops_count import analytic_macs as jax_analytic_macs
from peekvit_torch import InferenceEngine, Trainer, build_model
from peekvit_torch.inference import residualvit_forward_fused, residualvit_forward_plain
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.training.optim import AdamW
from peekvit_torch.utils.flops_count import analytic_macs, compact_macs

SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64,
             mlp_dim=128, num_classes=7, residual_layers=["attention+mlp"] * 2,
             gate_type="sigmoid", gate_bias=0.0)
# 144 image tokens: compaction capacities of 88 (split sublayers, < 128
# tokens) and 136 (the merged layer), each with the phantom slot
WIDE = dict(image_size=48, patch_size=4, num_layers=3, num_heads=2, hidden_dim=32,
            mlp_dim=64, num_classes=10, residual_layers=["attention+mlp"] * 3,
            gate_type="sigmoid", gate_bias=0.0, add_budget_token="learnable")
MODES = ["learnable", "learnable_interpolate", 0.5]
TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX engine's own fp32 tolerance (test_inference.py:34)
# Budgets that are sums of powers of two. A constant budget token is a
# constant row, whose LayerNorm (eps 1e-6) multiplies the rounding of its
# mean by 1e3; these budgets' means are exact in any summation order, so
# the two frameworks agree at the fp32 tolerance (0.3 and 0.8 need the
# 1e-3 of tests/test_inference.py:143).
DYADIC = (0.25, 0.625)


def _pair(name, args, seed):
    """A seeded JAX model with a random head and non-trivial gates (as
    tests/test_compact.py:24-34), and the port's model with its weights."""
    jm = jax_build_model(name, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    for key, lp in tree["encoder"].items():
        if "residual_gate" in lp:
            kern = lp["residual_gate"]["projection"]["kernel"]
            kern[:] = rng.normal(0, 0.5, kern.shape)
        elif key.endswith("_head"):
            lp["kernel"][:] = rng.normal(0, 0.3, lp["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_jax(build_model(name, args, device="cpu"), tree)
    return jm, tm, tree


def _images(seed, b, size):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


# ------------------------------------------------------------------ weights


WEIGHT_CASES = {
    "residualvit_learnable": ("residualvit", dict(SMALL, add_budget_token="learnable")),
    "eeresidualvit_interpolate": ("eeresidualvit",
                                  dict(SMALL, add_budget_token="learnable_interpolate")),
    "residualvit_gumbel_learnable_threshold": (
        "residualvit", dict(SMALL, gate_type="gumbel", gate_threshold="learnable")),
    "residualvit_sigmoid_learnable_threshold_regs": (
        "residualvit", dict(SMALL, gate_threshold="learnable", num_registers=2)),
}


@pytest.mark.parametrize("case", WEIGHT_CASES)
def test_params_round_trip(case):
    """A JAX tree loads strictly (every key, every shape) and comes back
    exactly through params_to_jax."""
    name, args = WEIGHT_CASES[case]
    _, tm, tree = _pair(name, args, 1)
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_params_from_jax_is_strict():
    _, tm, tree = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 2)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["learnable_budget_token_1"]
    with pytest.raises(KeyError):
        params_from_jax(tm, bad)


# ------------------------------------------------------------------- module


@pytest.mark.parametrize("mode", MODES)
def test_module_matches_linen(mode):
    """The port's eval forward against linen's: logits and aux masks at two
    budgets, fp32 (both sides are the same erf-gelu, max-subtracted
    softmax module: 2e-4)."""
    jm, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token=mode), 17)
    x = _images(9, 2, 32)
    outs = []
    for budget in DYADIC:
        want, jaux = jm(jnp.asarray(x), budget=budget)
        with torch.no_grad():
            got, aux = tm(torch.from_numpy(x), budget=budget)
        _close(got, want)
        assert set(aux["masks"]) == set(jaux["masks"]) == {"layer_0", "layer_1"}
        for k in aux["masks"]:
            _close(aux["masks"][k], jaux["masks"][k])
        _close(aux["current_budget"], jaux["current_budget"])
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])


@pytest.mark.parametrize("variant", ["gumbel", "mlp_skip", "attention_skip", "plain_layer"])
def test_module_other_gates_and_skips(variant):
    """The gumbel gate's eval forward (round(sigmoid)), the 'mlp' and
    'attention' skip modes and an ungated layer against linen."""
    args = {
        "gumbel": dict(SMALL, gate_type="gumbel", gate_threshold="learnable"),
        "mlp_skip": dict(SMALL, residual_layers=["mlp", "attention+mlp"], add_input=True,
                         add_budget_token="learnable"),
        "attention_skip": dict(SMALL, residual_layers=["attention", "attention"]),
        "plain_layer": dict(SMALL, residual_layers=[None, "attention+mlp"],
                            gate_threshold="learnable"),
    }[variant]
    jm, tm, _ = _pair("residualvit", args, 5)
    x = _images(4, 2, 32)
    want, jaux = jm(jnp.asarray(x), budget=0.6)
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x), budget=0.6)
    _close(got, want)
    assert set(aux["masks"]) == set(jaux["masks"])
    for k in aux["masks"]:
        _close(aux["masks"][k], jaux["masks"][k])


def test_ee_module_matches_linen():
    jm, tm, _ = _pair("eeresidualvit", dict(SMALL, add_budget_token="learnable"), 6)
    x = _images(5, 2, 32)
    want, jaux = jm(jnp.asarray(x), budget=DYADIC[0])
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x), budget=DYADIC[0])
    assert len(got) == len(want) == SMALL["num_layers"] + 1
    for g, w in zip(got, want):
        _close(g, w)
    assert aux["current_budget"].shape == ()


def test_module_refuses_training_and_a_missing_budget():
    """Eval needs a budget; training with dropout is ported since
    (tests/test_torch_dropout.py): a train forward draws its masks from the
    generator, an eval forward is the dropout-free one."""
    _, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 7)
    x = torch.from_numpy(_images(1, 1, 32))
    with pytest.raises(ValueError, match="Budget not set"):
        tm(x)
    dropout = build_model("residualvit", dict(SMALL, add_budget_token="learnable",
                                              attention_dropout=0.1), device="cpu")
    dropout.load_state_dict(tm.state_dict())
    drawn = [dropout(x, budget=0.5, train=True, generator=torch.Generator().manual_seed(s))[0]
             for s in (0, 0, 1)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])
    assert torch.equal(dropout(x, budget=0.5)[0], tm(x, budget=0.5)[0])
    assert Trainer(dropout, AdamW(), device="cpu")._fused_path is None


# ------------------------------------------------------------------- engine


@pytest.fixture(scope="module", params=MODES, ids=str)
def engine_pair(request):
    """Each budget-token mode's models and the JAX fp32 engine's logits at
    budgets 0.3 and 0.8."""
    jm, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token=request.param), 11)
    x = _images(3, 3, 32)
    jax_engine = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True)
    want = {b: np.asarray(jax_engine(jnp.asarray(x), budget=b)) for b in (0.3, 0.8)}
    return jm, tm, x, want


def test_engine_matches_jax_engine(engine_pair):
    """fp32 at 2e-4; the budget changes the logits."""
    _, tm, x, want = engine_pair
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    got = {b: engine(x, budget=b) for b in want}
    for b in want:
        assert got[b].dtype == torch.float32 and got[b].shape == want[b].shape
        _close(got[b], want[b])
    assert not torch.allclose(got[0.3], got[0.8])
    np.testing.assert_array_equal(engine(x).numpy(), engine(x, budget=1.0).numpy())


def test_plain_forward_equals_cpu_engine(engine_pair):
    """residualvit_forward_plain, the reference the card's engine is held
    against, is on the CPU exactly the engine (whose wrappers run the plain
    versions there); the masks it reports are the module's."""
    _, tm, x, _ = engine_pair
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    masks = {}
    got = residualvit_forward_plain(engine.params, torch.from_numpy(x), 0.3, masks=masks,
                                    **engine._forward)
    assert torch.equal(got, engine(x, budget=0.3))
    with torch.no_grad():
        _, aux = tm(torch.from_numpy(x), budget=0.3)
    for k in aux["masks"]:
        _close(masks[k], aux["masks"][k])


def test_engine_bf16_matches_jax_engine():
    """bf16 engines at the repo's bf16 kernel tolerance
    (tests/test_pallas.py:42), same argmax."""
    jm, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 12)
    x = _images(8, 2, 32)
    want = np.asarray(JaxEngine(jm, interpret=True)(jnp.asarray(x), budget=0.5), np.float32)
    got = InferenceEngine(tm, device="cpu")(x, budget=0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_ee_engine_matches_jax_engine():
    """ee_outputs=True: the L + 1 outputs (exits and final) against the JAX
    EE engine; without it, the final logits alone."""
    args = dict(SMALL, num_layers=3, residual_layers=["attention+mlp"] * 3,
                add_budget_token=0.5)
    jm, tm, _ = _pair("eeresidualvit", args, 5)
    x = _images(3, 4, 32)
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True,
                     ee_outputs=True)(jnp.asarray(x), budget=DYADIC[1])
    got = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu",
                          ee_outputs=True)(x, budget=DYADIC[1])
    assert isinstance(got, tuple) and len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w)
    final = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x, budget=DYADIC[1])
    assert torch.equal(final, got[-1])


# --------------------------------------------------------------- compaction


@pytest.fixture(scope="module")
def wide_pair():
    jm, tm, _ = _pair("residualvit", WIDE, 21)
    return jm, tm, _images(13, 2, 48)


@pytest.mark.parametrize("compact", [0.6, (0.9, 0.6, 0.3)], ids=["uniform", "schedule"])
def test_compact_matches_jax_compact_engine(wide_pair, compact):
    """Every layer compacts (caps 88 / 136, 88, 48 of 144 image tokens), so
    every layer carries the phantom with weight > 0 and the two engines
    compute the same thing: fp32 at 2e-4. The schedule runs the merged
    layer (139 tokens) and then the split sublayers."""
    jm, tm, x = wide_pair
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True,
                     compact=compact)(jnp.asarray(x), budget=0.4)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", compact=compact)
    assert all(c < 144 for c in engine.compact_caps(0.4))
    _close(engine(x, budget=0.4), want)


def test_compact_leak_free_schedule_matches_exact_engine(wide_pair):
    """A schedule whose leading layers keep every token and whose last
    capacity covers that layer's survivors is exact: the port gives the
    phantom of the full layers weight 0 (phantom_idx >= 0 gates the key
    weight), so it matches the EXACT JAX engine. The JAX compact engine
    leaks the phantom's bias key into those layers with weight 1 (ROADMAP
    queue C) and differs."""
    jm, tm, x = wide_pair
    schedule, budget = (1.0, 1.0, 0.3), 0.2
    exact = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    masks = {}
    residualvit_forward_fused(exact.params, torch.from_numpy(x), budget, masks=masks,
                              **exact._forward)
    compact = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", compact=schedule)
    caps = compact.compact_caps(budget)
    assert caps == (144, 144, 48)
    assert int((masks["layer_2"] > 0).sum(1).max()) <= caps[-1]  # the survivors fit
    want = np.asarray(JaxEngine(jm, compute_dtype=jnp.float32, interpret=True)(
        jnp.asarray(x), budget=budget))
    got = compact(x, budget=budget)
    _close(got, want)
    leaky = np.asarray(JaxEngine(jm, compute_dtype=jnp.float32, interpret=True,
                                 compact=schedule)(jnp.asarray(x), budget=budget))
    assert np.abs(leaky - want).max() > 100 * TOL["atol"]


def test_compact_full_capacity_is_exact(wide_pair):
    """compact=1.0, a schedule of 1.0s and compact=True at budget 1.0 run
    the exact path, bit for bit."""
    _, tm, x = wide_pair
    want = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x, budget=0.5)
    for compact in (1.0, (1.0, 1.0, 1.0)):
        engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", compact=compact)
        assert engine.compact_caps(0.5) is None
        assert torch.equal(engine(x, budget=0.5), want)
    auto = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", compact=True)
    assert torch.equal(auto(x, budget=1.0),
                       InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x))


def test_compact_auto_caches_one_entry_per_budget(wide_pair):
    _, tm, x = wide_pair
    auto = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", compact=True,
                           compact_slack=0.125)
    a = auto(x, budget=0.25)
    auto(x, budget=0.5)
    b = auto(x, budget=0.25)
    assert set(auto._compact_caps_by_budget) == {0.25, 0.5}
    assert torch.equal(a, b)
    # min(1, budget + slack) * 144 rounded up to a multiple of 8
    assert auto.compact_caps(0.25) == (56,) * 3 and auto.compact_caps(0.5) == (96,) * 3
    assert auto.compact_caps(0.9) is None


def test_compact_macs_and_mask_aware_macs(wide_pair):
    """analytic_macs against the JAX count (dense, and mask-aware from the
    same masks), and compact_macs from the capacities."""
    jm, tm, x = wide_pair
    with torch.no_grad():
        _, aux = tm(torch.from_numpy(x), budget=0.4)
    _, jaux = jm(jnp.asarray(x), budget=0.4)
    assert analytic_macs(tm) == pytest.approx(jax_analytic_macs(jm.module))
    assert analytic_macs(tm, aux) == pytest.approx(jax_analytic_macs(jm.module, jaux), rel=1e-6)
    assert analytic_macs(tm, aux) < analytic_macs(tm)
    d, m, p = 32, 64, 4
    layer = lambda n: 4 * n * d * d + 2 * n * n * d + 2 * n * d * m  # noqa: E731
    fixed = 144 * d * p * p * 3 + d * 10
    # class + budget + phantom + image slots; the buffer never grows back
    assert compact_macs(tm, (136, 88, 96)) == fixed + layer(139) + 2 * layer(91)
    assert compact_macs(tm, (144, 144, 144)) == analytic_macs(tm)


# ------------------------------------------------------------------- guards


def test_engine_guards():
    """The JAX engine's refusals, and the modes not ported yet."""
    _, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 3)
    vit = build_model("vit", dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
                                  hidden_dim=32, mlp_dim=64, num_classes=5), device="cpu")
    with pytest.raises(NotImplementedError, match="ResidualViT family"):
        InferenceEngine(vit, device="cpu", compact=0.5)
    with pytest.raises(NotImplementedError, match="EEResidualVisionTransformer"):
        InferenceEngine(tm, device="cpu", ee_outputs=True)
    with pytest.raises(NotImplementedError, match="bf16 single-program"):
        InferenceEngine(tm, device="cpu", compact=0.5, quantized=True)
    with pytest.raises(ValueError, match="schedule has 3 entries"):
        InferenceEngine(tm, device="cpu", compact=(0.5, 0.5, 0.5))
    for kwargs, item in ((dict(routed=True), "VisionTransformerMoE engines only"),
                         (dict(max_budget=0.5), "item 5"),
                         (dict(recon_outputs=True), "reconstruction decoder"),
                         (dict(quantized=True, mesh=types.SimpleNamespace(
                             shape={"model": 2})), "tensor-parallel serving")):
        with pytest.raises(NotImplementedError, match=item):
            InferenceEngine(tm, device="cpu", **kwargs)
    # the data-parallel engine is ported (tests/test_torch_data_parallel.py):
    # on a one-rank data axis it is the single-device engine, compact= too
    one = Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, None, None, 0, 0, torch.device("cpu"))
    x = _images(3, 2, 32)
    for kwargs in (dict(), dict(compact=0.5)):
        want = InferenceEngine(tm, device="cpu", compute_dtype=torch.float32, **kwargs)
        got = InferenceEngine(tm, device="cpu", compute_dtype=torch.float32, mesh=one, **kwargs)
        assert torch.equal(got(x, budget=0.5), want(x, budget=0.5))
    for args in (dict(SMALL, add_budget_token=False),
                 dict(SMALL, gate_type="gumbel", add_budget_token="learnable"),
                 dict(SMALL, residual_layers=["mlp", "attention+mlp"], add_budget_token=0.5),
                 dict(SMALL, add_input=True, add_budget_token=0.5)):
        model = build_model("residualvit", args, device="cpu")
        with pytest.raises(NotImplementedError, match="shipped-config mode"):
            InferenceEngine(model, device="cpu")
    with pytest.raises(ValueError, match="requires add_budget_token"):
        build_model("encdecresidualvit", dict(SMALL, add_budget_token=False), device="cpu")


def test_engine_defaults_to_the_card(monkeypatch):
    _, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("residualvit", dict(SMALL, add_budget_token="learnable"))


def test_gate_params_stay_fp32():
    """A bf16 engine keeps the gate subtrees in fp32 (JAX
    inference.py:159-172) and casts everything else."""
    _, tm, _ = _pair("residualvit", dict(SMALL, add_budget_token="learnable"), 3)
    params = InferenceEngine(tm, device="cpu").params
    lp = params["encoder"]["layers_0"]
    assert lp["residual_gate"]["projection"]["kernel"].dtype == torch.float32
    assert lp["budget_token_gate"]["kernel"].dtype == torch.float32
    assert lp["ln_1"]["scale"].dtype == torch.bfloat16
    assert params["learnable_budget_token_1"].dtype == torch.bfloat16
