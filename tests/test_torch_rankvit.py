"""The port's RankViT against the JAX package's, on the CPU: weights (a
seeded JAX tree loaded with params_from_jax), the module's forward against
linen (float and per-layer budgets, the aux masks), the InferenceEngine's
exact drop and single-shape padded drop against the JAX engine run as its
own tests run it (``interpret=True``, fp32), the Trainer against the JAX
Trainer, and the MAC count. Images come from numpy with a seed."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils.flops_count import analytic_macs as jax_analytic_macs
from peekvit_torch import InferenceEngine, Trainer, build_model
from peekvit_torch.inference import (
    rank_schedule,
    rankvit_forward_fused,
    rankvit_forward_padded,
    rankvit_forward_padded_plain,
    rankvit_forward_plain,
)
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.training import optim
from peekvit_torch.utils.flops_count import analytic_macs

SMALL = dict(image_size=32, patch_size=8, num_layers=3, num_heads=4, hidden_dim=64,
             mlp_dim=128, num_classes=7, rankvit_layers=[0, 2])
# 144 image tokens: budget 0.75 keeps 108 at layer 1 (109 tokens with the
# class token), so one forward runs the merged layer (145 tokens) and then
# the split sublayers (below 128)
WIDE = dict(image_size=48, patch_size=4, num_layers=3, num_heads=2, hidden_dim=32,
            mlp_dim=64, num_classes=10, rankvit_layers=[1, 2])
TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX engine's own fp32 tolerance (test_inference.py:34)


def _pair(args, seed):
    """A seeded JAX RankViT with a random head and class token (zero-init,
    every logit would be 0 and the class token would not move), and the
    port's model with its weights."""
    jm = jax_build_model("rankvit", args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    tm = params_from_jax(build_model("rankvit", args, device="cpu"), tree)
    return jm, tm, tree


def _images(seed, b, size):
    return np.random.default_rng(seed).normal(size=(b, size, size, 3)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def wide_pair():
    jm, tm, tree = _pair(WIDE, 3)
    return jm, tm, _images(5, 2, 48), tree


# ------------------------------------------------------------------ weights


def test_params_round_trip(wide_pair):
    """A JAX tree loads strictly (every key, every shape; a ranking layer
    holds the plain block's parameters) and comes back exactly."""
    _, tm, _, tree = wide_pair
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bad = jax.tree.map(lambda a: a, tree)
    del bad["encoder"]["layers_0"]["ln_1"]
    with pytest.raises(KeyError):
        params_from_jax(build_model("rankvit", WIDE, device="cpu"), bad)


# ------------------------------------------------------------------- module


@pytest.mark.parametrize("budget", [None, 0.25, 0.5, (0.2, 1.0, 0.3)],
                         ids=["none", "0.25", "0.5", "per_layer"])
def test_module_matches_linen(wide_pair, budget):
    """Logits at fp32 2e-4 and the aux keep masks equal: no ranking without
    a budget, a float budget, and a per-layer list indexed by layer id
    (layer 0 ranks nowhere, so its 0.2 is never read)."""
    jm, tm, x, _ = wide_pair
    jb = None if budget is None else jnp.asarray(budget, jnp.float32)
    want, jaux = jm(jnp.asarray(x), budget=jb)
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x), budget=None if budget is None else list(
            budget) if isinstance(budget, tuple) else budget)
    _close(got, want)
    assert set(aux["masks"]) == set(jaux["masks"])
    assert set(aux["masks"]) == (set() if budget is None else {"layer_1", "layer_2"})
    for k in aux["masks"]:
        assert aux["masks"][k].shape == (2, 144, 1)
        np.testing.assert_array_equal(aux["masks"][k].numpy(), np.asarray(jaux["masks"][k]))


def test_module_budget_compounds_and_protects_class_tokens():
    """ceil(alive * budget) compounds over the ranked layers
    (tests/test_rankvit.py:49); with two class tokens neither is ranked,
    and the image tokens' masks do not depend on the class tokens."""
    tm = build_model("rankvit", dict(SMALL, num_class_tokens=2), device="cpu")
    with torch.no_grad():
        tm.class_tokens.normal_(0.0, 10.0)  # norms far above every image token
        _, aux = tm(torch.from_numpy(_images(2, 2, 32)), budget=0.5)
    assert aux["masks"]["layer_0"].shape == (2, 16, 1)
    assert (aux["masks"]["layer_0"].sum((1, 2)) == 8).all()  # ceil(16 * 0.5)
    assert (aux["masks"]["layer_2"].sum((1, 2)) == 4).all()  # ceil(8 * 0.5)
    assert (aux["masks"]["layer_2"] <= aux["masks"]["layer_0"]).all()


# ------------------------------------------------------------------- engine


@pytest.mark.parametrize("budget", [0.75, 0.5, 1.0])
def test_exact_engine_matches_jax_engine(wide_pair, budget):
    """fp32 at 2e-4 against the JAX exact-drop engine. Budget 0.75 runs
    the merged layer at 145 tokens, then the split sublayers at 109 and
    82; 0.5 the split sublayers from layer 1 on; 1.0 ranks nowhere."""
    jm, tm, x, _ = wide_pair
    want = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True)(jnp.asarray(x),
                                                                     budget=budget)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    kept = {}
    got = rankvit_forward_fused(engine.params, torch.from_numpy(x), budget=budget,
                                kept_out=kept, **engine._forward)
    _close(got, want)
    assert torch.equal(got, engine(x, budget=budget))
    widths = {i: k.shape[1] for i, k in kept.items()}
    assert widths == {i: keep for i, (keep, _) in rank_schedule(144, (1, 2), budget).items()}
    if budget == 0.75:
        assert widths == {1: 108, 2: 81}


def test_exact_engine_bf16(wide_pair):
    """bf16 at the repo's bf16 tolerance (tests/test_pallas.py:42, 3e-2).
    At budget 1.0 (no ranking) against the JAX bf16 engine. Below it, the
    bf16 norms of two tokens at the keep boundary differ by a few 1e-4
    here, so a bf16 engine may keep other tokens than an fp32 one (the JAX
    bf16 engine as well): the bf16 forward is held against the fp32 engine
    on the fp32 engine's kept tokens, the split sublayers included."""
    jm, tm, x, _ = wide_pair
    want = np.asarray(JaxEngine(jm, interpret=True)(jnp.asarray(x), budget=1.0), np.float32)
    engine = InferenceEngine(tm, device="cpu")
    got = engine(x, budget=1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    engine32 = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    for budget in (0.75, 0.5):
        kept = {}
        want = rankvit_forward_fused(engine32.params, torch.from_numpy(x), budget=budget,
                                     kept_out=kept, **engine32._forward)
        got = rankvit_forward_plain(engine.params, torch.from_numpy(x), budget=budget,
                                    kept_idx=kept, **engine._forward)
        assert got.dtype == torch.float32
        _close(got, want, rtol=3e-2, atol=3e-2)
        assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_padded_engine_matches_jax_engine(wide_pair):
    """max_budget=0.8: fp32 at 2e-4 against the JAX single-compile engine
    at three budgets, every budget on the same shapes (the buffer keeps
    ceil(144 * 0.8) = 116, then ceil(116 * 0.8) = 93 image tokens), a
    budget above the maximum refused."""
    jm, tm, x, _ = wide_pair
    jax_engine = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, max_budget=0.8)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu", max_budget=0.8)
    outs = []
    for budget in (0.3, 0.5, 0.8):
        want = jax_engine(jnp.asarray(x), budget=budget)
        kept = {}
        got = rankvit_forward_padded(engine.params, torch.from_numpy(x), budget,
                                     max_budget=0.8, kept_out=kept, **engine._forward)
        _close(got, want)
        assert torch.equal(got, engine(x, budget=budget))
        assert {i: k.shape[1] for i, k in kept.items()} == {1: 116, 2: 93}
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])
    with pytest.raises(ValueError, match="max_budget"):
        engine(x, budget=0.9)
    # at max_budget the padded drop keeps what the exact drop keeps
    exact = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x, budget=0.8)
    _close(outs[-1], exact)


def test_plain_twins_take_the_engines_kept_tokens(wide_pair):
    """rankvit_forward_plain / rankvit_forward_padded_plain, the references
    the card's engine is held against, are on the CPU exactly the engine's
    forwards, free-running and with the engine's kept indices fed back."""
    _, tm, x, _ = wide_pair
    images = torch.from_numpy(x)
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    kept, kept_plain = {}, {}
    want = rankvit_forward_fused(engine.params, images, budget=0.5, kept_out=kept,
                                 **engine._forward)
    assert torch.equal(rankvit_forward_plain(engine.params, images, budget=0.5,
                                             kept_out=kept_plain, **engine._forward), want)
    assert all(torch.equal(kept[i], kept_plain[i]) for i in kept)
    assert torch.equal(rankvit_forward_plain(engine.params, images, budget=0.5, kept_idx=kept,
                                             **engine._forward), want)
    # another image's indices change the result
    swapped = {i: k.flip(0) for i, k in kept.items()}
    assert not torch.equal(rankvit_forward_plain(engine.params, images, budget=0.5,
                                                 kept_idx=swapped, **engine._forward), want)
    kept = {}
    want = rankvit_forward_padded(engine.params, images, 0.4, max_budget=0.8, kept_out=kept,
                                  **engine._forward)
    assert torch.equal(rankvit_forward_padded_plain(engine.params, images, 0.4, max_budget=0.8,
                                                    kept_idx=kept, **engine._forward), want)
    with pytest.raises(ValueError, match="kept_idx"):
        rankvit_forward_plain(engine.params, images, budget=0.25, kept_idx=kept,
                              **engine._forward)


def test_rank_schedule():
    """The float32 keep counts of JAX (inference.py:1163-1167, :1262-1271)."""
    assert rank_schedule(196, (3, 6, 9), 0.5) == {3: (98, 98), 6: (49, 49), 9: (25, 25)}
    assert rank_schedule(196, (3, 6, 9), 1.0) == {}
    assert rank_schedule(196, (3, 6, 9), 0.25, max_budget=0.75) == {
        3: (147, 49), 6: (111, 13), 9: (84, 4)}
    assert rank_schedule(196, (3, 6, 9), 0.75, max_budget=0.75) == {
        3: (147, 147), 6: (111, 111), 9: (84, 84)}


def test_engine_guards(wide_pair):
    """The JAX engine's refusals, and the modes not ported yet."""
    _, tm, _, _ = wide_pair
    vit = build_model("vit", dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
                                  hidden_dim=32, mlp_dim=64, num_classes=5), device="cpu")
    with pytest.raises(NotImplementedError, match="RankViT models only"):
        InferenceEngine(vit, device="cpu", max_budget=0.5)
    with pytest.raises(NotImplementedError, match="ResidualViT family"):
        InferenceEngine(tm, device="cpu", compact=0.5)
    plain_args = {k: v for k, v in SMALL.items() if k != "rankvit_layers"}
    residual = build_model("residualvit", dict(plain_args, residual_layers=["attention+mlp"] * 3),
                           device="cpu")
    for model, kwargs, item in ((residual, dict(quantized=True, compact=0.5), "single-program"),
                                (tm, dict(mesh=types.SimpleNamespace(shape={"model": 2}),
                                          max_budget=0.5), "tensor-parallel"),
                                (vit, dict(quantized=True, max_budget=0.5), "RankViT")):
        with pytest.raises(NotImplementedError, match=item):
            InferenceEngine(model, device="cpu", **kwargs)
    # the NoiseBlock builds; the engine keeps JAX's guard: noise after the
    # first ranked layer (0 here) is refused, at it served
    for late in (build_model("rankvit", dict(SMALL, noise_layer=1), device="cpu"),
                 build_model("rankvit", SMALL, noise_args={"layer": 1}, device="cpu")):
        with pytest.raises(NotImplementedError, match="first ranked layer"):
            InferenceEngine(late, device="cpu")
    InferenceEngine(build_model("rankvit", SMALL, noise_args={"layer": 0}, device="cpu"),
                    device="cpu")
    with pytest.raises(ValueError, match="Registers"):
        build_model("rankvit", dict(SMALL, num_registers=2), device="cpu")
    # the data-parallel engine is ported (tests/test_torch_data_parallel.py):
    # on a one-rank data axis it is the single-device engine, padded too
    one = Mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, None, None, 0, 0, torch.device("cpu"))
    x = _images(4, 2, 48)
    for kw in (dict(), dict(max_budget=0.5)):
        got = InferenceEngine(tm, device="cpu", compute_dtype=torch.float32, mesh=one, **kw)
        want = InferenceEngine(tm, device="cpu", compute_dtype=torch.float32, **kw)
        assert torch.equal(got(x, budget=0.5), want(x, budget=0.5))
    assert build_model("moevit", dict(plain_args, noise_layer=1), device="cpu").noise_layer == 1


# ------------------------------------------------------------------ trainer


def test_trainer_matches_jax_trainer():
    """A RankViT trains as a plain ViT (JAX trainer.py:293-298): the fused
    step on the CPU against the JAX Trainer(fused=True) (bf16, Pallas in
    interpret mode), the first three losses at 3e-2; a budget on the fused
    path raises, as in JAX."""
    args = dict(SMALL, num_layers=2, rankvit_layers=[1])
    jm, tm, _ = _pair(args, 6)
    x = _images(3, 4, 32)
    y = np.array([1, 3, 0, 6])
    jt = JaxTrainer(model=jm, optimizer=jax_optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True)
    tt = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True,
                 device="cpu")
    assert tt._fused_kind() == jt._fused_kind() == "vit"
    want = [float(jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=i)["total_loss"])
            for i in range(3)]
    got = [float(tt.train_step(x, y, step_idx=i)["total_loss"]) for i in range(3)]
    assert tt._train_kind == "fused_vit"
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    with pytest.raises(NotImplementedError, match="fused='never'"):
        tt.train_step(x, y, budget=0.5)


def test_trainer_module_path_ranks_and_eval_step():
    """fused='never' trains through the module with the ranking budget (the
    linen step): two steps' losses against the JAX Trainer at fp32; then
    eval_step(budget=) against the JAX eval step (correct count, loss and
    masks)."""
    jm, tm, _ = _pair(SMALL, 7)
    x = _images(4, 4, 32)
    y = np.array([2, 5, 1, 0])
    jt = JaxTrainer(model=jm, optimizer=jax_optim.Adam(lr=1e-3), fused="never")
    tt = Trainer(model=tm, optimizer=optim.Adam(lr=1e-3), fused="never", device="cpu")
    for i in range(2):
        want = float(jt.train_step(jnp.asarray(x), jnp.asarray(y), budget=0.5,
                                   step_idx=i)["total_loss"])
        got = float(tt.train_step(x, y, budget=0.5, step_idx=i)["total_loss"])
        assert tt._train_kind == "module"
        np.testing.assert_allclose(got, want, **TOL)
    jc, jl, jaux = jt.eval_step(jnp.asarray(x), jnp.asarray(y), budget=0.25)
    tc, tl, aux = tt.eval_step(x, y, budget=0.25)
    assert int(tc) == int(jc)
    _close(tl, jl)
    for k in jaux["masks"]:
        np.testing.assert_array_equal(aux["masks"][k].numpy(), np.asarray(jaux["masks"][k]))


# --------------------------------------------------------------------- MACs


def test_analytic_macs_matches_jax(wide_pair):
    """Dense and mask-aware (the module's aux at budget 0.5) against the
    JAX count; the mask-aware count is the exact drop's widths."""
    jm, tm, x, _ = wide_pair
    with torch.no_grad():
        _, aux = tm(torch.from_numpy(x), budget=0.5)
    _, jaux = jm(jnp.asarray(x), budget=0.5)
    assert analytic_macs(tm) == pytest.approx(jax_analytic_macs(jm.module))
    assert analytic_macs(tm, aux) == pytest.approx(jax_analytic_macs(jm.module, jaux), rel=1e-6)
    d, m, p = 32, 64, 4
    layer = lambda n: 4 * n * d * d + 2 * n * n * d + 2 * n * d * m  # noqa: E731
    fixed = 144 * d * p * p * 3 + d * 10
    assert analytic_macs(tm, aux) == pytest.approx(fixed + layer(145) + layer(73) + layer(37))
