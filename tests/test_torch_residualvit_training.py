"""The port's ResidualViT training slice against the JAX package's, on the
CPU: the fused trainable forward and its gradients, the regularizers and
LossCompose, the gumbel-sigmoid gate, budget sampling, the module's train
forward against linen, the Trainer's fused residual and early-exit module
steps against the JAX Trainer's, and the guards. The same numpy inputs go
through both packages; JAX runs as its own tests run it
(``interpret=True``). Random draws cannot match across frameworks, so the
parity tests fix the budget or feed both sides the same noise."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.gates import gumbel_sigmoid as jax_gumbel_sigmoid
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.fused import residualvit_forward_trainable as jax_forward
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils import losses as jax_losses
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import live_params, params_from_jax, tree_leaves
from peekvit_torch.ops.gates import gumbel_sigmoid
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.training import optim
from peekvit_torch.training import trainer as trainer_mod
from peekvit_torch.training.fused import (
    residual_forward_fn,
    residualvit_forward_trainable,
    sample_budgets,
)
from peekvit_torch.training.trainer import step_generator
from peekvit_torch.utils import losses

# tests/test_fused_training.py:177-190
ARGS = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32,
            mlp_dim=64, num_classes=5, residual_layers=["attention+mlp"] * 2,
            gate_type="sigmoid", gate_bias=0.0)
# configs/loss/crossentropy_mse.yaml's additional_losses, at 2 layers
MSE = {"mse": {"_target_": "peekvit.utils.losses.MSELoss", "weight": 0.01, "strict": False,
               "budget": None, "per_layer": False, "skip_layers": [0]}}
# Budgets that are sums of powers of two: a constant budget token is a
# constant row, whose LayerNorm (eps 1e-6) scales the rounding of its mean
# by 1e3; these means are exact in any summation order (as
# tests/test_torch_residualvit.py's DYADIC).
BVEC = np.array([0.25, 0.625, 0.5], np.float32)


def _pair(name="residualvit", seed=9, **kw):
    """A seeded JAX model with a random head and layer-0 gate kernel (as
    tests/test_fused_training.py:177-190), and the port's model holding the
    same weights."""
    args = dict(ARGS, **kw)
    jm = jax_build_model(name, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.05, tree["head"]["kernel"].shape)
    gate = tree["encoder"]["layers_0"]["residual_gate"]["projection"]["kernel"]
    gate[:] = rng.normal(0, 0.5, gate.shape)
    for key, lp in tree["encoder"].items():
        if key.endswith("_head"):
            lp["kernel"][:] = rng.normal(0, 0.05, lp["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return jm, params_from_jax(build_model(name, args, device="cpu"), tree)


def _images(seed, b=3):
    return np.random.default_rng(seed).normal(size=(b, 16, 16, 3)).astype(np.float32)


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


def _grads_close(got: dict, ref_tree, tol=2e-3):
    """Every leaf, scaled by its max, at ``tol`` (tests/test_fused_training.py:226-238)."""
    ref = {_path(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(ref_tree)}
    assert set(got) == set(ref)
    for name, leaf in ref.items():
        scale = max(float(np.abs(np.asarray(leaf)).max()), 1e-3)
        np.testing.assert_allclose(got[name].numpy() / scale, np.asarray(leaf) / scale,
                                   rtol=tol, atol=tol, err_msg=f"grad mismatch at {name}")


def _torch_grads(model):
    return {name: (p.grad if p.grad is not None else torch.zeros_like(p))
            for name, p in tree_leaves(live_params(model))}


# ----------------------------------------------------------- the forward


@pytest.mark.parametrize("mode", ["learnable", 0.5])
def test_forward_trainable_matches_jax(mode):
    """residualvit_forward_trainable's CE + MSELoss and every gradient leaf
    against JAX's, fp32: the loss at rtol 1e-4, each leaf scaled by its max
    at 2e-3 (tests/test_fused_training.py:226-238); the aux masks at 1e-5."""
    jm, tm = _pair(add_budget_token=mode)
    x, y = _images(5), np.array([0, 1, 2])
    compose_j = jax_losses.LossCompose(MSE)
    compose_t = losses.LossCompose(MSE)
    kw = dict(patch_size=8, num_heads=2, gate_temp=1.0, gate_bias=0.0, budget_token=mode)

    def jax_loss(p):
        logits, aux = jax_forward(p, jnp.asarray(x), jnp.asarray(BVEC),
                                  compute_dtype=jnp.float32, interpret=True, **kw)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce + compose_j.compute(aux, budget=jnp.mean(BVEC), return_dict=False), aux

    (l_ref, jaux), g_ref = jax.value_and_grad(jax_loss, has_aux=True)(jm.params)
    logits, aux = residualvit_forward_trainable(live_params(tm), torch.from_numpy(x),
                                                torch.from_numpy(BVEC),
                                                compute_dtype=torch.float32, **kw)
    loss = (torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
            + compose_t.compute(aux, budget=torch.from_numpy(BVEC).mean(), return_dict=False))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    assert set(aux["masks"]) == set(jaux["masks"]) == {"layer_0", "layer_1"}
    for k in aux["masks"]:
        assert aux["masks"][k].dtype == torch.float32
        np.testing.assert_allclose(aux["masks"][k].detach().numpy(),
                                   np.asarray(jaux["masks"][k]), rtol=1e-5, atol=1e-5)
    _grads_close(_torch_grads(tm), g_ref)


def test_forward_trainable_interpolate_gates_as_the_module():
    """'learnable_interpolate': the JAX fused forward reads a
    budget_token_gate the block does not have (ROADMAP.md queue C); the
    port's gates as linen's module does, and its loss and gradients match
    linen's eval forward at a fixed budget as JAX's own fused forward is
    held against linen (tests/test_fused_training.py:193-238: rtol 1e-4,
    2e-3 of each leaf's max; the tanh-gelu against linen's erf)."""
    jm, tm = _pair(add_budget_token="learnable_interpolate")
    x, y = _images(6), np.array([0, 1, 2])
    with pytest.raises(KeyError):
        jax_forward(jm.params, jnp.asarray(x), jnp.full((3,), 0.625), patch_size=8,
                    num_heads=2, budget_token="learnable_interpolate",
                    compute_dtype=jnp.float32, interpret=True)
    fn = jm.apply_fn()

    def linen_loss(p):
        logits, _ = fn(p, jnp.asarray(x), jnp.float32(0.625), None,
                       {"noise": jax.random.key(0)}, train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    l_ref, g_ref = jax.value_and_grad(linen_loss)(jm.params)
    logits, _ = residual_forward_fn(tm, compute_dtype=torch.float32)(
        live_params(tm), torch.from_numpy(x), torch.full((3,), 0.625))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    _grads_close(_torch_grads(tm), g_ref)


# ------------------------------------------------------ the regularizers


def _masks(seed, layers=3, b=4, s=6):
    """Gate-like masks: a third exactly 0, one image all 0 (sparsity 0)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(layers):
        m = np.clip(rng.normal(0.3, 0.5, size=(b, s, 1)), 0.0, 1.0).astype(np.float32)
        m[0] = 0.0
        out[f"layer_{i}"] = m
    return out


REGULARIZERS = {
    "sparsity_l1": ("sparsity_loss_per_block", dict(budget=0.4)),
    "sparsity_mse": ("sparsity_loss_per_block", dict(budget=0.4, sparsity_type="mse")),
    "sparsity_ce": ("sparsity_loss_per_block", dict(budget=0.4, sparsity_type="cross_entropy")),
    "entropy": ("entropy_per_blocks", {}),
    "solo_l1": ("solo_l1", dict(budget=0.3)),
    "solo_mse": ("solo_mse", dict(budget=0.3)),
    "solo_mse_strict_skip": ("solo_mse", dict(budget=0.3, strict=True, skip_layers=[1])),
    "solo_mse_all_layers": ("solo_mse", dict(budget=0.2, per_layer=False, skip_layers=[0])),
    "solo_mse_all_skipped": ("solo_mse", dict(budget=0.2, skip_layers=[0, 1, 2])),
    "l1_and_intraentropy": ("l1_and_intraentropy", dict(budget=0.2)),
}


@pytest.mark.parametrize("case", list(REGULARIZERS))
def test_regularizer_matches_jax(case):
    """Each regularizer's value and its gradient in the masks against JAX's
    on the same masks, fp32 at 1e-6 (the same arithmetic; the batch SUM,
    ``* (2 - budget)`` and skip_layers kept)."""
    fname, kw = REGULARIZERS[case]
    masks = _masks(1)
    want, want_g = jax.value_and_grad(lambda m: getattr(jax_losses, fname)({"masks": m}, **kw))(
        {k: jnp.asarray(v) for k, v in masks.items()})
    tm = {k: torch.tensor(v, requires_grad=True) for k, v in masks.items()}
    got = getattr(losses, fname)({"masks": tm}, **kw)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=1e-7)
    if got.requires_grad:
        got.backward()
    for k, t in tm.items():
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_avit_losses_classes_and_compose_match_jax():
    """A-ViT's two losses, the classes with their budget rules (L1Loss's
    explicit 0.0, MSELoss's ctor budget, ChannelMSELoss's channel_budget)
    and LossCompose over the reference YAML targets against JAX's."""
    rng = np.random.default_rng(2)
    masks = _masks(3)
    aux_np = {"masks": masks, "rho_token": rng.uniform(size=(4, 5)).astype(np.float32),
              "halting_score_layer": rng.uniform(0.1, 1.0, size=6).astype(np.float32)}
    aux_j = jax.tree.map(jnp.asarray, aux_np)
    aux_t = jax.tree.map(torch.from_numpy, aux_np)
    pairs = [
        (jax_losses.avit_ponder_loss(aux_j), losses.avit_ponder_loss(aux_t)),
        (jax_losses.avit_distr_prior_loss(aux_j, target_depth=3),
         losses.avit_distr_prior_loss(aux_t, target_depth=3)),
    ]
    for name, args, call in (("L1Loss", {}, dict(budget=0.0)), ("MSELoss", dict(budget=0.4), {}),
                             ("ChannelMSELoss", dict(strict=True), dict(channel_budget=0.5)),
                             ("SparsityLoss", dict(sparsity_type="mse"), {}),
                             ("EntropyLoss", {}, {}), ("L1AndIntraEntropyLoss", {}, {}),
                             ("AlwaysZeroLoss", {}, {}), ("AViTPonderLoss", {}, {}),
                             ("AViTDPriorLoss", dict(target_depth=4), {})):
        pairs.append((jax_losses.LOSSES_MAP[name](**args)(aux_j, **call),
                      losses.LOSSES_MAP[name](**args)(aux_t, **call)))
    cfg = dict(MSE, l1={"_target_": "peekvit.utils.losses.L1Loss", "weight": 0.5},
               ent={"_target_": "EntropyLoss"})
    d_j, tot_j = jax_losses.LossCompose(cfg).compute(aux_j, budget=0.3)
    d_t, tot_t = losses.LossCompose(cfg).compute(aux_t, budget=torch.tensor(0.3))
    assert list(d_t) == list(d_j) == ["mse", "l1", "ent"]
    pairs += [(d_j[k], d_t[k]) for k in d_j] + [(tot_j, tot_t)]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    assert losses.resolve_loss_target("a.b.MSELoss") is losses.MSELoss
    with pytest.raises(ValueError, match="Unknown loss target"):
        losses.resolve_loss_target("peekvit.utils.losses.Nope")
    with pytest.raises(AssertionError):
        losses.MSELoss()(aux_t)


# ------------------------------------------------------- gates and budgets


def test_gumbel_sigmoid_with_fed_noise_matches_jax():
    """The JAX sampler's own Gumbel draws fed as ``noise=``: the same hard
    gate values and the same straight-through gradient (that of the soft
    sigmoid)."""
    logits = np.random.default_rng(4).normal(size=(3, 7, 1)).astype(np.float32)
    key = jax.random.key(11)
    noise = np.asarray(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    for hard in (True, False):
        want_vals = jax_gumbel_sigmoid(jnp.asarray(logits), key, tau=0.7, bias=0.3, hard=hard)
        want_g = jax.grad(lambda z: jnp.sum(jax_gumbel_sigmoid(z, key, tau=0.7, bias=0.3,
                                                               hard=hard)
                                            * jnp.arange(7.0)[None, :, None]))(
            jnp.asarray(logits))
        t = torch.tensor(logits, requires_grad=True)
        got = gumbel_sigmoid(t, tau=0.7, bias=0.3, hard=hard, noise=torch.tensor(noise))
        (got * torch.arange(7.0)[None, :, None]).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_vals), atol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
        if hard:
            assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
    # from a generator: reproducible, Gumbel-distributed (mean ~ 0.5772)
    a = gumbel_sigmoid(torch.zeros(4000), torch.Generator().manual_seed(1), hard=False)
    b = gumbel_sigmoid(torch.zeros(4000), torch.Generator().manual_seed(1), hard=False)
    assert torch.equal(a, b)
    g = torch.logit(a)  # sigmoid(0 + g) -> g
    assert abs(float(g.mean()) - 0.5772) < 0.06


def test_sample_budgets_semantics():
    """JAX fused.py:273-283 / residualvit.py:408-417: a float is the
    constant, a list a uniform choice, else uniform over budget_interval;
    one generator seed gives one draw; the EE model draws ONE budget per
    batch under train=True even when a budget is given."""
    gen = lambda s=0: torch.Generator().manual_seed(s)  # noqa: E731
    const = build_model("residualvit", dict(ARGS, add_budget_token=0.375), device="cpu")
    assert torch.equal(sample_budgets(const, 5, gen()), torch.full((5,), 0.375))
    choice = build_model("residualvit", dict(ARGS, add_budget_token=[0.25, 0.5, 1.0]),
                         device="cpu")
    drawn = sample_budgets(choice, 400, gen())
    assert set(drawn.tolist()) == {0.25, 0.5, 1.0}
    interval = build_model("residualvit", dict(ARGS, add_budget_token="learnable",
                                               budget_interval=(0.2, 0.6)), device="cpu")
    u = sample_budgets(interval, 400, gen())
    assert u.dtype == torch.float32 and u.min() >= 0.2 and u.max() < 0.6
    assert torch.equal(u, sample_budgets(interval, 400, gen()))
    assert not torch.equal(u, sample_budgets(interval, 400, gen(1)))
    assert not torch.equal(step_generator(0, 1).get_state(), step_generator(0, 2).get_state())
    assert not torch.equal(step_generator(0, 1).get_state(), step_generator(1, 1).get_state())
    x = torch.from_numpy(_images(1))
    with torch.no_grad():
        _, aux = interval(x, train=True, generator=gen())
        assert aux["current_budget"].shape == (3,)
        _, aux = interval(x, budget=0.5, train=True, generator=gen())
        assert torch.equal(aux["current_budget"], torch.full((3,), 0.5))
        ee = build_model("eeresidualvit", dict(ARGS, add_budget_token="learnable"), device="cpu")
        _, aux = ee(x, budget=0.9, train=True, generator=gen())
        b = aux["current_budget"]
        assert b.shape == () and 0.0 <= float(b) < 1.0 and float(b) != 0.9
        _, aux = ee(x, budget=0.9)
        assert float(aux["current_budget"]) == pytest.approx(0.9)


# ------------------------------------------------------ the module path


@pytest.mark.parametrize("name", ["residualvit", "eeresidualvit"])
def test_module_train_forward_matches_linen(name):
    """The module's train forward (fixed budget 0.625; the EE model's
    constant budget 0.5) against linen's ``train=True`` apply: CE (every
    exit for the EE model) + MSELoss and every gradient, fp32, at the JAX
    engine's module tolerance (2e-4, tests/test_torch_residualvit.py)."""
    mode = "learnable" if name == "residualvit" else 0.5
    jm, tm = _pair(name, add_budget_token=mode)
    x, y = _images(8), np.array([1, 2, 3])
    compose_j, compose_t = jax_losses.LossCompose(MSE), losses.LossCompose(MSE)
    fn = jm.apply_fn()
    keys = dict(zip(("dropout", "gumbel", "budget", "noise"), jax.random.split(jax.random.key(0), 4)))

    def jax_loss(p):
        out, aux = fn(p, jnp.asarray(x), jnp.float32(0.625), None, keys, train=True)
        outs = out if isinstance(out, tuple) else (out,)
        ce = jnp.mean(jnp.stack([optax.softmax_cross_entropy_with_integer_labels(
            o, jnp.asarray(y)).mean() for o in outs]))
        return ce + compose_j.compute(aux, budget=jnp.mean(aux["current_budget"]),
                                      return_dict=False)

    l_ref, g_ref = jax.value_and_grad(jax_loss)(jm.params)
    out, aux = tm(torch.from_numpy(x), budget=0.625, train=True)
    outs = out if isinstance(out, tuple) else (out,)
    ce = torch.stack([torch.nn.functional.cross_entropy(o, torch.from_numpy(y))
                      for o in outs]).mean()
    loss = ce + compose_t.compute(aux, budget=aux["current_budget"].mean(), return_dict=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=2e-4)
    _grads_close(_torch_grads(tm), g_ref, tol=2e-4)


# --------------------------------------------------------- the Trainer


def _batch(seed, n=10):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)
    y = np.arange(n) % 5
    return (base[y] + 0.1 * rng.normal(size=(n, 16, 16, 3))).astype(np.float32), y


def test_trainer_fused_residual_matches_jax_trainer():
    """Trainer(fused=True) on the CPU against the JAX Trainer(fused=True)
    (bf16 compute, Pallas in interpret mode) at a fixed budget, with the
    MSE regularizer: the first three losses at 3e-2, the repo's bf16
    tolerance; the metric keys."""
    jm, tm = _pair(add_budget_token="learnable")
    x, y = _batch(12)
    jt = JaxTrainer(model=jm, optimizer=jax_optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True,
                    loss_compose=jax_losses.LossCompose(MSE))
    tt = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True,
                 loss_compose=losses.LossCompose(MSE), device="cpu")
    assert jt._fused_kind() == tt._fused_kind() == "residual"
    want = [jt.train_step(jnp.asarray(x), jnp.asarray(y), budget=0.625, step_idx=i)
            for i in range(3)]
    got = [tt.train_step(x, y, budget=0.625, step_idx=i) for i in range(3)]
    assert tt._train_kind == "fused_residual"
    assert set(got[0]) == set(want[0]) == {"classification_loss", "mse", "total_loss"}
    np.testing.assert_allclose([float(m["total_loss"]) for m in got],
                               [float(m["total_loss"]) for m in want], rtol=3e-2, atol=3e-2)


def test_trainer_ee_module_path_matches_jax_trainer():
    """The early-exit model on the module path (output_format 'early_exits'
    is never fused) with ee_weights and the MSE regularizer against the
    JAX linen step: the first three losses, fp32, at 1e-3 (Adam's
    normalised updates carry the frameworks' last-bit differences)."""
    jm, tm = _pair("eeresidualvit", add_budget_token=0.5)
    x, y = _batch(13)
    weights = [1.0, 2.0, 4.0]
    kw = dict(clip_grad_norm=1.0, fused=True, ee_weights=weights)
    jt = JaxTrainer(model=jm, optimizer=jax_optim.Adam(lr=5e-3),
                    loss_compose=jax_losses.LossCompose(MSE), **kw)
    tt = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), loss_compose=losses.LossCompose(MSE),
                 device="cpu", **kw)
    assert tt._fused_kind() is None and tt.output_format == "early_exits"
    want = [float(jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=i)["total_loss"])
            for i in range(3)]
    got = [float(tt.train_step(x, y, step_idx=i)["total_loss"]) for i in range(3)]
    assert tt._train_kind == "module"
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # the weighted mean of the three exits' CE, as the JAX loss_fn
    with torch.no_grad():
        outs, aux = tm(torch.from_numpy(x), train=True)
        ces = torch.stack([torch.nn.functional.cross_entropy(o, torch.from_numpy(y))
                           for o in outs])
        want_ce = float((ces * torch.tensor(weights) / sum(weights)).sum())
    ce = float(tt._loss(outs, aux, torch.from_numpy(y), None)[1]["classification_loss"])
    assert len(outs) == 3 and ce == pytest.approx(want_ce, rel=1e-6)


def test_trainer_residual_loss_falls_and_budgets_are_drawn():
    """tests/test_fused_training.py:241-271: sampled budgets, "mse" in the
    metrics, the loss falls over 12 steps; eval at a budget."""
    _, tm = _pair(add_budget_token="learnable")
    x, y = _batch(12)
    trainer = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), fused=True, clip_grad_norm=1.0,
                      loss_compose=losses.LossCompose(MSE), device="cpu")
    totals = []
    for i in range(12):
        metrics = trainer.train_step(x, y, step_idx=i)
        assert "mse" in metrics
        totals.append(float(metrics["total_loss"]))
    assert all(np.isfinite(totals)) and totals[-1] < totals[0], totals
    correct, loss, aux = trainer.eval_step(x, y, budget=0.5)
    assert 0 <= int(correct) <= 10 and np.isfinite(float(loss)) and aux["masks"]


def test_train_epoch_passes_step_idx(monkeypatch):
    """train_epoch passes step_idx = epoch * steps_per_epoch + i (JAX
    trainer.py:902, 915-918), so two steps of one epoch draw different
    budgets, and one epoch's draws are reproducible."""
    drawn = []

    def recording(model, n, generator, device):
        out = sample_budgets(model, n, generator, device)
        drawn.append(out.clone())
        return out

    monkeypatch.setattr(trainer_mod, "sample_budgets", recording)
    _, tm = _pair(add_budget_token="learnable")
    x, y = _batch(3, n=4)
    loader = [(x[:2], y[:2]), (x[2:], y[2:])]
    trainer = Trainer(model=tm, optimizer=optim.SGD(lr=0.0), fused=True, device="cpu")
    trainer.train_epoch(loader, epoch=1)
    trainer.train_epoch(loader, epoch=1)
    assert len(drawn) == 4
    assert not torch.equal(drawn[0], drawn[1])
    assert torch.equal(drawn[0], drawn[2]) and torch.equal(drawn[1], drawn[3])
    gen = step_generator(0, 1 * 2 + 1)
    assert torch.equal(drawn[1], sample_budgets(tm, 2, gen))


# ------------------------------------------------------------- the guards


KIND_CASES = {
    "shipped": (dict(add_budget_token="learnable"), {}, "residual"),
    "constant_budget_token": (dict(add_budget_token=0.5), {}, "residual"),
    "gumbel": (dict(gate_type="gumbel", add_budget_token=False), {}, None),
    "add_input": (dict(add_input=True, add_budget_token="learnable"), {}, None),
    "mlp_skip": (dict(residual_layers=["mlp", "attention+mlp"], add_budget_token=0.5), {}, None),
    "no_budget_token": (dict(add_budget_token=False), {}, None),
    "fused_never": (dict(add_budget_token="learnable"), dict(fused="never"), None),
    "auto_on_cpu": (dict(add_budget_token="learnable"), dict(fused="auto"), None),
}


@pytest.mark.parametrize("case", list(KIND_CASES))
def test_fused_kind_rules(case):
    """_fused_kind under the JAX conditions (trainer.py:278-308), against
    the JAX Trainer's on the same configuration."""
    args, kw, want = KIND_CASES[case]
    jm = jax_build_model("residualvit", dict(ARGS, **args), seed=1)
    tm = build_model("residualvit", dict(ARGS, **args), device="cpu")
    kw = dict(dict(fused=True), **kw)
    tt = Trainer(model=tm, optimizer=optim.Adam(), device="cpu", **kw)
    assert tt._fused_kind() == want
    if kw["fused"] != "auto":  # JAX's "auto" asks for its TPU backend
        assert JaxTrainer(model=jm, optimizer=jax_optim.Adam(), **kw)._fused_kind() == want


def test_trainer_guards_that_still_raise():
    _, tm = _pair(add_budget_token="learnable")
    x, y = _batch(1, n=2)
    base = dict(model=tm, optimizer=optim.Adam(), device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(**base, remat=True, fused=True).train_step(x, y)
    # ported: a noise value and a reconstruction weight, which a ResidualViT
    # with neither a NoiseBlock nor a decoder ignores, as JAX's step does
    want = Trainer(model=_pair(add_budget_token="learnable")[1], optimizer=optim.Adam(),
                   device="cpu").train_step(x, y, budget=0.5)
    got = Trainer(model=_pair(add_budget_token="learnable")[1], optimizer=optim.Adam(),
                  device="cpu", reconstruction_weight=0.5).train_step(x, y, budget=0.5,
                                                                      noise_value=0.5)
    assert set(got) == set(want) and float(got["total_loss"]) == float(want["total_loss"])
    tp_mesh = Mesh({DATA_AXIS: 1, MODEL_AXIS: 2}, None, None, 0, 0, torch.device("cpu"))
    # a model axis without SP is ported (tests/test_torch_sharded_training.py):
    # the module step runs replicated over it, the fused path refuses it in
    # JAX's words at the first step
    with pytest.raises(NotImplementedError, match="the fused train path shards over 'data' "
                                                  "only"):
        Trainer(model=_pair(add_budget_token="learnable")[1], optimizer=optim.Adam(),
                device="cpu", mesh=tp_mesh, fused=True).train_step(x, y, budget=0.5)
    with pytest.raises(NotImplementedError, match="refuses remat"):
        Trainer(**base, qat=True, remat=True)
    vit = build_model("vit", dict(image_size=16, patch_size=8, num_layers=1, num_heads=2,
                                  hidden_dim=32, mlp_dim=64, num_classes=5), device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        Trainer(model=vit, optimizer=optim.Adam(), device="cpu").train_step(x, y, budget=0.5)
    # dropout is ported (tests/test_torch_dropout.py): the module path; the
    # fused residual path has none and refuses it under fused=True
    dropout = build_model("residualvit", dict(ARGS, add_budget_token="learnable", dropout=0.1),
                          device="cpu")
    with pytest.raises(ValueError, match="module path"):
        Trainer(model=dropout, optimizer=optim.Adam(), device="cpu", fused=True)
    trainer = Trainer(model=dropout, optimizer=optim.Adam(), device="cpu")
    assert np.isfinite(float(trainer.train_step(x, y, budget=0.5)["total_loss"]))
    assert trainer._train_kind == "module"
    logits, _ = dropout(torch.from_numpy(x), train=True)
    assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="Budget not set"):
        Trainer(**base).eval_step(x, y)
