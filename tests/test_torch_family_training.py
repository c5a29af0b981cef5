"""The port's Trainer on the families that train on the module path alone
(A-ViT with its losses, the MAE ViT, the EncDec ResidualViT with and
without its reconstruction loss, the MoE ViT) against the JAX Trainer's
linen step, on the CPU, and the EncDec's train forward against linen's.

Each family's weights are the port's seeded ones (head and class tokens
re-drawn at 0.05, else every logit is 0), carried to JAX through
``params_to_jax``; both Trainers take three SGD steps with momentum (and
global-norm clipping) on the same numpy batch, fp32: an update in
proportion to its gradient, where Adam's normalised update would blow up
the two frameworks' last-bit noise in a gradient that is 0 in exact
arithmetic (the key bias's) to a whole step. JAX's PRNG streams cannot be
reproduced in torch, so the draws are fed: the MAE's shuffle permutation, the MoE's Gumbel noise and
the EncDec's batch budget are numpy draws that replace ``jax.random``'s
while JAX traces its step (once, so every step sees them) and the port's
draw helpers on every step. The losses agree at rtol 1e-4 and every
parameter leaf, scaled by its max, at 2e-3 (tests/test_torch_training.py).
One jitted JAX step per family, cached at module scope."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils import losses as jax_losses
from peekvit_torch import Trainer, build_model
from peekvit_torch.models import eeresidualvit as tee
from peekvit_torch.models import maevit as tmae
from peekvit_torch.models.adapters import live_params, params_to_jax, tree_leaves
from peekvit_torch.ops import gates as tgates
from peekvit_torch.ops import noise as tnoise
from peekvit_torch.training import optim
from peekvit_torch.utils import losses

BASE = dict(image_size=32, patch_size=8, num_layers=3, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5)
# configs/loss/avit_losses.yaml at three layers
AVIT_LOSSES = {
    "distr_prior_loss": {"_target_": "peekvit.utils.losses.AViTDPriorLoss", "target_depth": 2,
                         "weight": 0.2},
    "ponder_loss": {"_target_": "peekvit.utils.losses.AViTPonderLoss", "weight": 0.0005}}
# (registry name, model args, Trainer keywords); the EncDec at equal encoder
# and decoder widths, where the JAX module builds (ROADMAP.md queue C)
ENCDEC = dict(BASE, residual_layers=["attention+mlp"] * 3, gate_type="sigmoid", gate_bias=0.0,
              add_budget_token="learnable", decoder_num_layers=1, decoder_num_heads=2,
              decoder_mlp_dim=64)
CASES = {
    # tests/test_inference.py:392-399's gates: tokens halt at mixed depths
    "avit": ("adavit", dict(BASE, gate_scale=5.0, gate_center=0.0), dict(losses=AVIT_LOSSES)),
    "mae": ("maevit", dict(BASE, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
                           num_decoder_layers=1, num_decoder_heads=2),
            dict(reconstruction_weight=1.0)),
    "encdec_w0": ("encdecresidualvit", ENCDEC, {}),
    "encdec_w1": ("encdecresidualvit", ENCDEC, dict(reconstruction_weight=1.0)),
    "moe": ("moevit", dict(BASE, mlp_moes=[1, 1, 3], attn_moes=[1, 2, 1]), {}),
}
STEPS = 3
BATCH_BUDGET = 0.625  # the EncDec's fed batch budget (a sum of powers of two)
N_TOKENS = 17  # 16 patches + the class token


def _batch(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            (np.arange(n) % BASE["num_classes"]).astype(np.int64))


def _port_model(name, args):
    model = build_model(name, args, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key in ("head.kernel", "class_tokens", "class_token"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def _draws(case, batch):
    """The fed draws of ``case``: (JAX replacements {name: fn}, port
    replacements [(module, name, fn)])."""
    rng = np.random.default_rng(11)
    if case == "mae":
        perm = rng.permutation(16)
        return ({"permutation": lambda key, n: jnp.asarray(perm)},
                [(tmae, "_shuffle_permutation",
                  lambda n, gen, device: torch.from_numpy(perm).to(device))])
    if case == "moe":
        # layer 1's attention gate (2 experts), then layer 2's MLP gate (3)
        noise = [rng.gumbel(size=(batch, N_TOKENS, e)).astype(np.float32) for e in (2, 3)]
        jax_it = iter(noise)
        port_it = iter(noise * STEPS)
        return ({"gumbel": lambda key, shape, dtype=jnp.float32: jnp.asarray(next(jax_it))},
                [(tgates, "_gumbel_noise",
                  lambda shape, gen, device: torch.from_numpy(next(port_it)))])
    if case.startswith("encdec"):
        return ({"uniform": lambda key, shape=(), dtype=jnp.float32, **kw:
                 jnp.full(shape, BATCH_BUDGET, dtype)},
                [(tee, "sample_batch_budget",
                  lambda model, gen, device: torch.tensor(BATCH_BUDGET, device=device))])
    return {}, []


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _run(case):
    """Three steps of both Trainers on ``case``: (JAX metrics, port metrics,
    JAX params, port params, the port Trainer)."""
    name, args, kw = CASES[case]
    x, y = _batch()
    tm = _port_model(name, args)
    tree = jax.tree.map(jnp.asarray, params_to_jax(tm))
    jm = JaxModel(module=resolve_model_class(name)(**args), params=tree, model_class=name,
                  model_args=args)
    jax_patch, port_patch = _draws(case, x.shape[0])
    common = dict(reconstruction_weight=kw.get("reconstruction_weight", 0.0))
    jt = JaxTrainer(model=jm, optimizer=jax_optim.SGD(lr=0.05, momentum=0.9), clip_grad_norm=1.0,
                    loss_compose=jax_losses.LossCompose(kw["losses"]) if "losses" in kw else None,
                    **common)
    tt = Trainer(model=tm, optimizer=optim.SGD(lr=0.05, momentum=0.9), clip_grad_norm=1.0,
                 loss_compose=losses.LossCompose(kw["losses"]) if "losses" in kw else None,
                 device="cpu", **common)
    with pytest.MonkeyPatch.context() as mp:
        for fn_name, fn in jax_patch.items():
            mp.setattr(jax.random, fn_name, fn)
        want = [jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=i) for i in range(STEPS)]
    with pytest.MonkeyPatch.context() as mp:
        for module, attr, fn in port_patch:
            mp.setattr(module, attr, fn)
        got = [tt.train_step(x, y, step_idx=i) for i in range(STEPS)]
    want = [{k: float(v) for k, v in m.items()} for m in want]
    got = [{k: float(v) for k, v in m.items()} for m in got]
    port_params = {path: p.detach().numpy() for path, p in tree_leaves(live_params(tm))}
    return want, got, _leaves(jt.model.params), port_params, tt


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_matches_jax_trainer(case):
    """Three steps against the JAX linen step: every metric at rtol 1e-4,
    every parameter leaf, scaled by its max, at 2e-3."""
    want, got, jparams, tparams, tt = _run(case)
    assert tt._train_kind == "module" and tt._fused_kind() is None
    assert [set(m) for m in got] == [set(m) for m in want]
    for w, g in zip(want, got):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{case}: {key}")
    assert all(np.isfinite(m["total_loss"]) for m in got)
    assert set(tparams) == set(jparams)
    for path, leaf in jparams.items():
        scale = max(float(np.abs(leaf).max()), 1e-3)
        np.testing.assert_allclose(tparams[path] / scale, leaf / scale, rtol=2e-3, atol=2e-3,
                                   err_msg=f"{case}: param {path}")


def test_metric_keys_follow_the_jax_loss_fn():
    """The EncDec reports reconstruction_loss at a non-zero weight and not at
    0; the MAE trains on its cross-entropy alone with a weight set; A-ViT
    reports its two regularizers (JAX trainer.py:362-378)."""
    keys = {case: set(_run(case)[1][0]) for case in CASES}
    assert keys["encdec_w1"] == {"classification_loss", "reconstruction_loss", "total_loss"}
    assert keys["encdec_w0"] == keys["mae"] == keys["moe"] == {"classification_loss",
                                                                 "total_loss"}
    assert keys["avit"] == {"classification_loss", "distr_prior_loss", "ponder_loss",
                            "total_loss"}
    m = _run("encdec_w1")[1][0]
    assert m["total_loss"] == pytest.approx(m["classification_loss"]
                                            + m["reconstruction_loss"], rel=1e-6)
    m = _run("mae")[1][0]
    assert m["total_loss"] == m["classification_loss"]


@pytest.mark.parametrize("case", ["avit", "mae", "encdec_w1", "moe"])
def test_eval_step_and_validate_read_the_main_logits(case):
    """eval_step and validate on each new family: the main logits of its
    output format against the module's own eval forward."""
    name, _, _ = CASES[case]
    tt = _run(case)[4]
    x, y = _batch(5, n=4)
    kw = {"budget": 0.5} if name == "encdecresidualvit" else {}
    correct, loss, _ = tt.eval_step(x, y, **kw)
    with torch.no_grad():
        out, _ = tt.model(torch.from_numpy(x), **kw)
    logits = out[0] if isinstance(out, tuple) else out
    assert int(correct) == int((logits.argmax(-1) == torch.from_numpy(y)).sum())
    want = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    acc, mean_loss = tt.validate([(x, y), (x, y)], **kw)
    assert acc == pytest.approx(int(correct) / 4) and mean_loss == pytest.approx(float(loss))


def test_train_steps_draw_from_the_step_generator():
    """Without fed draws, the MoE's gates, the MAE's shuffle and the EncDec's
    budget come from the step's generator: one step_idx repeats its
    metrics, another changes them; train_epoch runs the family."""
    x, y = _batch(7, n=4)
    for name, args, kw in (CASES["moe"], CASES["mae"], CASES["encdec_w1"]):
        runs = []
        for step_idx in (0, 0, 1):
            trainer = Trainer(model=_port_model(name, args), optimizer=optim.SGD(lr=0.0),
                              reconstruction_weight=kw.get("reconstruction_weight", 0.0),
                              device="cpu")
            runs.append(float(trainer.train_step(x, y, step_idx=step_idx)["total_loss"]))
        assert runs[0] == runs[1] and runs[0] != runs[2], (name, runs)
        summary = trainer.train_epoch([(x[:2], y[:2]), (x[2:], y[2:])], epoch=0)
        assert summary["num_batches"] == 2 and np.isfinite(summary["total_loss"])


def test_encdec_train_forward_matches_linen(monkeypatch):
    """Queue C: the EncDec's train forward (the batch budget drawn, the
    sigmoid gates, the decoder on the last gate mask) against linen's under
    the same fed budget, and its gradients through the reconstruction
    loss: logits, reconstruction and mask at 2e-4, every gradient leaf,
    scaled by its max, at 2e-3."""
    name, args, _ = CASES["encdec_w1"]
    tm = _port_model(name, args)
    tree = jax.tree.map(jnp.asarray, params_to_jax(tm))
    module = resolve_model_class(name)(**args)
    x, _ = _batch(3, n=3)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape=(), dtype=jnp.float32, **kw:
                        jnp.full(shape, BATCH_BUDGET, dtype))
    monkeypatch.setattr(tee, "sample_batch_budget",
                        lambda model, gen, device: torch.tensor(BATCH_BUDGET))

    def jax_loss(params):
        (logits, recon, mask), aux = module.apply(
            {"params": params}, jnp.asarray(x), train=True, budget=None, noise_value=None,
            rngs={"budget": jax.random.key(0), "dropout": jax.random.key(1)})
        return jnp.sum(logits ** 2) + jnp.mean((jnp.asarray(x) - recon) ** 2 * mask), (
            logits, recon, mask, aux["current_budget"])

    (_, (jl, jr, jmask, jb)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(tree)
    (tl, tr, tmask), aux = tm(torch.from_numpy(x), train=True)
    assert float(aux["current_budget"]) == float(jb) == BATCH_BUDGET
    for g, w in ((tl, jl), (tr, jr), (tmask, jmask)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
    xt = torch.from_numpy(x)
    ((tl ** 2).sum() + ((xt - tr) ** 2 * tmask).mean()).backward()
    grads = {path: p.grad for path, p in tree_leaves(live_params(tm))}
    for path, leaf in _leaves(jgrads).items():
        got = grads[path]
        got = np.zeros_like(leaf) if got is None else got.numpy()
        scale = max(float(np.abs(leaf).max()), 1e-3)
        np.testing.assert_allclose(got / scale, leaf / scale, rtol=2e-3, atol=2e-3,
                                   err_msg=f"grad {path}")


def test_trainer_guards():
    """A PCT stays refused (the JAX Trainer cannot train it); a
    reconstruction_weight on a model without a decoder is ignored, as
    JAX's loss_fn ignores it; a budget to a family that takes none raises
    (a stricter guard, ROADMAP.md); SP refuses the new families."""
    pct = build_model("pct", dict(num_points=32, num_layers=1, num_heads=2, hidden_dim=32,
                                  mlp_dim=64, num_classes=5), device="cpu")
    with pytest.raises(NotImplementedError, match="cannot train a PointCloudTransformer"):
        Trainer(pct, optim.AdamW(), device="cpu")
    x, y = _batch(2, n=2)
    plain = [Trainer(model=_port_model("vit", BASE), optimizer=optim.SGD(lr=0.1),
                     reconstruction_weight=w, device="cpu") for w in (0.0, 1.0)]
    a, b = (t.train_step(x, y) for t in plain)
    assert set(a) == set(b) == {"classification_loss", "total_loss"}
    assert float(a["total_loss"]) == float(b["total_loss"])
    name, args, _ = CASES["avit"]
    trainer = Trainer(model=_port_model(name, args), optimizer=optim.SGD(), device="cpu")
    with pytest.raises(NotImplementedError, match="takes no token budget"):
        trainer.train_step(x, y, budget=0.5)
    with pytest.raises(NotImplementedError, match="plain-ViT family"):
        Trainer(model=_port_model(name, args), optimizer=optim.SGD(), device="cpu",
                sequence_parallel_devices=2).train_step(x, y)


# ------------------------------------------------------------------ noise

NOISE_CASES = {  # noise type -> (registry name, model args, noise value, train budget)
    "gaussian": ("vit", BASE, 6.0, None),
    "token_drop": ("rankvit", dict(BASE, rankvit_layers=[1, 2]), 0.3, 0.5),
}


@pytest.mark.parametrize("noise_type", list(NOISE_CASES))
def test_noisy_trainer_matches_jax_trainer(noise_type, monkeypatch):
    """Trainer.train_step(noise_value=) with a NoiseBlock before layer 1 (a
    ViT with gaussian noise; a RankViT ranking at 0.5 with token drop at
    its first ranked layer) against the JAX Trainer's three linen steps,
    the port fed JAX's own draws from each step's ``noise`` key
    (split(fold_in(key(seed), step), 5)[3], JAX trainer.py:382-388); then
    eval_step, JAX's drawn from key(0): metrics at rtol 1e-4, parameters
    at 2e-3 of each leaf's max."""
    name, args, value, budget = NOISE_CASES[noise_type]
    na = {"layer": 1, "noise_type": noise_type}
    tm = build_model(name, args, noise_args=na, seed=3, device="cpu")
    with torch.no_grad():
        tm.head.kernel.copy_(torch.randn(tm.head.kernel.shape,
                                         generator=torch.Generator().manual_seed(4)) * 0.05)
    module = resolve_model_class(name)(**args, noise_layer=1, noise_type=noise_type)
    jm = JaxModel(module=module, params=jax.tree.map(jnp.asarray, params_to_jax(tm)),
                  model_class=name, model_args=args, noise_args=na)
    x, y = _batch(8)
    shape = (x.shape[0], N_TOKENS, BASE["hidden_dim"])

    def draw(key):
        if noise_type == "gaussian":
            return np.array(jax.random.normal(key, shape, dtype=jnp.float32))
        return np.array(jax.random.permutation(key, N_TOKENS))

    step_keys = [jax.random.split(jax.random.fold_in(jax.random.key(0), i), 5)[3]
                 for i in range(STEPS)]
    draws = iter([draw(k) for k in step_keys] + [draw(jax.random.key(0))])
    fed = lambda t, gen=None: torch.from_numpy(next(draws))  # noqa: E731
    monkeypatch.setattr(tnoise, "standard_normal", fed)
    monkeypatch.setattr(tnoise, "token_permutation", fed)
    opt = dict(clip_grad_norm=1.0)
    jt = JaxTrainer(model=jm, optimizer=jax_optim.SGD(lr=0.05, momentum=0.9), **opt)
    tt = Trainer(model=tm, optimizer=optim.SGD(lr=0.05, momentum=0.9), device="cpu", **opt)
    want = [jt.train_step(jnp.asarray(x), jnp.asarray(y), budget=budget, noise_value=value,
                          step_idx=i) for i in range(STEPS)]
    got = [tt.train_step(x, y, budget=budget, noise_value=value, step_idx=i)
           for i in range(STEPS)]
    assert tt._train_kind == "module"
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=1e-4, atol=1e-6)
    tparams = {path: p.detach().numpy() for path, p in tree_leaves(live_params(tm))}
    for path, leaf in _leaves(jt.model.params).items():
        scale = max(float(np.abs(leaf).max()), 1e-3)
        np.testing.assert_allclose(tparams[path] / scale, leaf / scale, rtol=2e-3, atol=2e-3,
                                   err_msg=f"param {path}")
    jc, jl, _ = jt.eval_step(jnp.asarray(x), jnp.asarray(y), budget=budget, noise_value=value)
    tc, tl, _ = tt.eval_step(x, y, budget=budget, noise_value=value)
    assert int(tc) == int(jc) and float(tl) == pytest.approx(float(jl), rel=1e-4)
    clean = tt.eval_step(x, y, budget=budget)[1]
    assert float(clean) != float(tl)  # the noise moved the loss
