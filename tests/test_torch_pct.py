"""The port's PCT and RankPCT against the JAX package's, on the CPU: the
weights and the BatchNorm statistics (params_from_jax / params_to_jax
with batch_stats), the modules against linen (the eval forward, and the
train forward with the updated running statistics), RankPCT's masks
(tests/test_pct.py:46-88), both engines against JAX's ``InferenceEngine``
(interpret mode on the CPU) in fp32 and bf16, and the guards.

The toy model keeps the shipped head dim 32: 64 points, 2 layers,
hidden_dim 128, 4 heads, mlp 256. Weights come from the JAX model (seed
0); the BatchNorm running statistics are seeded away from (0, 1) with
numpy, so that the engines' folds are exercised. Tolerances: the modules
at 1e-4 (fp32 sums in another order through the kNN, two BatchNorms and
the blocks); the fp32 engines at JAX's engine-against-linen pins,
2e-4 (PCT) and 3e-4 (RankPCT) (tests/test_pct.py:107, :130); the bf16
engines at 3e-2 of the logits' scale with the same top-1 (bf16 roundings
of the same values after sums in another order, over two layers; the
repo's bf16 kernel tolerance, tests/test_pallas.py:42)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model, init_rngs
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.inference import rankpct_forward_fused, rankpct_forward_plain
from peekvit_torch.models.adapters import params_from_jax, params_to_jax

ARGS = dict(num_points=64, num_layers=2, num_heads=4, hidden_dim=128, mlp_dim=256,
            num_classes=40)
BATCH = 4
BUDGETS = (0.25, 0.5, 1.0, None)


def _np_tree(tree):
    return jax.tree.map(lambda t: np.asarray(t, np.float32), tree)


def _seeded_stats(stats, seed):
    """The BN running statistics redrawn: mean ~ N(0, 0.3), var in [0.5, 2]."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return (rng.normal(size=leaf.shape) * 0.3).astype(np.float32)
        return rng.uniform(0.5, 2.0, size=leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, _np_tree(stats))


def _pair(name, ranking=True, seed=0):
    """(JAX model, port model) with the same weights and BN statistics."""
    jm = jax_build_model(name, ARGS, seed=seed)
    jm.state = {"batch_stats": _seeded_stats(jm.state["batch_stats"], seed + 7)}
    if name == "rankpct" and ranking:
        jm.enable_ranking(True)
    tm = params_from_jax(build_model(name, ARGS, device="cpu"), _np_tree(jm.params),
                         jm.state["batch_stats"])
    if name == "rankpct" and ranking:
        tm.enable_ranking(True)
    return jm, tm


def _points(seed, batch=BATCH):
    return np.random.default_rng(seed).standard_normal((batch, 64, 3)).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def pct_pair():
    return _pair("pct")


@pytest.fixture(scope="module")
def rankpct_pair():
    return _pair("rankpct")


# ---------------------------------------------------------------- weights


@pytest.mark.parametrize("name", ["pct", "rankpct"])
def test_weights_round_trip(name):
    """params_to_jax gives back both trees, leaf for leaf; a tree without
    its batch_stats does not load."""
    jm, tm = _pair(name)
    params, stats = params_to_jax(tm)
    want_p, want_s = _np_tree(jm.params), jm.state["batch_stats"]
    assert jax.tree.structure(params) == jax.tree.structure(want_p)
    assert jax.tree.structure(stats) == jax.tree.structure(want_s)
    for got, want in zip(jax.tree.leaves(params) + jax.tree.leaves(stats),
                         jax.tree.leaves(want_p) + jax.tree.leaves(want_s)):
        np.testing.assert_array_equal(got, want)
    assert sorted(stats) == ["embedder", "head"]
    assert "num_batches_tracked" not in str(stats)
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(build_model(name, ARGS, device="cpu"), want_p)


# ---------------------------------------------------------------- modules


def test_pct_module_eval_matches_linen(pct_pair):
    jm, tm = pct_pair
    x = _points(0)
    want, aux = jm(jnp.asarray(x))
    with torch.no_grad():
        got, taux = tm(torch.from_numpy(x))
    assert taux == {} and aux == {}
    _close(got, want, 1e-4)


@pytest.mark.parametrize("budget", BUDGETS)
def test_rankpct_module_eval_matches_linen(rankpct_pair, budget):
    jm, tm = rankpct_pair
    x = _points(1)
    want, aux = jm(jnp.asarray(x), budget=budget)
    with torch.no_grad():
        got, taux = tm(torch.from_numpy(x), budget=budget)
    _close(got, want, 1e-4)
    assert set(taux["masks"]) == set(aux["masks"])
    for key, m in aux["masks"].items():
        np.testing.assert_array_equal(taux["masks"][key].numpy(), np.asarray(m))


def _linen_train(jm, x, budget=None):
    """linen's train forward: logits, the updated batch_stats and every
    submodule's output (capture_intermediates)."""
    kw = {} if budget is None else {"budget": jnp.float32(budget)}
    (logits, aux), state = jm.module.apply(
        {"params": jm.params, **jm.state}, jnp.asarray(x), train=True, rngs=init_rngs(0),
        mutable=["batch_stats", "intermediates"], capture_intermediates=True, **kw)
    return logits, aux, _np_tree(state["batch_stats"]), state["intermediates"]


@pytest.mark.parametrize("name", ["pct", "rankpct"])
def test_module_train_forward_matches_linen(name):
    """Train mode: the batch statistics normalize and update the running
    ones (0.9 old + 0.1 batch, biased variance); the embedder, every block
    and the head's BatchNorm match linen's outputs; RankPCT's train masks
    match; and with linen's own dropout mask the head gives linen's
    logits."""
    jm, tm = _pair(name, seed=1)
    x = _points(2)
    budget = 0.5 if name == "rankpct" else None
    want_logits, want_aux, want_stats, inter = _linen_train(jm, x, budget)
    seen = {}
    hooks = [getattr(tm, key).register_forward_hook(
        lambda mod, args, out, key=key: seen.__setitem__(key, out))
        for key in ("embedder", "layers_0", "layers_1")]
    hooks.append(tm.head.bn1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("head.bn1", out)))
    kw = {"budget": budget} if budget is not None else {}
    with torch.no_grad():
        _, taux = tm(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0),
                     **kw)
    for hook in hooks:
        hook.remove()
    _, stats = params_to_jax(tm)
    for got, want in zip(jax.tree.leaves(stats), jax.tree.leaves(want_stats)):
        _close(got, want, 1e-4)
    assert not np.allclose(stats["embedder"]["bn1"]["mean"],
                           jm.state["batch_stats"]["embedder"]["bn1"]["mean"])
    _close(seen["embedder"], inter["embedder"]["__call__"][0], 1e-4)
    for i in range(2):
        out = seen[f"layers_{i}"]
        out = out[0] if isinstance(out, tuple) else out
        _close(out, inter[f"layers_{i}"]["__call__"][0][0] if name == "rankpct"
               else inter[f"layers_{i}"]["__call__"][0], 1e-4)
    _close(seen["head.bn1"], inter["head"]["bn1"]["__call__"][0], 1e-4)
    if name == "rankpct":
        assert set(taux["masks"]) == set(want_aux["masks"])
        for key, m in want_aux["masks"].items():
            np.testing.assert_array_equal(taux["masks"][key].numpy(), np.asarray(m))
    dropped = np.asarray(inter["head"]["Dropout_0"]["__call__"][0])
    keep = torch.from_numpy(dropped != 0)
    h = torch.nn.functional.gelu(seen["head.bn1"], approximate="none")
    with torch.no_grad():
        logits = tm.head.lin2(torch.where(keep, h / 0.5, torch.zeros(())))
    _close(logits, want_logits, 1e-4)


def test_rankpct_masks():
    """tests/test_pct.py:46-88 on the port's module: eval keeps
    ceil(64 * 0.5) = 32, then 16 (compounding); train keeps 1 + ceil(63 *
    0.5) = 33 at every layer (relative to the full count); no mask without
    ranking, one per ranking layer with enable_ranking([True, False])."""
    _, tm = _pair("rankpct")
    x = torch.from_numpy(_points(0, batch=2))
    with torch.no_grad():
        _, aux = tm(x, budget=0.5)
        assert aux["masks"]["layer_0"].sum((1, 2)).tolist() == [32, 32]
        assert aux["masks"]["layer_1"].sum((1, 2)).tolist() == [16, 16]
        _, aux = tm(x, budget=0.5, train=True, generator=torch.Generator().manual_seed(0))
        for key, m in aux["masks"].items():
            assert m.sum((1, 2)).tolist() == [33.0, 33.0], key
    _, plain = _pair("rankpct", ranking=False)
    with torch.no_grad():
        assert plain(x, budget=0.5)[1]["masks"] == {}
        plain.enable_ranking([True, False])
        assert set(plain(x, budget=0.5)[1]["masks"]) == {"layer_0"}


# ---------------------------------------------------------------- engines


def test_pct_engine_matches_jax_engine(pct_pair):
    jm, tm = pct_pair
    x = _points(3)
    want = np.asarray(JaxEngine(jm, compute_dtype=jnp.float32)(jnp.asarray(x)))
    got = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 40)
    _close(got, want, 2e-4)
    want16 = np.asarray(JaxEngine(jm)(jnp.asarray(x)), np.float32)
    got16 = InferenceEngine(tm, compute_dtype=torch.bfloat16, device="cpu")(x).numpy()
    scale = np.abs(want16).max()
    np.testing.assert_allclose(got16, want16, rtol=3e-2, atol=3e-2 * scale)
    assert np.array_equal(got16.argmax(-1), want16.argmax(-1))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rankpct_engine_matches_jax_engine(rankpct_pair, dtype):
    """Every budget, and no budget (1.0 with ranking on: no layer drops)."""
    jm, tm = rankpct_pair
    x = _points(11)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jeng = JaxEngine(jm, compute_dtype=jdt)
    teng = InferenceEngine(tm, compute_dtype=tdt, device="cpu")
    for budget in BUDGETS:
        want = np.asarray(jeng(jnp.asarray(x), budget=budget), np.float32)
        got = teng(x, budget=budget).numpy()
        if dtype == "fp32":
            _close(got, want, 3e-4)
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2 * scale,
                                       err_msg=f"budget {budget}")
            assert np.array_equal(got.argmax(-1), want.argmax(-1)), budget


def test_rankpct_kept_indices(rankpct_pair):
    """The fused forward's kept indices (position 0 aside: 15 of the rest,
    then 3, at budget 0.25 on 64 points) fed to the plain twin reproduce
    its gather; ranking flags follow the engine's build, not later calls."""
    _, tm = rankpct_pair
    eng = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    x = torch.from_numpy(_points(5))
    kept = {}
    with torch.inference_mode():
        got = rankpct_forward_fused(eng.params, x, budget=0.25, ranking=eng._ranking,
                                    kept_out=kept, **eng._forward)
        again = rankpct_forward_plain(eng.params, x, budget=0.25, ranking=eng._ranking,
                                      kept_idx=kept, **eng._forward)
    assert {i: tuple(v.shape) for i, v in kept.items()} == {0: (BATCH, 15), 1: (BATCH, 3)}
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="kept_idx"):
        rankpct_forward_plain(eng.params, x, budget=0.5, ranking=eng._ranking, kept_idx=kept,
                              **eng._forward)
    tm.enable_ranking(False)
    try:
        assert eng._ranking == (True, True)
        assert InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")._ranking == (
            False, False)
    finally:
        tm.enable_ranking(True)


# ---------------------------------------------------------------- guards


def test_engine_guards(pct_pair, monkeypatch):
    """JAX's refusals (inference.py:2660-2671), compact= as for every
    non-residual model, noise at build_model, and the card by default."""
    _, tm = pct_pair
    for kwargs in (dict(quantized=True), dict(max_budget=0.5)):
        with pytest.raises(NotImplementedError, match="bf16 eval only"):
            InferenceEngine(tm, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="ResidualViT family"):
        InferenceEngine(tm, device="cpu", compact=0.5)
    regs = build_model("pct", dict(ARGS, num_registers=2), device="cpu")
    with pytest.raises(NotImplementedError, match="num_registers"):
        InferenceEngine(regs, device="cpu")
    bare = build_model("rankpct", ARGS, device="cpu")
    del bare.head.bn1.mean, bare.head.bn1.var
    with pytest.raises(NotImplementedError, match="batch_stats"):
        InferenceEngine(bare, device="cpu")
    with pytest.raises(TypeError, match="noise_layer"):  # no NoiseBlock, as in JAX
        build_model("pct", ARGS, noise_args={"layer": 1}, device="cpu")
    # dropout is ported (tests/test_torch_dropout.py): a train forward draws
    # its masks, the token dropout's first, from the generator
    drop = build_model("pct", dict(ARGS, dropout=0.1), device="cpu")
    drawn = [drop(torch.from_numpy(_points(0, batch=2)), train=True,
                  generator=torch.Generator().manual_seed(s))[0] for s in (0, 0, 1)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])
    assert build_model("moevit", dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
                                      hidden_dim=32, mlp_dim=64, num_classes=5, noise_layer=0),
                       device="cpu").noise_layer == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("pct", "rankpct"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(name, ARGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tm)
