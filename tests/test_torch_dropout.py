"""The port's dropout against the JAX package's, on the CPU.

JAX's masks cannot be drawn in torch, so the test makes both sides drop
the same elements: ``jax.random.bernoulli`` (what flax's ``nn.Dropout``
and ``attention_core`` call) is replaced by draws from a seeded numpy
stream, recorded in call order, and ``peekvit_torch.ops.dropout.keep_mask``
(the seam every mask of the port passes through) replays them. Two JAX
transforms trace their body once: A-ViT's ``nn.scan`` (adavit.py:173), so
its one attention-dropout mask serves every layer, and MoE's vmapped
attention experts (moevit.py:88), which flax runs deterministic (its
``nn.vmap`` does not pass ``deterministic`` on): neither draws per layer
or per expert, and the replay follows.

Every family's train forward runs at a nonzero ``dropout`` with
``attention_dropout`` 0, and the other way round, against linen with
``rngs={"dropout": ...}``: logits (and the reconstruction, MoE's gates)
at 2e-4 (fp32, sums in another order; tests/test_torch_family_training.py).
A ViT ``Trainer`` step at ``dropout = attention_dropout = 0.1`` against the
JAX ``Trainer`` (losses at 1e-4, parameters scaled by their max at 2e-3,
as that file's steps). Port-alone cases: rate 0 and eval are the identity
with no draw; the keep share of 10^5 draws lies within 5 sigma of
``1 - rate``; a seed reproduces its masks; a data slice's mask is its rows
of the global batch's. Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_torch import Trainer, build_model
from peekvit_torch.models import eeresidualvit as tee
from peekvit_torch.models import maevit as tmae
from peekvit_torch.models.adapters import live_params, params_to_jax, tree_leaves
from peekvit_torch.ops import dropout as tdrop
from peekvit_torch.ops import gates as tgates
from peekvit_torch.ops import global_batch
from peekvit_torch.training import optim

RATE = 0.25
TOL = dict(rtol=2e-4, atol=2e-4)
BASE = dict(image_size=32, patch_size=8, num_layers=3, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5)
RESIDUAL = dict(BASE, residual_layers=["attention+mlp"] * 3, gate_type="sigmoid")
DECODER = dict(decoder_num_layers=1, decoder_num_heads=2, decoder_mlp_dim=64)
PCT = dict(num_points=64, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128, num_classes=5)
BATCH_BUDGET = 0.625  # the EncDec's fed batch budget (a sum of powers of two)
N_TOKENS = 17
# name -> (registry name, model args, forward keywords, decoder rates too)
FAMILIES = {
    "vit": ("vit", BASE, {}, False),
    "rankvit": ("rankvit", dict(BASE, rankvit_layers=[1]), dict(budget=0.5), False),
    "residualvit": ("residualvit", dict(RESIDUAL, add_budget_token=0.5), dict(budget=0.5), False),
    "encdec": ("encdecresidualvit", dict(RESIDUAL, add_budget_token="learnable", **DECODER), {},
               True),
    "avit": ("adavit", dict(BASE, gate_scale=5.0, gate_center=0.0), {}, False),
    "moe": ("moevit", dict(BASE, mlp_moes=[1, 1, 3], attn_moes=[1, 2, 1]), {}, False),
    "mae": ("maevit", dict(BASE, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
                           num_decoder_layers=1, num_decoder_heads=2), {}, True),
    "rankpct": ("rankpct", PCT, dict(budget=0.5), False),
}


class _Recorder:
    """``jax.random.bernoulli`` from a seeded numpy stream, each mask
    recorded in call order; a shape in ``shared`` is drawn once and served
    to every call (a scanned body traced more than once)."""

    def __init__(self, seed, shared=()):
        self.rng = np.random.default_rng(seed)
        self.masks, self.shared, self.by_shape = [], set(shared), {}

    def __call__(self, key, p=0.5, shape=None, mode="low"):
        shape = tuple(shape)
        if shape in self.shared and shape in self.by_shape:
            return jnp.asarray(self.by_shape[shape])
        mask = self.rng.random(shape) < float(p)
        self.by_shape[shape] = mask
        self.masks.append(mask)
        return jnp.asarray(mask)


def _replay(masks, order=None):
    """A ``keep_mask`` that serves ``masks[i]`` for i in ``order`` (default:
    each in turn); ``.left`` counts the masks not yet served."""
    it = iter(range(len(masks)) if order is None else order)

    def keep_mask(shape, keep_prob, generator, device):
        mask = masks[next(it)]
        assert tuple(shape) == mask.shape
        return torch.from_numpy(mask).to(device)

    keep_mask.left = lambda: len(list(it))
    return keep_mask


def _images(seed, n=2):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _port_model(name, args):
    """The port's seeded model, head and class tokens redrawn at 0.05 (a
    zero head gives zero logits)."""
    model = build_model(name, args, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key in ("head.kernel", "class_tokens", "class_token"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    if name == "rankpct":
        model.enable_ranking(True)
    return model


def _fed_draws(family, monkeypatch, batch):
    """The other draws, fed to both sides: the MAE's shuffle, the MoE's
    Gumbel noise, the EncDec's batch budget."""
    rng = np.random.default_rng(11)
    if family == "mae":
        perm = rng.permutation(16)
        monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm))
        monkeypatch.setattr(tmae, "_shuffle_permutation",
                            lambda n, gen, device: torch.from_numpy(perm).to(device))
    elif family == "moe":
        noise = [rng.gumbel(size=(batch, N_TOKENS, e)).astype(np.float32) for e in (2, 3)]
        jax_it, port_it = iter(noise), iter(noise)
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(next(jax_it)))
        monkeypatch.setattr(tgates, "_gumbel_noise",
                            lambda shape, gen, device: torch.from_numpy(next(port_it)))
    elif family == "encdec":
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), dtype=jnp.float32, **kw:
                            jnp.full(shape, BATCH_BUDGET, dtype))
        monkeypatch.setattr(tee, "sample_batch_budget",
                            lambda model, gen, device: torch.tensor(BATCH_BUDGET))


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


@pytest.mark.parametrize("kind", ["dropout", "attention_dropout"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_forward_matches_linen(family, kind, monkeypatch):
    """One rate of ``kind`` at RATE, the other 0 (the decoder's pair
    alike): the train forward with JAX's masks replayed against linen's."""
    name, args, kw, decoder = FAMILIES[family]
    rates = {kind: RATE}
    if decoder:
        rates[f"decoder_{kind}"] = RATE
    args = dict(args, **rates)
    tm = _port_model(name, args)
    pct = family == "rankpct"
    module = resolve_model_class(name)(**args, **(
        dict(ranking_enabled=(True,) * args["num_layers"]) if pct else {}))
    # four clouds, tests/test_torch_pct.py's batch: the head's train-mode
    # BatchNorm over two clouds scales fp32 last-bit noise by 1 / their spread
    x = (np.random.default_rng(2).standard_normal((4, 64, 3)).astype(np.float32) if pct
         else _images(2))
    _fed_draws(family, monkeypatch, x.shape[0])
    attn_shape = (2, args["num_heads"], N_TOKENS, N_TOKENS)
    recorder = _Recorder(5, shared=[attn_shape] if family == "avit" else ())
    monkeypatch.setattr(jax.random, "bernoulli", recorder)
    rngs = {k: jax.random.key(i) for i, k in enumerate(("dropout", "budget", "gumbel",
                                                        "shuffle", "noise"))}
    jkw = {k: jnp.float32(v) for k, v in kw.items()}
    if pct:
        params, stats = params_to_jax(tm)
        (want, _), _ = module.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                    train=True, rngs=rngs, mutable=["batch_stats"], **jkw)
    else:
        want, _ = module.apply({"params": params_to_jax(tm)}, jnp.asarray(x), train=True,
                               rngs=rngs, **jkw)
    masks = recorder.masks
    assert masks, "linen drew no mask"
    order = None
    if family == "avit" and kind == "attention_dropout":
        assert len(masks) == 1  # the scanned body's one mask
        order = [0] * args["num_layers"]
    replay = _replay(masks, order)
    monkeypatch.setattr(tdrop, "keep_mask", replay)
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(x), train=True, generator=torch.Generator(), **kw)
    assert replay.left() == 0
    want, got = _flat(want), _flat(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=f"{family} {kind}")


def test_trainer_step_matches_jax_trainer(monkeypatch):
    """A ViT at dropout = attention_dropout = 0.1 takes two SGD steps
    (momentum, clipping) with JAX's masks (the jitted step traces its draws
    once, so both steps take the same masks) against the JAX Trainer."""
    args = dict(BASE, dropout=0.1, attention_dropout=0.1)
    tm = _port_model("vit", args)
    jm = JaxModel(module=resolve_model_class("vit")(**args),
                  params=jax.tree.map(jnp.asarray, params_to_jax(tm)), model_class="vit",
                  model_args=args)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
    y = (np.arange(6) % 5).astype(np.int64)
    common = dict(clip_grad_norm=1.0)
    jt = JaxTrainer(model=jm, optimizer=jax_optim.SGD(lr=0.05, momentum=0.9), **common)
    tt = Trainer(model=tm, optimizer=optim.SGD(lr=0.05, momentum=0.9), device="cpu", **common)
    recorder = _Recorder(8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", recorder)
        want = [float(jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=i)["total_loss"])
                for i in range(2)]
    masks = recorder.masks
    assert len(masks) == 2 * BASE["num_layers"] + 1  # tokens, then per layer weights, output
    replay = _replay(masks, list(range(len(masks))) * 2)
    monkeypatch.setattr(tdrop, "keep_mask", replay)
    got = [float(tt.train_step(x, y, step_idx=i)["total_loss"]) for i in range(2)]
    assert replay.left() == 0 and tt._train_kind == "module"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert got[1] != got[0]
    jparams = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_leaves_with_path(jt.model.params)}
    for path, p in tree_leaves(live_params(tm)):
        scale = max(float(np.abs(jparams[path]).max()), 1e-3)
        np.testing.assert_allclose(p.detach().numpy() / scale, jparams[path] / scale,
                                   rtol=2e-3, atol=2e-3, err_msg=path)


# ------------------------------------------------------------- port alone


def test_identity_without_a_draw(monkeypatch):
    """Rate 0 and an eval forward return the input and draw nothing; rate
    1 gives zeros; a model with rates serves its eval forward unchanged."""

    def no_draw(*args):
        raise AssertionError("drew a mask")

    monkeypatch.setattr(tdrop, "keep_mask", no_draw)
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    assert tdrop.dropout(x, 0.0, torch.Generator(), train=True) is x
    assert tdrop.dropout(x, 0.5, torch.Generator(), train=False) is x
    assert torch.equal(tdrop.dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))
    dropped = _port_model("vit", dict(BASE, dropout=0.5, attention_dropout=0.5))
    plain = _port_model("vit", BASE)
    images = torch.from_numpy(_images(1))
    with torch.no_grad():
        assert torch.equal(dropped(images)[0], plain(images)[0])
        assert torch.equal(dropped(images, train=False)[0], plain(images, train=True)[0])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_and_scale(rate):
    """10^5 draws keep a share within 5 sigma of 1 - rate, and the kept
    elements come back divided by 1 - rate, the others 0."""
    n = 100_000
    x = torch.full((n,), 3.0)
    out = tdrop.dropout(x, rate, torch.Generator().manual_seed(1))
    kept = out != 0
    p = 1.0 - rate
    assert abs(float(kept.float().mean()) - p) < 5 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(out[kept], x[kept] / p)


def test_seed_reproduces_and_slices_the_global_batch():
    """A seed reproduces its masks, another seed changes them; inside a data
    slice a per-sample mask is the slice's rows of the global batch's."""
    x = torch.ones(4, 6, 5)
    masks = [tdrop.dropout(x, 0.5, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])
    for index in range(2):
        with global_batch.data_slice(2, index, lambda t: t):
            rows = tdrop.dropout(x[:2], 0.5, torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(rows.numpy(), masks[0][2 * index:2 * index + 2].numpy())
