"""The port's quantization-aware training against the JAX package's, on the
CPU, at tests/test_qat.py:366-369's sizes (2 layers, d 32, 16 px images):

- ``ops/fake_quant``: ``fq_weight`` and ``fq_act`` (dynamic and capped)
  against JAX's, and against the port's own engine grid
  (``quant_blocks.quantize_linear`` / ``quant_rows_ref`` dequantized), the
  straight-through gradients against ``jax.grad``, ``maybe_fq`` with
  smoothing;
- the QAT forward of a ViT, a RankViT and a ResidualViT under the
  dynamic, the static and the smoothed static grid at rtol = atol = 2e-4
  (tests/test_qat.py:388-389);
- ``collect_qat_caps`` and ``collect_qat_calibration`` on the plain and
  the residual family;
- the ``Trainer``: two ``qat=True`` steps and two ``qat="static"`` steps
  with smoothing against the JAX ``Trainer``'s (metrics at rtol 1e-4,
  every parameter leaf at 2e-3 of its max: SGD with momentum and clipping,
  tests/test_torch_family_training.py) and one ``eval_step``;
- the sites that fire in every family the JAX hooks reach;
- JAX's error cases, with the same exception types;
- ``cli.train training.qat=...`` on a tiny synthetic config.

Weights are the port's seeded ones (the head re-drawn: at zero every logit
is 0), carried to JAX through ``params_to_jax``; inputs from numpy with a
seed. JAX runs in fp32, jitted (its fake-quant switch acts while the
forward is traced), its Trainer once per mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu import inference as jinf
from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.ops import fake_quant as jfq
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_torch import Trainer, build_model
from peekvit_torch import inference as tinf
from peekvit_torch.cli import train as cli_train
from peekvit_torch.models.adapters import live_params, params_to_jax, tree_leaves
from peekvit_torch.ops import attention as tattention
from peekvit_torch.ops import fake_quant as tfq
from peekvit_torch.ops import mlp as tmlp
from peekvit_torch.ops.cuda.quant_blocks import quant_rows_ref, quantize_linear
from peekvit_torch.training import optim
from peekvit_torch.utils.flops_count import eval_forward

BASE = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5)
RESIDUAL = dict(BASE, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
                gate_bias=0.0, add_budget_token="learnable")
# name -> (registry name, args, eval budget)
FAMILIES = {
    "vit": ("vit", BASE, None),
    "rankvit": ("rankvit", dict(BASE, rankvit_layers=[1]), 0.5),
    "residualvit": ("residualvit", RESIDUAL, 0.5),
}
# every other family whose JAX module reaches the hooks: (args, eval budget)
SITE_FAMILIES = {
    "eeresidualvit": (RESIDUAL, 0.5),
    "encdecresidualvit": (dict(RESIDUAL, decoder_num_layers=1, decoder_num_heads=2,
                               decoder_mlp_dim=64), 0.5),
    "maevit": (dict(BASE, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
                    num_decoder_layers=1, num_decoder_heads=2), None),
    "moevit": (dict(BASE, mlp_moes=[1, 3], attn_moes=[2, 1]), None),
    "adavit": (dict(BASE, num_layers=3, gate_scale=5.0, gate_center=0.0), None),
}
MODES = {"dynamic": (False, False), "static": (True, False), "smoothed": (True, True)}
TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed=0, n=8):
    return np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32)


def _port_model(name, args, seed=3):
    model = build_model(name, args, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key == "head.kernel":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return model


def _jax_model(name, args, tm):
    tree = jax.tree.map(jnp.asarray, params_to_jax(tm))
    return JaxModel(module=resolve_model_class(name)(**args), params=tree, model_class=name,
                    model_args=args)


@functools.lru_cache(maxsize=None)
def _pair(family):
    name, args, budget = FAMILIES[family]
    tm = _port_model(name, args)
    return tm, _jax_model(name, args, tm), budget


def _port_smoothing(smoothing):
    return None if smoothing is None else tuple(
        tuple(torch.from_numpy(np.array(s, np.float32)) for s in layer) for layer in smoothing)


@functools.lru_cache(maxsize=None)
def _jax_calibration(family):
    """JAX's (caps, (caps, smoothing)) of ``family`` on the seed-1 images."""
    tm, jm, budget = _pair(family)
    kw = dict(percentile=95.0, budget=budget or 1.0)
    x = jnp.asarray(_images(1))
    return (jinf.collect_qat_caps(jm, x, **kw), jinf.collect_qat_calibration(jm, x, **kw))


def _jax_forward(jm, x, budget=None, caps=None, smoothing=None):
    """The JAX module's (main) eval output under ``fake_quant(True, caps,
    smoothing)``, jitted (the switch acts while the forward is traced). The
    caps and vectors are arguments: as constants, XLA would turn x / s into
    x * (1 / s), another rounding."""
    b = None if budget is None else jnp.float32(budget)

    def fn(params, images, caps, smoothing):
        with jfq.fake_quant(True, caps=caps, smoothing=smoothing):
            out = jm.apply_fn()(params, images, b, None, {}, train=False)[0]
        return out[0] if isinstance(out, tuple) else out

    return np.asarray(jax.jit(fn)(jm.params, jnp.asarray(x), caps, smoothing))


def _mode_args(family, mode):
    with_caps, with_smoothing = MODES[mode]
    caps, (scaps, smoothing) = _jax_calibration(family)
    if with_smoothing:
        return scaps, smoothing
    return (caps if with_caps else None), None


def _assert_grid_close(got, want, step, what):
    """Equal, but where the frameworks' fp32 divisions land on opposite
    sides of a rounding tie: one grid step, on at most 1e-3 of the
    elements."""
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    n = int(differ.sum())
    assert n <= max(1, int(1e-3 * got.size)), f"{what}: {n} of {got.size} elements differ"
    if n:
        np.testing.assert_allclose(np.abs(got - want)[differ],
                                   np.broadcast_to(step, got.shape)[differ], rtol=1e-6)


# ------------------------------------------------------------- the ops


def _operands():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    w[:, 3] *= 40.0  # an outlier column
    w[:, 0] = 0.0
    w[:9, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 3.0, -127.0]  # scale 1: the ties
    x = (rng.normal(size=(40, 64)) * 3.0).astype(np.float32)
    x[5] = 0.0  # a zero row: the 1e-12 floor
    x[6, :4] = [127.0, 0.5, 1.5, -2.5]
    x[6, 4:] = 0.0
    return w, x


@pytest.mark.parametrize("op", ["weight", "act", "act_cap"])
def test_fq_ops_match_jax_and_the_engine_grid(op):
    """fq_weight / fq_act against JAX's, and bit for bit against the
    engine's own codes times their scales."""
    w, x = _operands()
    if op == "weight":
        got = tfq.fq_weight(torch.from_numpy(w))
        want = jfq.fq_weight(jnp.asarray(w))
        codes, scale = quantize_linear(torch.from_numpy(w))
        step = scale.numpy()
    else:
        cap = 2.5 if op == "act_cap" else None
        got = tfq.fq_act(torch.from_numpy(x), cap)
        want = jfq.fq_act(jnp.asarray(x), cap)
        codes, scale = quant_rows_ref(torch.from_numpy(x), cap)
        step = np.float32(scale) if cap is not None else scale.numpy()
        if cap is not None:
            assert float(got.abs().max()) == pytest.approx(float(step) * 127, rel=1e-6)
    engine = (codes.float() * torch.as_tensor(scale)).numpy()
    np.testing.assert_array_equal(got.numpy(), engine)
    _assert_grid_close(got.numpy(), want, step, op)


@pytest.mark.parametrize("op", ["weight", "act", "act_cap"])
def test_ste_gradients_match_jax(op):
    """The identity straight-through gradient, and the clipped one (zero
    where the static grid saturates), against jax.grad."""
    w, x = _operands()
    a = w if op == "weight" else x
    g = np.random.default_rng(8).normal(size=a.shape).astype(np.float32)
    cap = 2.5 if op == "act_cap" else None
    fns = ((tfq.fq_weight, jfq.fq_weight) if op == "weight"
           else (lambda t: tfq.fq_act(t, cap), lambda t: jfq.fq_act(t, cap)))
    t = torch.from_numpy(a).requires_grad_(True)
    (fns[0](t) * torch.from_numpy(g)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(fns[1](v) * jnp.asarray(g)))(jnp.asarray(a))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    if cap is not None:
        assert 0 < int((t.grad == 0).sum()) < a.size


def test_maybe_fq_with_smoothing_matches_jax():
    """The four sites of one calibrated layer in order: caps per site, and
    x / s against w * s at qkv and fc1."""
    rng = np.random.default_rng(9)
    d, m = 32, 64
    caps = ((1.5, 0.7), (1.2, 2.0))
    smoothing = (rng.uniform(0.5, 2.0, d).astype(np.float32),
                 rng.uniform(0.5, 2.0, d).astype(np.float32))
    inputs = {"qkv": (d, 3 * d), "out": (d, d), "fc1": (d, m), "fc2": (m, d)}
    data = {s: (rng.normal(size=(6, k)).astype(np.float32),
                rng.normal(size=(k, n)).astype(np.float32)) for s, (k, n) in inputs.items()}

    def jax_sites(data, caps, smoothing):
        with jfq.fake_quant(True, caps=caps, smoothing=smoothing):
            return {s: jfq.maybe_fq(a, b, site=s) for s, (a, b) in data.items()}

    want = jax.jit(jax_sites)(data, (caps,), (smoothing,))
    with tfq.fake_quant(True, caps=(caps,), smoothing=_port_smoothing((smoothing,))):
        got = {s: tfq.maybe_fq(torch.from_numpy(a), torch.from_numpy(b), site=s)
               for s, (a, b) in data.items()}
    for s in data:
        for g, w_ in zip(got[s], want[s]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6,
                                       err_msg=s)
    x, w = (torch.from_numpy(v) for v in data["qkv"])
    assert tfq.maybe_fq(x, w, site="qkv") == (x, w)  # off outside the block


# ------------------------------------------------------------- the modules


def _counting(counts: dict, key: list, fn):
    """``fn`` (a maybe_fq) that also counts each site under ``counts[key[0]]``."""
    def wrapped(a, w, site=None):
        per = counts.setdefault(key[0], {})
        per[site] = per.get(site, 0) + 1
        return fn(a, w, site=site)
    return wrapped


@functools.lru_cache(maxsize=None)
def _jax_outputs(family):
    """JAX's eval output under each grid of MODES, all from one jitted
    program (the caps and vectors its arguments: as constants, XLA would
    turn x / s into x * (1 / s), another rounding), and the sites each
    forward reached while it was traced."""
    _, jm, budget = _pair(family)
    caps, (scaps, smoothing) = _jax_calibration(family)
    b = None if budget is None else jnp.float32(budget)
    counts, key = {}, [None]

    def fn(params, images, caps, scaps, smoothing):
        outs = {}
        for mode, (c, sm) in (("dynamic", (None, None)), ("static", (caps, None)),
                              ("smoothed", (scaps, smoothing))):
            key[0] = mode
            with jfq.fake_quant(True, caps=c, smoothing=sm):
                outs[mode] = jm.apply_fn()(params, images, b, None, {}, train=False)[0]
        return outs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfq, "maybe_fq", _counting(counts, key, jfq.maybe_fq))
        outs = jax.jit(fn)(jm.params, jnp.asarray(_images(2)), caps, scaps, smoothing)
    return {k: np.asarray(v) for k, v in outs.items()}, counts


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_qat_forward_matches_jax(family, mode):
    """The module's eval forward under fake_quant against linen's."""
    tm, _, budget = _pair(family)
    caps, smoothing = _mode_args(family, mode)
    x = _images(2)
    with tfq.fake_quant(True, caps=caps, smoothing=_port_smoothing(smoothing)):
        got, _ = eval_forward(tm, x, budget)
    plain, _ = eval_forward(tm, x, budget)
    np.testing.assert_allclose(got.numpy(), _jax_outputs(family)[0][mode], rtol=TOL, atol=TOL)
    assert float((got - plain).abs().max()) > 1e-5  # the grid moves the logits


@pytest.mark.parametrize("family", ["vit", "residualvit"])
def test_qat_calibration_matches_jax(family):
    """collect_qat_caps and collect_qat_calibration (smoothing from the raw
    weights, caps on the smoothed copy) against JAX's."""
    tm, _, budget = _pair(family)
    kw = dict(percentile=95.0, budget=budget or 1.0)
    x = _images(1)
    caps = tinf.collect_qat_caps(tm, x, **kw)
    scaps, smoothing = tinf.collect_qat_calibration(tm, x, **kw)
    want_caps, (want_scaps, want_smoothing) = _jax_calibration(family)
    np.testing.assert_allclose(np.asarray(caps), np.asarray(want_caps), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(scaps), np.asarray(want_scaps), rtol=1e-4)
    assert len(smoothing) == len(want_smoothing) == 2
    for got, want in zip(smoothing, want_smoothing):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    assert not np.allclose(np.asarray(caps), np.asarray(scaps))


# ------------------------------------------------------------- the Trainer


@functools.lru_cache(maxsize=None)
def _trainers(mode):
    """Two steps of the port's and the JAX Trainer (ViT, SGD with momentum,
    clip 1.0) under ``mode``: (JAX metrics, port metrics, JAX params, port
    params, JAX trainer, port trainer)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    y = (np.arange(6) % 5).astype(np.int64)
    tm = _port_model("vit", BASE, seed=13)
    jm = _jax_model("vit", BASE, tm)
    kw = dict(qat=True)
    if mode == "smoothed":
        caps, smoothing = jinf.collect_qat_calibration(jm, jnp.asarray(_images(1)),
                                                       percentile=95.0)
        kw = dict(qat="static", qat_caps=caps)
        jkw, tkw = dict(kw, qat_smoothing=smoothing), dict(kw, qat_smoothing=_port_smoothing(
            smoothing))
    else:
        jkw = tkw = kw
    jt = JaxTrainer(model=jm, optimizer=jax_optim.SGD(lr=0.05, momentum=0.9),
                    clip_grad_norm=1.0, **jkw)
    tt = Trainer(model=tm, optimizer=optim.SGD(lr=0.05, momentum=0.9), clip_grad_norm=1.0,
                 device="cpu", **tkw)
    want = [{k: float(v) for k, v in jt.train_step(jnp.asarray(x), jnp.asarray(y),
                                                   step_idx=i).items()} for i in range(2)]
    got = [{k: float(v) for k, v in tt.train_step(x, y, step_idx=i).items()} for i in range(2)]
    jparams = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_leaves_with_path(jt.model.params)}
    tparams = {p: v.detach().numpy() for p, v in tree_leaves(live_params(tm))}
    return want, got, jparams, tparams, jt, tt


@pytest.mark.parametrize("mode", ["dynamic", "smoothed"])
def test_trainer_qat_steps_match_jax(mode):
    """Two QAT steps on the module path against the JAX Trainer's linen
    step: metrics at rtol 1e-4, parameter leaves at 2e-3 of their max."""
    want, got, jparams, tparams, _, tt = _trainers(mode)
    assert tt.fused is False and tt._train_kind == "module"
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert set(tparams) == set(jparams)
    for path, leaf in jparams.items():
        scale = max(float(np.abs(leaf).max()), 1e-3)
        np.testing.assert_allclose(tparams[path] / scale, leaf / scale, rtol=2e-3, atol=2e-3,
                                   err_msg=path)


@pytest.mark.parametrize("mode", ["dynamic", "smoothed"])
def test_trainer_qat_eval_step_matches_jax(mode):
    """The eval step runs the fake-quantized forward, as JAX's."""
    *_, jt, tt = _trainers(mode)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)
    y = (np.arange(5) % 5).astype(np.int64)
    jc, jl, _ = jt.eval_step(jnp.asarray(x), jnp.asarray(y))
    tc, tl, _ = tt.eval_step(x, y)
    assert int(tc) == int(jc)
    assert float(tl) == pytest.approx(float(jl), rel=1e-4)
    with torch.no_grad():
        plain = torch.nn.functional.cross_entropy(tt.model(torch.from_numpy(x))[0],
                                                  torch.from_numpy(y))
    assert float(tl) != float(plain)


# ------------------------------------------------------------- the sites


@pytest.mark.parametrize("family", list(FAMILIES) + list(SITE_FAMILIES))
def test_sites_fire_as_in_jax(family, monkeypatch):
    """Under fake_quant(True) the eval forward reaches the same four sites
    as JAX's, as often where JAX traces each layer. JAX's A-ViT runs its
    layers in one ``nn.scan``, whose body is traced twice whatever the
    depth, where the port runs each of its three layers. JAX traces a
    vmapped MoE stack once and the port runs each expert; the stack
    rewinds the layer counters (``fake_quant.rewind_sites``), so that
    under static caps of one entry a layer both consume them exactly and
    agree at 2e-4."""
    x = _images(2)
    counts, key = {}, ["port"]
    if family in FAMILIES:
        tm, _, budget = _pair(family)
        jax_counts = _jax_outputs(family)[1]["dynamic"]
    else:
        args, budget = SITE_FAMILIES[family]
        tm = _port_model(family, args)
        jm = _jax_model(family, args, tm)
        jax_key = ["jax"]
        monkeypatch.setattr(jfq, "maybe_fq", _counting(counts, jax_key, jfq.maybe_fq))
        _jax_forward(jm, x, budget)
        jax_counts = counts["jax"]
    for module in (tattention, tmlp):
        monkeypatch.setattr(module, "maybe_fq", _counting(counts, key, tfq.maybe_fq))
    with tfq.fake_quant(True):
        eval_forward(tm, x, budget)
    port_counts = counts["port"]
    assert set(port_counts) == set(jax_counts) == {"qkv", "out", "fc1", "fc2"}
    if family == "adavit":
        assert set(jax_counts.values()) == {2} and set(port_counts.values()) == {3}
    elif family == "moevit":  # attn_moes [2, 1], mlp_moes [1, 3]
        assert jax_counts == dict.fromkeys(jax_counts, 2)
        assert port_counts == {"qkv": 3, "out": 3, "fc1": 4, "fc2": 4}
        layer = ((1.5, 0.5), (1.5, 0.5))
        want = _jax_forward(jm, x, caps=(layer, layer))
        with tfq.fake_quant(True, caps=(layer, layer)):
            got, _ = eval_forward(tm, x)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    else:
        assert port_counts == jax_counts


# ------------------------------------------------------------- the errors


def _raises_both(jax_fn, port_fn):
    types = []
    for fn in (jax_fn, port_fn):
        try:
            fn()
            types.append(None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            types.append(type(e))
    return types


def _vit_forward_both(caps):
    """The 2-layer ViT's eval forward under static caps, in both packages:
    [(exception or None) of JAX, of the port]."""
    tm, jm, _ = _pair("vit")
    x = _images(2)

    def jax_run():
        _jax_forward(jm, x, caps=caps)

    def port_run():
        with tfq.fake_quant(True, caps=caps):
            eval_forward(tm, x)

    return _raises_both(jax_run, port_run)


def _error_case(case):
    layer = ((1.0, 1.0), (1.0, 1.0))
    caps2 = (layer, layer)
    vit_t, vit_j, _ = _pair("vit")
    if case == "zero_consumption":
        def body(fq):
            with fq.fake_quant(True, caps=caps2):
                pass
        return _raises_both(lambda: body(jfq), lambda: body(tfq)), ValueError
    if case == "length_mismatch":
        sm = ((np.ones(32, np.float32), np.ones(32, np.float32)),)
        return _raises_both(lambda: jfq.fake_quant(True, caps=caps2, smoothing=sm).__enter__(),
                            lambda: tfq.fake_quant(True, caps=caps2, smoothing=sm).__enter__()
                            ), ValueError
    if case == "past_calibrated_layers":
        return _vit_forward_both(caps2[:1]), ValueError
    if case == "unsupported_family":
        moe_args = SITE_FAMILIES["moevit"][0]
        tm = _port_model("moevit", moe_args)
        jmod = resolve_model_class("moevit")(**moe_args)
        return _raises_both(lambda: jinf._qat_family(jmod),
                            lambda: tinf._qat_family(tm)), NotImplementedError
    if case == "static_without_caps":
        return _raises_both(
            lambda: JaxTrainer(model=vit_j, optimizer=jax_optim.SGD(lr=0.1), qat="static"),
            lambda: Trainer(model=vit_t, optimizer=optim.SGD(lr=0.1), qat="static",
                            device="cpu")), ValueError
    if case == "unknown_mode":
        return _raises_both(
            lambda: JaxTrainer(model=vit_j, optimizer=jax_optim.SGD(lr=0.1), qat="int4"),
            lambda: Trainer(model=vit_t, optimizer=optim.SGD(lr=0.1), qat="int4",
                            device="cpu")), ValueError
    if case == "trainer_length_mismatch":
        sm = ((np.ones(32, np.float32), np.ones(32, np.float32)),)
        return _raises_both(
            lambda: JaxTrainer(model=vit_j, optimizer=jax_optim.SGD(lr=0.1), qat="static",
                               qat_caps=caps2, qat_smoothing=sm),
            lambda: Trainer(model=vit_t, optimizer=optim.SGD(lr=0.1), qat="static",
                            qat_caps=caps2, qat_smoothing=sm, device="cpu")), ValueError
    assert case == "sequence_parallel"
    return _raises_both(
        lambda: JaxTrainer(model=vit_j, optimizer=jax_optim.SGD(lr=0.1), qat=True,
                           sequence_parallel_devices=2),
        lambda: Trainer(model=vit_t, optimizer=optim.SGD(lr=0.1), qat=True,
                        sequence_parallel_devices=2, device="cpu")), NotImplementedError


@pytest.mark.parametrize("case", ["zero_consumption", "length_mismatch",
                                  "past_calibrated_layers", "unsupported_family",
                                  "static_without_caps", "unknown_mode",
                                  "trainer_length_mismatch", "sequence_parallel"])
def test_jax_error_cases_raise_the_same_type(case):
    types, want = _error_case(case)
    assert types == [want, want], types


def test_qat_refuses_remat_and_leaves_the_state_clean():
    """A checkpointed backward would rerun the forward outside the block:
    QAT refuses remat. A failed block restores the switch."""
    tm, _, _ = _pair("vit")
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(model=tm, optimizer=optim.SGD(lr=0.1), qat=True, remat=True, device="cpu")
    with pytest.raises(ValueError):
        with tfq.fake_quant(True, caps=(((1.0, 1.0), (1.0, 1.0)),)):
            pass
    assert not tfq.enabled() and tfq._SITE_IDX is None
    for family in ("moevit", "adavit"):  # outside the registry, as in JAX
        with pytest.raises(NotImplementedError, match="calibrated qat"):
            tinf.collect_qat_caps(_port_model(family, SITE_FAMILIES[family][0]), _images(0, 2))


# ------------------------------------------------------------- the CLI

TINY = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=48",
        "dataset.val_size=16", "training.train_batch_size=16", "training.eval_batch_size=16",
        "training.num_epochs=0", "training.eval_every=1", "training.checkpoint_every=1",
        "training.num_workers=0", "model.patch_size=8", "model.num_layers=2",
        "model.hidden_dim=32", "model.mlp_dim=64", "model.num_heads=2"]


@pytest.mark.parametrize("qat, line", [
    ("static", "qat=static: calibrated 2 layer caps on 24 images (SmoothQuant-aware)"),
    ("true", None),
])
def test_cli_train_qat(tmp_path, capsys, monkeypatch, qat, line):
    """cli.train training.qat=... trains with the Trainer's QAT (static:
    calibrated on the first qat_calib_images training images, the line JAX
    prints) and validates."""
    seen = {}
    real = Trainer.__post_init__

    def spy(self):
        seen.update(qat=self.qat, caps=self.qat_caps, smoothing=self.qat_smoothing)
        real(self)

    monkeypatch.setattr(Trainer, "__post_init__", spy)
    res = cli_train.main([f"workspace={tmp_path}", "experiment_name=qat", "--device", "cpu",
                          f"training.qat={qat}", "training.qat_calib_images=24",
                          "training.qat_percentile=99.0"] + TINY)[0]
    printed = capsys.readouterr().out
    assert res["val_accuracy"] and "epoch 0: total_loss=" in printed
    assert "nan" not in printed.split("epoch 0:")[1].split("\n")[0]
    if line is None:
        assert seen == dict(qat=True, caps=None, smoothing=None)
        assert "qat=static" not in printed
    else:
        assert line in printed
        assert seen["qat"] == "static" and len(seen["caps"]) == len(seen["smoothing"]) == 2
