"""The port's serving bundles (``peekvit_torch/serving.py``) on the CPU.

- Every family's bundle, loaded, gives its live port engine's outputs bit
  for bit (fp32, ``device="cpu"``; the same forward on the same operands),
  at every budget a traced bundle serves.
- Dead-leaf pruning: the npz holds exactly the live set; a dead leaf comes
  back on the ``meta`` device with no bytes and raises when read.
- Loading builds nothing: the model zoo, the preparation, quantization and
  calibration are patched to raise.
- Bucketed bundles pad and slice (within 5e-6 where a call is padded, as
  JAX's tests/test_serving.py holds it: GEMM blocking depends on the batch
  shape; bitwise where it is not); the coupled refusal; JAX's guards; the
  serving CLI; ``cli.test test.export_bundle`` / ``export_buckets``.
- Held against JAX: on the same weights (``params_from_jax``), fp32, the
  port's loaded bundle against JAX's loaded bundle (``interpret=True``) at
  rtol = atol = 2e-4 (tests/test_inference.py:34), for a bucketed plain
  ViT with a padded call, a padded RankViT and the coupled ResidualViT;
  the shared ``meta.json`` fields equal, and ``meta["params"]`` with JAX's
  keys, shapes and dtypes.
- The routed MoE's whole-batch capacity (a fault of the reference, kept):
  padding changes a request's logits in JAX's engine and the port's alike.

Toy size: 32 px, patch 8, 2 layers, width 64. Inputs come from numpy with
a seed. Each JAX bundle is exported in the one test that uses it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_torch import InferenceEngine, build_model
from peekvit_torch import inference as tinf
from peekvit_torch import serving
from peekvit_torch.models.adapters import params_from_jax
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.serving import (BucketedServingEngine, load_serving_bundle,
                                   save_bucketed_bundle, save_serving_bundle)

VIT = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
           num_classes=7)
RES = dict(VIT, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
           add_budget_token="learnable")
ENCDEC = dict(VIT, num_heads=3, hidden_dim=96, residual_layers=["attention+mlp"] * 2,
              gate_type="sigmoid", add_budget_token="learnable", decoder_hidden_dim=96,
              decoder_num_layers=1, decoder_num_heads=2, decoder_mlp_dim=64)
MAE = dict(VIT, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
           num_decoder_layers=1, num_decoder_heads=2)
MOE = dict(VIT, mlp_moes=[2, 1], attn_moes=[1, 2])
PCT = dict(num_points=64, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128, num_classes=40)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
PAD_ATOL = 5e-6
FP32 = torch.float32


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(b=2, seed=0, s=32):
    return np.random.default_rng(seed).normal(size=(b, s, s, 3)).astype(np.float32)


def _points(b=2, seed=9):
    return np.random.default_rng(seed).standard_normal((b, 64, 3)).astype(np.float32)


def _model(kind, args, seed=3):
    """A port model whose every weight is moved off its init by a seeded
    0.05 normal (the zero-init head would make every logit 0)."""
    model = build_model(kind, args, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _engine(kind, args, seed=3, **kw):
    return InferenceEngine(_model(kind, args, seed), compute_dtype=FP32, device="cpu", **kw)


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


def _same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _meta(path, sub=""):
    with open(os.path.join(path, sub, "meta.json")) as f:
        return json.load(f)


# -------------------------------------------------- every family, bit for bit


def _rankpct():
    model = _model("rankpct", PCT, 5)
    model.enable_ranking(True)
    return InferenceEngine(model, compute_dtype=FP32, device="cpu")


# name -> (engine factory, sample, save budget, served budgets, budget mode, outputs)
FAMILIES = {
    "vit": (lambda: _engine("vit", VIT), _x, None, (None,), "none", 1),
    "vit_int8": (lambda: _engine("vit", VIT, 5, quantized=True), _x, None, (None,), "none", 1),
    "rankvit_static": (lambda: _engine("rankvit", dict(VIT, rankvit_layers=[1]), 7), _x, 0.5,
                       (0.5,), "static", 1),
    "rankvit_padded": (lambda: _engine("rankvit", dict(VIT, rankvit_layers=[1]), 7,
                                       max_budget=0.75), _x, None, (0.75, 0.5, 0.25),
                       "traced", 1),
    "residualvit": (lambda: _engine("residualvit", RES, 11), _x, None, (1.0, 0.5, 0.25),
                    "traced", 1),
    "residualvit_compact_auto": (lambda: _engine("residualvit", RES, 11, compact=True), _x, 0.5,
                                 (0.5,), "traced", 1),
    "eeresidualvit": (lambda: _engine("eeresidualvit", dict(RES, num_layers=3,
                                                            residual_layers=["attention+mlp"] * 3,
                                                            add_budget_token=0.5),
                                      19, ee_outputs=True), _x, None, (1.0, 0.6), "traced", 4),
    "encdec_recon": (lambda: _engine("encdecresidualvit", ENCDEC, 29, recon_outputs=True), _x,
                     None, (1.0, 0.5), "traced", 3),
    "mae_recon": (lambda: _engine("maevit", MAE, 23, recon_outputs=True), _x, None, (None,),
                  "none", 2),
    "moe_dense": (lambda: _engine("moevit", MOE, 13), _x, None, (None,), "none", 1),
    "moe_routed": (lambda: _engine("moevit", MOE, 13, routed=2.0, routed_min_experts=2), _x,
                   None, (None,), "none", 1),
    "moe_int8": (lambda: _engine("moevit", MOE, 13, quantized=True), _x, None, (None,), "none",
                 1),
    "adavit": (lambda: _engine("adavit", dict(VIT, num_layers=3, gate_center=5.0), 17), _x,
               None, (None,), "none", 1),
    "pct": (lambda: _engine("pct", PCT, 5), _points, None, (None,), "none", 1),
    "rankpct": (_rankpct, _points, 0.5, (0.5,), "static", 1),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_bundle_matches_live_engine(tmp_path, name):
    make, sample, save_budget, budgets, mode, n_out = FAMILIES[name]
    engine = make()
    x = sample()
    if mode == "static" or name.endswith("compact_auto"):
        match = "one geometry per budget" if mode == "static" else "compact-auto"
        with pytest.raises(ValueError, match=match):
            save_serving_bundle(engine, str(tmp_path / "nob"), x)
    path = save_serving_bundle(engine, str(tmp_path / "b"), x, budget=save_budget)
    meta = _meta(path)
    assert meta["budget_mode"] == mode and meta["framework"] == "torch"
    assert serving.FORWARDS[meta["forward"]] is engine._resolve(budgets[0])[0]
    srv = load_serving_bundle(path, device="cpu")
    for b in budgets:
        got = srv(x) if b is None else srv(x, budget=b)
        want = engine(x) if b is None else engine(x, budget=b)
        assert len(_leaves(got)) == n_out
        _same(got, want)
    if name.endswith("compact_auto"):
        # a lower budget runs with the export budget's capacities
        fwd, kw, _ = engine._resolve(0.5)
        with torch.inference_mode():
            want = fwd(engine.params, torch.from_numpy(x), 0.25, **kw)
        _same(srv(x, budget=0.25), want)
        with pytest.raises(ValueError, match="max_budget"):
            srv(x, budget=0.75)
    if mode == "static":
        with pytest.raises(ValueError, match="static budget"):
            srv(x, budget=0.25)


# -------------------------------------------------------------- dead leaves


def test_bundle_prunes_dead_leaves(tmp_path):
    """The one-call ViT forward reads the stacked set: the per-layer
    originals and the _folded_* copies are dead, absent from the npz, and
    come back as byteless meta tensors that raise when read. MAE's
    train-only mask_token is dead too."""
    engine = _engine("vit", VIT)
    x = _x()
    path = save_serving_bundle(engine, str(tmp_path / "pr"), x)
    meta = _meta(path)
    dead = {k for k, s in meta["params"].items() if s.get("dead")}
    live = {k for k, s in meta["params"].items() if not s.get("dead")}
    assert set(meta["params"]) == set(serving._flatten(engine.params))
    assert "encoder/layers_0/_folded_qkv/kernel" in dead
    assert "encoder/layers_1/self_attention/out_proj_kernel" in dead
    assert all(k.startswith("encoder/_stacked_layers/") for k in live if "layers" in k)
    assert set(np.load(os.path.join(path, "params.npz")).files) == live
    srv = load_serving_bundle(path, device="cpu")
    flat = serving._flatten(srv.params)
    assert set(flat) == set(meta["params"])  # the keys stay
    leaf = flat["encoder/layers_0/_folded_qkv/kernel"]
    assert leaf.device.type == "meta" and leaf.shape == (64, 192) and leaf.dtype == FP32
    with pytest.raises(RuntimeError, match="dead leaf"):
        leaf.cpu()
    with pytest.raises(RuntimeError, match="dead leaf"):
        torch.ones(3, 64) @ leaf
    _same(srv(x), engine(x))

    mae = save_serving_bundle(_engine("maevit", MAE, 23), str(tmp_path / "mae"), x)
    assert _meta(mae)["params"]["mask_token"].get("dead")


def test_loading_builds_nothing(tmp_path, monkeypatch):
    """load_serving_bundle and the served call run no model building,
    preparation, quantization or calibration."""
    engines = {"vit": _engine("vit", VIT, 5, quantized=True),
               "res": _engine("residualvit", RES, 11, quantized=True),
               "moe": _engine("moevit", MOE, 13, quantized=True)}
    x = _x(seed=4)
    paths = {k: save_serving_bundle(e, str(tmp_path / k), x) for k, e in engines.items()}
    want = {k: e(x) for k, e in engines.items()}

    def boom(*args, **kwargs):
        raise AssertionError("loading a bundle built something")

    import peekvit_torch.models.registry as registry
    for mod, names in ((tinf, ("prepare_engine_params", "prepare_pct_engine_params",
                               "quantize_vit_params", "quantize_residualvit_params",
                               "quantize_moevit_params", "collect_activation_caps",
                               "compute_smoothing_vectors", "collect_residualvit_activation_stats",
                               "smooth_vit_params")),
                       (registry, ("build_model",))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    monkeypatch.setattr(InferenceEngine, "__init__", boom)
    for k, path in paths.items():
        _same(load_serving_bundle(path, device="cpu")(x), want[k])


# ---------------------------------------------------------------- buckets


def test_bucketed_bundle_pads_and_slices(tmp_path):
    engine = _engine("vit", VIT)
    path = save_bucketed_bundle(engine, str(tmp_path / "bk"), _x(4), batch_sizes=(1, 2, 4))
    srv = load_serving_bundle(path, device="cpu")
    assert isinstance(srv, BucketedServingEngine)
    assert srv.batch_sizes == (1, 2, 4)
    assert sorted(os.listdir(path)) == ["b1", "b2", "b4", "meta.json", "params.npz"]
    for n in (1, 2, 3, 4):
        x = _x(b=n, seed=20 + n)
        got, want = srv(x), engine(x)
        assert got.shape == (n, 7)
        if n in (1, 2, 4):  # exact bucket: the very same call
            _same(got, want)
        else:  # padded: inert up to the GEMM's blocking
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=PAD_ATOL)
    with pytest.raises(ValueError, match="largest exported bucket"):
        srv(_x(b=5))
    # tuple outputs slice leaf by leaf
    ee = _engine("eeresidualvit", dict(RES, add_budget_token="learnable"), 19, ee_outputs=True)
    esrv = load_serving_bundle(save_bucketed_bundle(ee, str(tmp_path / "ee"), _x(2),
                                                    batch_sizes=(2,)), device="cpu")
    x1 = _x(b=1, seed=3)
    for g, w in zip(esrv(x1, budget=0.5), ee(x1, budget=0.5)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=PAD_ATOL)


def test_bucketed_bundle_traced_budget(tmp_path):
    engine = _engine("rankvit", dict(VIT, rankvit_layers=[1]), 7, max_budget=0.75)
    srv = load_serving_bundle(save_bucketed_bundle(engine, str(tmp_path / "rb"), _x(2),
                                                   batch_sizes=(2, 4)), device="cpu")
    for n, b in ((1, 0.5), (3, 0.25), (4, 0.75)):
        x = _x(b=n, seed=n)
        got, want = srv(x, budget=b), engine(x, budget=b)
        if n == 4:
            _same(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=PAD_ATOL)


def test_bucketed_bundle_batch_coupled_refuses_padding(tmp_path):
    engine = _engine("residualvit", dict(RES, add_budget_token=True), 11)
    assert engine._batch_coupled
    assert not _engine("residualvit", RES, 11)._batch_coupled
    path = save_bucketed_bundle(engine, str(tmp_path / "cp"), _x(2), batch_sizes=(2, 4))
    srv = load_serving_bundle(path, device="cpu")
    assert srv.meta["batch_coupled"] is True and _meta(path, "b2")["batch_coupled"] is True
    x = _x(b=2, seed=6)
    _same(srv(x, budget=0.5), engine(x, budget=0.5))
    with pytest.raises(ValueError, match="whole-batch"):
        srv(_x(b=3), budget=0.5)


# ----------------------------------------------------------------- guards


def _jax_bundle_dir(tmp_path):
    d = tmp_path / "jaxlike"
    d.mkdir()
    (d / "engine.stablehlo").write_bytes(b"")
    (d / "meta.json").write_text(json.dumps({"format_version": 3, "platform": "cpu",
                                             "image_shape": [2, 32, 32, 3],
                                             "budget_mode": "none", "params": {}}))
    return str(d)


def test_bundle_guards(tmp_path, monkeypatch):
    engine = _engine("vit", VIT)
    x = _x()
    path = save_serving_bundle(engine, str(tmp_path / "g"), x)
    srv = load_serving_bundle(path, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        srv(_x(b=3))
    with pytest.raises(ValueError, match="budget knob"):
        srv(x, budget=0.5)
    rank = _engine("rankvit", dict(VIT, rankvit_layers=[1]), 7, max_budget=0.75)
    rsrv = load_serving_bundle(save_serving_bundle(rank, str(tmp_path / "r"), x), device="cpu")
    with pytest.raises(ValueError, match="max_budget"):
        rsrv(x, budget=0.9)
    noisy = build_model("vit", VIT, noise_args=dict(layer=1, noise_type="gaussian"),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="noise"):
        save_serving_bundle(InferenceEngine(noisy, compute_dtype=FP32, device="cpu"),
                            str(tmp_path / "n"), x)
    tp = InferenceEngine(_model("vit", VIT), compute_dtype=FP32, device="cpu",
                         mesh=Mesh({DATA_AXIS: 1, MODEL_AXIS: 4}, None, None, 0, 0,
                                   torch.device("cpu")))
    with pytest.raises(NotImplementedError, match="single-device"):
        save_serving_bundle(tp, str(tmp_path / "tp"), x)
    engine._mesh = Mesh({DATA_AXIS: 8, MODEL_AXIS: 1}, None, None, 0, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="single-device"):
        save_bucketed_bundle(engine, str(tmp_path / "dp"), x, batch_sizes=(2,))
    # the device type: a cpu bundle does not load on the card, nor the other way
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="device type 'cpu'"):
        load_serving_bundle(path, device="cuda")
    meta = _meta(path)
    meta["platform"] = "cuda"
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="device type 'cuda'"):
        load_serving_bundle(path, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving_bundle(path)  # the card by default
    with pytest.raises(ValueError, match="not a bundle of the PyTorch port"):
        load_serving_bundle(_jax_bundle_dir(tmp_path), device="cpu")


def test_serving_cli(tmp_path, capsys):
    """python -m peekvit_torch.serving BUNDLE INPUT.npy: load, run, save,
    bench; a tuple bundle saves an .npz with out_0.. keys."""
    engine = _engine("vit", VIT)
    x = _x()
    path = save_serving_bundle(engine, str(tmp_path / "cli"), x)
    np.save(tmp_path / "batch.npy", x)
    out = str(tmp_path / "logits.npy")
    info = serving._main([path, str(tmp_path / "batch.npy"), "--out", out, "--bench", "2",
                          "--device", "cpu"])
    assert info["outputs"] == [[2, 7]] and info["ms_per_batch"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"] == [[2, 7]]
    np.testing.assert_array_equal(np.load(out), engine(x).numpy())

    mae = _engine("maevit", MAE, 23, recon_outputs=True)
    mpath = save_serving_bundle(mae, str(tmp_path / "mae"), x)
    info = serving._main([mpath, str(tmp_path / "batch.npy"), "--out",
                          str(tmp_path / "mae.npz"), "--device", "cpu"])
    saved = np.load(tmp_path / "mae.npz")
    assert sorted(saved.files) == ["out_0", "out_1"] and len(info["outputs"]) == 2
    for i, want in enumerate(mae(x)):
        np.testing.assert_array_equal(saved[f"out_{i}"], want.numpy())


# -------------------------------------------------------------- cli.test


CLI_TEST = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=16",
            "dataset.val_size=8", "test.test_batch_size=4", "test.num_workers=0",
            "test.skip_flops_count=true"]
CLI_VIT = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32,
               mlp_dim=64, num_classes=10)


def _checkpoint(tmp_path, kind, args):
    from peekvit_torch.utils.checkpoint import save_state

    return save_state(str(tmp_path / f"{kind}_ckpt"), _model(kind, args, 31))


def test_cli_test_export_bundle_and_buckets(tmp_path, capsys):
    """test.export_bundle: the sweep's own batch geometry, or the buckets
    of test.export_buckets; an exact-drop RankViT gets budget_{b}/ per
    swept budget; the module path exports nothing."""
    from peekvit_torch.cli import test as cli_test
    from peekvit_torch.utils.checkpoint import load_state

    ckpt = _checkpoint(tmp_path, "vit", CLI_VIT)
    base = [f"workspace={tmp_path}/ws", "experiment_name=eval", f"load_from={ckpt}"] + CLI_TEST
    x = np.random.default_rng(2).normal(size=(4, 16, 16, 3)).astype(np.float32)
    model = load_state(ckpt, device="cpu")
    want = InferenceEngine(model, device="cpu")(x)

    cli_test.main(base + [f"test.export_bundle={tmp_path}/one", "--device", "cpu"])
    assert f"exported serving bundle: {tmp_path}/one" in capsys.readouterr().out
    srv = load_serving_bundle(str(tmp_path / "one"), device="cpu")
    assert srv.batch_sizes == (4,)
    _same(srv(x), want)

    cli_test.main(base + [f"test.export_bundle={tmp_path}/bk", "test.export_buckets=[1,8]",
                          "--device", "cpu"])
    bsrv = load_serving_bundle(str(tmp_path / "bk"), device="cpu")
    assert bsrv.batch_sizes == (1, 8)
    _same(bsrv(x[:1]), want[:1])

    rargs = dict(CLI_VIT, rankvit_layers=[1])
    rckpt = _checkpoint(tmp_path, "rankvit", rargs)
    cli_test.main([f"workspace={tmp_path}/ws", "experiment_name=reval", f"load_from={rckpt}",
                   f"test.export_bundle={tmp_path}/rank", "test.budgets=[0.5,1.0]",
                   "--device", "cpu"] + CLI_TEST)
    assert sorted(os.listdir(tmp_path / "rank")) == ["budget_0.5", "budget_1.0"]
    rengine = InferenceEngine(load_state(rckpt, device="cpu"), device="cpu")
    for b in (0.5, 1.0):
        r = load_serving_bundle(str(tmp_path / "rank" / f"budget_{b}"), device="cpu")
        assert r.meta["budget_mode"] == "static" and r.meta["budget"] == b
        _same(r(x, budget=b), rengine(x, budget=b))

    capsys.readouterr()
    cli_test.main(base + [f"test.export_bundle={tmp_path}/none", "test.use_fused_engine=false",
                          "--device", "cpu"])
    assert ("export_bundle: no fused engine for this model/mode; nothing exported"
            in capsys.readouterr().out)
    assert not os.path.exists(tmp_path / "none")


def test_cli_test_export_not_exportable(tmp_path, capsys):
    """JAX's best-effort line: a compact-auto engine needs budget= (a
    ValueError), and the sweep's results still come back."""
    from peekvit_torch.cli import test as cli_test

    args = dict(CLI_VIT, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
                add_budget_token="learnable")
    ckpt = _checkpoint(tmp_path, "residualvit", args)
    out = cli_test.main([f"workspace={tmp_path}/ws", "experiment_name=eval",
                         f"load_from={ckpt}", f"test.export_bundle={tmp_path}/c",
                         "test.compact=true", "test.budgets=[0.5]", "--device", "cpu"]
                        + CLI_TEST)
    assert "export_bundle: not exportable (a compact-auto residual engine" \
        in capsys.readouterr().out
    assert list(out.values())[0]["results_per_budget"][0.5]


# ----------------------------------------------------------- against JAX


def _jax_pair(kind, args, seed):
    """A seeded JAX model with its head at 0.05 (the zero-init head makes
    every logit 0) and the port's model with its weights."""
    from peekvit_tpu.models.registry import build_model as jax_build_model

    jm = jax_build_model(kind, args, seed=seed)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = np.random.default_rng(9).normal(
        0, 0.05, tree["head"]["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return jm, params_from_jax(build_model(kind, args, device="cpu"), tree)


SHARED_META = ("image_shape", "image_dtype", "budget_mode", "budget", "max_budget",
               "batch_coupled", "buckets")
# keys of the prepared trees that differ by design (ROADMAP.md, the port's
# deliberate differences): none at these configurations
PARAM_KEYS_DIFFER: dict = {}


def _check_meta(path, jpath, sub=""):
    got, want = _meta(path, sub), _meta(jpath, sub)
    for k in SHARED_META:
        assert got.get(k) == want.get(k), k
    if "params" in want:
        gp = {k: (s["shape"], s["dtype"]) for k, s in got["params"].items()}
        wp = {k: (s["shape"], s["dtype"]) for k, s in want["params"].items()}
        assert gp == wp


# name -> (kind, args, seed, engine keywords, bucketed, calls as (batch, budget))
JAX_CASES = {
    "vit_bucketed": ("vit", VIT, 3, {}, (1, 2, 4), ((3, None), (4, None))),
    "rankvit_padded": ("rankvit", dict(VIT, rankvit_layers=[1]), 7, dict(max_budget=0.75), None,
                       ((2, 0.75), (2, 0.5), (2, 0.25))),
    "residual_coupled": ("residualvit", dict(RES, add_budget_token=True), 11, {}, (2, 4),
                         ((2, 0.5), (4, 1.0))),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_bundle_held_against_jax(tmp_path, name):
    from peekvit_tpu.inference import InferenceEngine as JaxEngine
    from peekvit_tpu import serving as jserving

    kind, args, seed, kw, buckets, calls = JAX_CASES[name]
    jm, tm = _jax_pair(kind, args, seed)
    jeng = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, **kw)
    teng = InferenceEngine(tm, compute_dtype=FP32, device="cpu", **kw)
    x = _x(b=2, seed=seed)
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    if buckets:
        jserving.save_bucketed_bundle(jeng, jpath, x, batch_sizes=buckets)
        save_bucketed_bundle(teng, tpath, x, batch_sizes=buckets)
        _check_meta(tpath, jpath)
        for n in buckets:
            _check_meta(tpath, jpath, f"b{n}")
    else:
        jserving.save_serving_bundle(jeng, jpath, x)
        save_serving_bundle(teng, tpath, x)
        _check_meta(tpath, jpath)
    jsrv = jserving.load_serving_bundle(jpath)
    tsrv = load_serving_bundle(tpath, device="cpu")
    for n, b in calls:
        xb = _x(b=n, seed=40 + n)
        got = tsrv(xb) if b is None else tsrv(xb, budget=b)
        want = jsrv(jnp.asarray(xb)) if b is None else jsrv(jnp.asarray(xb), budget=b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    if name == "residual_coupled":
        for srv in (tsrv, jsrv):
            with pytest.raises(ValueError, match="whole-batch"):
                srv(_x(b=3), budget=0.5)


# ------------------------------------------- the routed MoE's batch coupling


def test_routed_moe_padding_changes_logits():
    """A fault of the reference, kept: the routed capacity ceil(T / E *
    capacity_factor) counts the whole batch's tokens, so padding one
    request to a bucket changes which of its tokens overflow, yet JAX does
    not mark the engine batch_coupled. Both engines, called directly."""
    from peekvit_tpu.inference import InferenceEngine as JaxEngine

    args = dict(VIT, mlp_moes=[2, 2], attn_moes=[1, 1])
    jm, tm = _jax_pair("moevit", args, 13)
    jeng = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, routed=0.5,
                     routed_min_experts=2)
    teng = InferenceEngine(tm, compute_dtype=FP32, device="cpu", routed=0.5,
                           routed_min_experts=2)
    assert not teng._batch_coupled and not jeng._batch_coupled
    x = _x(b=1, seed=12)
    padded = np.concatenate([x, np.zeros((3,) + x.shape[1:], np.float32)])
    for alone, in_bucket in ((np.asarray(jeng(jnp.asarray(x))),
                              np.asarray(jeng(jnp.asarray(padded)))[:1]),
                             (teng(x).numpy(), teng(padded)[:1].numpy())):
        assert np.abs(alone - in_bucket).max() > 1e-3
    np.testing.assert_allclose(teng(x).numpy(), np.asarray(jeng(jnp.asarray(x))), **JAX_TOL)
