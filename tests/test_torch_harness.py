"""The port's harness against the JAX package's, on the CPU: the config
loader, the data pipeline, checkpoints, the preemption guard, model
surgery, pretrained weights and the FLOPs count.

The same inputs (configs, seeds, numpy arrays, a .pth written here) go
through both packages. Where weights must match, the port's model takes
the JAX model's tree through ``params_from_jax``. Every tolerance is
stated where it is used; most comparisons are exact."""

import glob
import json
import os
import signal
import time

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from peekvit_tpu.data import transforms as JT
from peekvit_tpu.data.datasets import ImageFolder as JaxImageFolder
from peekvit_tpu.data.loader import DataLoader as JaxDataLoader
from peekvit_tpu.data.synthetic import Synthetic as JaxSynthetic
from peekvit_tpu.models import adapters as jax_adapters
from peekvit_tpu.models import topology as jax_topology
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.utils import config as jax_config
from peekvit_tpu.utils import flops_count as jax_flops
from peekvit_torch.data import transforms as T
from peekvit_torch.data.datasets import ImageFolder
from peekvit_torch.data.loader import BackgroundIterator, DataLoader, prefetch_to_device
from peekvit_torch.data.synthetic import Synthetic
from peekvit_torch.models import adapters, topology
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.models.registry import _PORTED, build_model
from peekvit_torch.utils import checkpoint, config
from peekvit_torch.utils.flops_count import compute_flops, sparsity_per_module
from peekvit_torch.utils.preemption import PreemptionGuard

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
SMALL = dict(image_size=16, patch_size=8, num_layers=3, num_heads=2, hidden_dim=32,
             mlp_dim=64, num_classes=5)
FAMILY_ARGS = {
    "vit": {},
    "residualvit": dict(residual_layers=["attention+mlp"] * 3, gate_type="sigmoid",
                        add_input=False, add_budget_token="learnable", gate_temp=1.0),
    "rankvit": dict(rankvit_layers=[0, 1, 2]),
    "moevit": dict(mlp_moes=[1, 2, 2], attn_moes=[1, 1, 2]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are tiny, and a shared machine's
    thread pool costs more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.array(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _twins(family, seed=0, **extra):
    """A JAX model and the port's model on its weights."""
    args = dict(SMALL, **FAMILY_ARGS[family], **extra)
    jm = jax_build_model(family, args, seed=seed)
    pm = params_from_jax(build_model(family, args, device="cpu"), _jax_np(jm.params))
    return jm, pm


def _images(n=3, size=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


def _logits(out):
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(out.detach() if isinstance(out, torch.Tensor) else out)


# ------------------------------------------------------------------- config

OVERRIDES = {
    "defaults": [],
    "groups": ["model=rankvit", "dataset=synthetic", "optimizer=sgd",
               "scheduler=cosineannealing", "loss=crossentropy_mse"],
    "values": ["model.patch_size=16", "training.num_epochs=3", "+extra.flag=true",
               "~load_from", "training.fused=false", "seed=7"],
    "null": ["scheduler=null", "noise=gaussian", "noise.snr=null", "model=null"],
    "lists": ["training.val_budgets=[0.5,1.0]", "model=residualvit",
              "model.residual_layers=['attention+mlp','attention+mlp']",
              "loss.additional_losses.mse.skip_layers=[]"],
}


@pytest.mark.parametrize("config_name", ["train_config", "test_config"])
@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_load_config_matches_jax(config_name, case):
    """load_config + to_plain equal JAX's under group, value, null and list
    overrides (an explicit experiment_name, so ${now:} cannot tick between)."""
    ov = ["experiment_name=fixed"] + OVERRIDES[case]
    if config_name == "test_config" and case == "lists":
        ov += ["test.budgets=[0.25,0.5]"]
    got = config.to_plain(config.load_config(CONFIG_DIR, config_name, ov))
    want = jax_config.to_plain(jax_config.load_config(CONFIG_DIR, config_name, ov))
    assert got == want


def test_expand_multirun_and_now_match_jax(tmp_path):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "train"))
    from train import expand_multirun as jax_expand

    from peekvit_torch.cli.train import expand_multirun

    ov = ["model=vit_tiny,rankvit", "training.num_epochs=1,2,3", "seed=0"]
    assert list(expand_multirun(ov)) == list(jax_expand(ov))
    cfg = config.load_config(CONFIG_DIR, "train_config")
    assert cfg.experiment_name[:2] == "20" and cfg.experiments_dir == "./workspace/runs"
    config.save_config(cfg, str(tmp_path / "config.yaml"))
    assert yaml.safe_load((tmp_path / "config.yaml").read_text()) == config.to_plain(cfg)


MODEL_CONFIGS = sorted(os.path.basename(p)[:-5]
                       for p in glob.glob(os.path.join(CONFIG_DIR, "model", "*.yaml")))


@pytest.mark.parametrize("name", MODEL_CONFIGS)
def test_every_model_config_composes(name):
    """Each configs/model/*.yaml composes as in JAX, and its _target_ names a
    port class of the JAX class's name (through build_model's registry, as
    both entry points read it)."""
    ov = ["experiment_name=fixed", f"model={name}"]
    if name in ("pct", "rankpct"):
        ov.append("dataset=modelnet40")
    got = config.load_config(CONFIG_DIR, "train_config", ov)
    assert config.to_plain(got) == jax_config.to_plain(
        jax_config.load_config(CONFIG_DIR, "train_config", ov))
    cls = got.model["_target_"].rsplit(".", 1)[-1]
    assert _PORTED[cls].__name__ == resolve_model_class(cls).__name__


def _targets():
    out = set()
    for path in glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True):
        if os.sep + "model" + os.sep in path:
            continue

        def walk(node):
            if isinstance(node, dict):
                if "_target_" in node:
                    out.add(node["_target_"])
                for v in node.values():
                    walk(v)

        walk(yaml.safe_load(open(path)))
    return sorted(out)


@pytest.mark.parametrize("target", _targets())
def test_every_target_resolves_to_a_port_class(target):
    """Every other _target_ under configs/ (datasets, loggers, losses, the
    torch.optim aliases) resolves to a port object of the JAX object's
    name, in peekvit_torch; torch.* never to torch itself."""
    got, want = config.resolve_target(target), jax_config.resolve_target(target)
    assert got.__name__ == want.__name__
    assert got.__module__.startswith("peekvit_torch.")
    if target.startswith("torch.optim"):
        spec = config.instantiate({"_target_": target, "lr": 0.5})
        assert type(spec).__module__.startswith("peekvit_torch.")


# --------------------------------------------------------------------- data


def test_synthetic_bit_equal_to_jax():
    kw = dict(image_size=16, num_classes=7, train_size=40, val_size=24, seed=3)
    got, want = Synthetic(**kw), JaxSynthetic(**kw)
    for split in ("train_dataset", "val_dataset"):
        np.testing.assert_array_equal(getattr(got, split).data, getattr(want, split).data)
        np.testing.assert_array_equal(getattr(got, split).labels, getattr(want, split).labels)
    np.testing.assert_array_equal(got.denormalize_transform(got.val_dataset.data[:2]),
                                  want.denormalize_transform(want.val_dataset.data[:2]))


@pytest.mark.parametrize("num_workers", [0, 4])
@pytest.mark.parametrize("mode", ["shuffle", "drop_last", "shard"])
def test_dataloader_bit_equal_to_jax(num_workers, mode):
    """Two epochs of batches, bit-equal: the seeded per-epoch shuffle,
    drop_last and shard=(1, 3)."""
    ds = Synthetic(image_size=8, num_classes=5, train_size=37, val_size=4, seed=1)
    kw = dict(batch_size=6, num_workers=num_workers, seed=5, shuffle=mode != "drop_last",
              drop_last=mode != "shuffle", shard=(1, 3) if mode == "shard" else None)
    got, want = DataLoader(ds.train_dataset, **kw), JaxDataLoader(ds.train_dataset, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        assert pairs
        for (gx, gy), (wx, wy) in pairs:
            assert gx.dtype == np.float32 and gy.dtype == np.int32
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def _pil_image(seed, w=40, h=30):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8),
                           "RGB")


@pytest.mark.parametrize("seed", range(6))
def test_transforms_bit_equal_to_jax(seed):
    """test_transform, and train_transform (RandAugment) under one numpy rng,
    bit-equal on a seeded PIL image; six seeds draw most of the 14 ops."""
    img = _pil_image(seed)
    np.testing.assert_array_equal(T.test_transform(24)(img), JT.test_transform(24)(img))
    got = T.train_transform(24, 3, 9)(img, np.random.default_rng(seed))
    want = JT.train_transform(24, 3, 9)(img, np.random.default_rng(seed))
    np.testing.assert_array_equal(got, want)


def test_imagefolder_matches_jax_pil_path(tmp_path):
    """The scan (classes, samples, labels) equals JAX's, and each decoded
    sample its PIL path's (JAX's native decoder turned off)."""
    for c, cls in enumerate(["b_dog", "a_cat", "c_owl"]):
        for i in range(2 + c):
            sub = tmp_path / cls / ("nested" if i == 2 else "")
            sub.mkdir(parents=True, exist_ok=True)
            _pil_image(10 * c + i, 20 + i, 18).save(sub / f"{i}.png")
    (tmp_path / "a_cat" / "notes.txt").write_text("not an image")
    got, want = ImageFolder(tmp_path, T.test_transform(16)), JaxImageFolder(tmp_path,
                                                                            JT.test_transform(16))
    want._native_spec = False
    assert got.classes == want.classes and got.samples == want.samples
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    with pytest.raises(NotImplementedError, match="item 8 part 3"):
        got.native_batch([0])


def test_prefetch_keeps_order_and_needs_a_card_unless_asked(monkeypatch):
    batches = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32) + i)
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for (x, y), (wx, wy) in zip(out, batches):
        assert isinstance(x, torch.Tensor)
        np.testing.assert_array_equal(x.numpy(), wx)
        np.testing.assert_array_equal(y.numpy(), wy)
    assert [b[0][0, 0] for b in BackgroundIterator(iter(batches), maxsize=2)] == list(range(5))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(prefetch_to_device(iter(batches)))


# --------------------------------------------------------------- checkpoint


def test_checkpoint_round_trip_rebuilds_from_metadata(tmp_path):
    model = build_model("residualvit", dict(SMALL, **FAMILY_ARGS["residualvit"]), seed=2,
                        device="cpu")
    ckdir, _ = checkpoint.make_experiment_directory(str(tmp_path / "exp"))
    checkpoint.save_state(ckdir, model, epoch=0)
    checkpoint.save_state(ckdir, model, epoch=2)
    path = checkpoint.get_checkpoint_path(str(tmp_path / "exp"))
    assert path.endswith("epoch_002") and sorted(os.listdir(path)) == ["metadata.json",
                                                                        "params.pt"]
    loaded = checkpoint.load_state(path, device="cpu")
    assert type(loaded) is type(model) and loaded.model_class == "residualvit"
    x = torch.tensor(_images())
    with torch.no_grad():
        np.testing.assert_array_equal(_logits(loaded(x, budget=0.5)), _logits(model(x, budget=0.5)))
    # a directory whose params.pt is not committed is skipped
    os.makedirs(os.path.join(ckdir, "epoch_004"))
    with open(os.path.join(ckdir, "epoch_004", "metadata.json"), "w") as f:
        json.dump({"epoch": 4}, f)
    open(os.path.join(ckdir, "epoch_004", "params.pt.tmp"), "w").close()
    assert checkpoint.get_checkpoint_path(str(tmp_path / "exp")) == path


def test_checkpoint_metadata_matches_jax_and_orbax_is_refused(tmp_path):
    """metadata.json holds what JAX's save_state writes for the same model
    (checkpoint.py:75-82: model_class, model_args, noise_args, epoch and the
    extras); a JAX (orbax) checkpoint directory is refused."""
    import dataclasses

    noise = {"noise_type": "gaussian", "layer": 1, "std": None, "snr": None}
    jm, _ = _twins("residualvit")
    jm = dataclasses.replace(jm, noise_args=dict(noise))
    pm = build_model("residualvit", dict(SMALL, **FAMILY_ARGS["residualvit"]),
                     noise_args=noise, device="cpu")
    ppath = checkpoint.save_state(str(tmp_path / "port"), pm, epoch=3,
                                  extra_metadata={"partial": True})
    want = {"model_class": jm.model_class, "model_args": jm.model_args,
            "noise_args": jm.noise_args, "epoch": 3, "partial": True}
    got = json.load(open(os.path.join(ppath, "metadata.json")))
    assert got == json.loads(json.dumps(want, default=str))
    orbax = tmp_path / "jax" / "checkpoints" / "epoch_000"
    os.makedirs(orbax / "params")
    (orbax / "metadata.json").write_text(json.dumps(want))
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_state(str(orbax), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.get_checkpoint_path(str(tmp_path / "jax"))


def test_non_strict_load_keeps_init_and_reports_jax_missing_paths(tmp_path, capsys):
    """A ViT checkpoint into a ResidualViT, strict=False: the shared leaves
    load, the gates and budget token keep their init values, and the
    missing paths are JAX's transfer_params's."""
    vit = build_model("vit", SMALL, seed=1, device="cpu")
    path = checkpoint.save_state(str(tmp_path), vit)
    res_args = dict(SMALL, **FAMILY_ARGS["residualvit"])
    res = build_model("residualvit", res_args, seed=4, device="cpu")
    init = params_to_jax(res)
    loaded = params_to_jax(checkpoint.load_state(path, res, strict=False))
    _, want_missing, _ = jax_adapters.transfer_params(
        _jax_np(jax_build_model("vit", SMALL).params),
        _jax_np(jax_build_model("residualvit", res_args).params))
    printed = capsys.readouterr().out
    assert "keeping init" in printed
    vit_leaves = _flat(params_to_jax(vit))
    missing = []
    for k, v in _flat(loaded).items():
        if k in vit_leaves and vit_leaves[k].shape == v.shape:
            np.testing.assert_array_equal(v, vit_leaves[k])
        else:
            np.testing.assert_array_equal(v, _flat(init)[k])
            missing.append(k)
    assert sorted(missing) == sorted(want_missing) and missing


def test_async_save_snapshots_before_an_in_place_step(tmp_path):
    model = build_model("vit", SMALL, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=10.0)
    path = checkpoint.save_state(str(tmp_path), model, epoch=1, async_save=True)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()  # in place, while the write may still be in flight
    checkpoint.wait_for_checkpoints()
    saved = torch.load(os.path.join(path, "params.pt"))
    assert any(not torch.equal(saved[k], model.state_dict()[k]) for k in saved)
    for k, v in before.items():
        assert torch.equal(saved[k], v), k


def test_optimizer_state_round_trip_is_exact(tmp_path):
    model = build_model("vit", SMALL, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    x, y = torch.tensor(_images(4)), torch.tensor([0, 1, 2, 3])

    def step(m, o):
        o.zero_grad()
        torch.nn.functional.cross_entropy(m(x)[0], y).backward()
        o.step()

    for _ in range(2):
        step(model, opt)
    path = checkpoint.save_state(str(tmp_path), model, opt.state_dict(), epoch=0,
                                 skip_optimizer=False)
    state = checkpoint.load_optimizer_state(path)
    twin = checkpoint.load_state(path, device="cpu")
    twin_opt = torch.optim.Adam(twin.parameters(), lr=1e-2)
    twin_opt.load_state_dict(state)
    for k, v in opt.state_dict()["state"].items():
        for name, t in v.items():
            assert torch.equal(torch.as_tensor(state["state"][k][name]), torch.as_tensor(t))
    step(model, opt)
    step(twin, twin_opt)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------- preemption


def test_guard_flags_a_signal_and_chains_the_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with PreemptionGuard() as guard:
            assert guard.installed and not guard()
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(100):
                if guard.triggered:
                    break
                time.sleep(0.01)
            assert guard() and hits == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is not guard._handle
    finally:
        signal.signal(signal.SIGTERM, prev)


# ----------------------------------------------------------------- topology


@pytest.mark.parametrize("family", sorted(FAMILY_ARGS))
def test_remove_layers_matches_jax(family):
    """remove_layers_and_stitch: the same tree and module configuration as
    JAX's, and logits within 2e-4 on the same weights (fp32 forwards)."""
    jm, pm = _twins(family)
    jr = jax_topology.remove_layers_and_stitch(jm, [1])
    pr = topology.remove_layers_and_stitch(pm, [1])
    _assert_trees_equal(params_to_jax(pr), _jax_np(jr.params))
    assert pr.num_layers == jr.module.num_layers == 2
    for attr in ("residual_layers", "rankvit_layers", "mlp_moes", "attn_moes"):
        want, got = getattr(jr.module, attr, None), getattr(pr, attr, None)
        assert (None if got is None else list(got)) == (None if want is None else list(want))
    assert pr.model_args == jr.model_args
    x = _images()
    kw = {"budget": 0.5} if family in ("residualvit", "rankvit") else {}
    with torch.no_grad():
        got = _logits(pr(torch.tensor(x), **kw))
    want = _logits(jr(jax.numpy.asarray(x), **kw))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # build_model(remove_layers=) is the same surgery on the seeded model
    built = build_model(family, dict(SMALL, **FAMILY_ARGS[family]), remove_layers=[1],
                        device="cpu")
    assert built.num_layers == 2 and built.model_args == pr.model_args


def test_reinit_class_tokens_touches_jax_paths():
    """The re-drawn leaves are JAX's set; on a model with 8 class tokens of
    width 64 (512 draws: the estimate's spread is ~6e-4) their std is
    0.02 within 3e-3."""
    jm, pm = _twins("residualvit")
    before = _flat(params_to_jax(pm))
    after = _flat(params_to_jax(topology.reinit_class_tokens(pm, seed=3)))
    jbefore = _flat(_jax_np(jm.params))
    jafter = _flat(_jax_np(jax_topology.reinit_class_tokens(jm, seed=3).params))
    changed = {k for k in before if not np.array_equal(before[k], after[k])}
    jchanged = {k for k in jbefore if not np.array_equal(jbefore[k], jafter[k])}
    assert changed == jchanged and changed
    wide = build_model("residualvit", dict(SMALL, **FAMILY_ARGS["residualvit"], hidden_dim=64,
                                           num_class_tokens=8), device="cpu")
    tokens = topology.reinit_class_tokens(wide, seed=3).class_tokens.detach()
    assert abs(float(tokens.std()) - 0.02) < 3e-3


@pytest.mark.parametrize("keys", [["gate", "head"], ["class", "threshold", "budget"]])
def test_trainable_masks_match_jax(keys):
    jm, pm = _twins("residualvit")
    jtree = _jax_np(jm.params)
    assert _flat(topology.trainable_mask(pm, keys)) == {
        k: bool(v) for k, v in _flat(jax_topology.trainable_mask(jtree, keys)).items()}
    _, tr, fr = topology.train_only_these_params(pm, keys)
    _, jtr, jfr = jax_topology.train_only_these_params(jtree, keys)
    assert sorted(tr) == sorted(jtr) and sorted(fr) == sorted(jfr)
    assert _flat(topology.freeze_module(pm, "encoder.layers_0")) == {
        k: bool(v) for k, v in _flat(jax_topology.freeze_module(jtree, "encoder.layers_0")).items()}


def test_register_tokens_and_residual_gates_match_jax_trees(capsys):
    jm, pm = _twins("vit")
    jr, pr = jax_topology.add_register_tokens(jm, 2), topology.add_register_tokens(pm, 2)
    got, want = _flat(params_to_jax(pr)), _flat(_jax_np(jr.params))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert pr.num_registers == 2 and pr.model_args["num_registers"] == 2
    pos = got["encoder/pos_embedding"]
    np.testing.assert_array_equal(pos[:, :1], want["encoder/pos_embedding"][:, :1])
    np.testing.assert_array_equal(pos[:, 3:], want["encoder/pos_embedding"][:, 3:])
    gates = dict(residual_layers=["attention+mlp"] * 3, gate_type="sigmoid", add_input=False,
                 gate_temp=1.0)
    jg, pg = jax_topology.add_residual_gates(jm, gates), topology.add_residual_gates(pm, gates)
    got, want = _flat(params_to_jax(pg)), _flat(_jax_np(jg.params))
    assert sorted(got) == sorted(want)
    for k in _flat(params_to_jax(pm)):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------- pretrained


def _torchvision_vit_state_dict(seed, args, num_classes):
    """A seeded state dict in torchvision's ViT grammar."""
    rng = np.random.default_rng(seed)
    d, m, p = args["hidden_dim"], args["mlp_dim"], args["patch_size"]
    n = (args["image_size"] // p) ** 2 + 1

    def w(*shape):
        return torch.tensor((rng.normal(size=shape) * 0.1).astype(np.float32))

    sd = {"class_token": w(1, 1, d), "conv_proj.weight": w(d, 3, p, p), "conv_proj.bias": w(d),
          "encoder.pos_embedding": w(1, n, d), "encoder.ln.weight": 1 + w(d),
          "encoder.ln.bias": w(d), "heads.head.weight": w(num_classes, d),
          "heads.head.bias": w(num_classes)}
    for i in range(args["num_layers"]):
        pre = f"encoder.layers.encoder_layer_{i}."
        sd.update({pre + "ln_1.weight": 1 + w(d), pre + "ln_1.bias": w(d),
                   pre + "self_attention.in_proj_weight": w(3 * d, d),
                   pre + "self_attention.in_proj_bias": w(3 * d),
                   pre + "self_attention.out_proj.weight": w(d, d),
                   pre + "self_attention.out_proj.bias": w(d),
                   pre + "ln_2.weight": 1 + w(d), pre + "ln_2.bias": w(d),
                   pre + "mlp.0.weight": w(m, d), pre + "mlp.0.bias": w(m),
                   pre + "mlp.3.weight": w(d, m), pre + "mlp.3.bias": w(d)})
    return sd


def _timm_vit_state_dict(seed, args, num_classes):
    """The same weights renamed into timm's grammar."""
    sd = _torchvision_vit_state_dict(seed, args, num_classes)
    out = {"cls_token": sd.pop("class_token"), "pos_embed": sd.pop("encoder.pos_embedding"),
           "patch_embed.proj.weight": sd.pop("conv_proj.weight"),
           "patch_embed.proj.bias": sd.pop("conv_proj.bias"),
           "norm.weight": sd.pop("encoder.ln.weight"), "norm.bias": sd.pop("encoder.ln.bias"),
           "head.weight": sd.pop("heads.head.weight"), "head.bias": sd.pop("heads.head.bias")}
    names = {"ln_1": "norm1", "ln_2": "norm2", "self_attention.in_proj_weight": "attn.qkv.weight",
             "self_attention.in_proj_bias": "attn.qkv.bias",
             "self_attention.out_proj.weight": "attn.proj.weight",
             "self_attention.out_proj.bias": "attn.proj.bias", "mlp.0": "mlp.fc1",
             "mlp.3": "mlp.fc2"}
    for k, v in sd.items():
        i, rest = k.removeprefix("encoder.layers.encoder_layer_").split(".", 1)
        for a, b in names.items():
            rest = rest.replace(a, b)
        out[f"blocks.{i}.{rest}"] = v
    return out


@pytest.mark.parametrize("grammar", ["torch", "timm"])
@pytest.mark.parametrize("file_classes", [5, 1000])
def test_pretrained_state_dicts_convert_and_load_as_jax(tmp_path, capsys, grammar, file_classes):
    """A seeded torchvision- and timm-grammar .pth: the converted trees are
    bit-equal to JAX's; build_model(<grammar>_pretrained_weights=path) gives
    JAX's logits within 2e-4; a head of another class count is zeros."""
    make = _torchvision_vit_state_dict if grammar == "torch" else _timm_vit_state_dict
    sd = make(7, SMALL, file_classes)
    path = str(tmp_path / "vit.pth")
    torch.save(sd, path)
    adapt = getattr(adapters, f"adapt_{grammar}_state_dict")
    jadapt = getattr(jax_adapters, f"adapt_{grammar}_state_dict")
    _assert_trees_equal(adapt(sd, num_classes=5), _jax_np(jadapt(sd, num_classes=5)))
    key = f"{grammar}_pretrained_weights"
    pm = build_model("vit", dict(SMALL, **{key: path}), device="cpu")
    jm = jax_build_model("vit", dict(SMALL, **{key: path}))
    _assert_trees_equal(params_to_jax(pm), _jax_np(jm.params))
    assert key not in pm.model_args and key not in jm.model_args
    x = _images()
    with torch.no_grad():
        got = _logits(pm(torch.tensor(x)))
    np.testing.assert_allclose(got, _logits(jm(jax.numpy.asarray(x))), rtol=2e-4, atol=2e-4)
    head = params_to_jax(pm)["head"]["kernel"]
    assert (not head.any()) == (file_classes != 5)


def test_pretrained_hub_name_raises_as_jax():
    spec = "ViT_B_16_Weights[IMAGENET1K_V1]"
    with pytest.raises(FileNotFoundError, match="not a local file"):
        build_model("vit", dict(SMALL, torch_pretrained_weights=spec), device="cpu")
    with pytest.raises(FileNotFoundError, match="not a local file"):
        jax_build_model("vit", dict(SMALL, torch_pretrained_weights=spec))


# -------------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("family", ["residualvit", "rankvit"])
@pytest.mark.parametrize("budget", [0.25, 1.0])
def test_flops_and_sparsity_match_jax(family, budget):
    """compute_flops / sparsity_per_module on the same weights and batch:
    rtol 1e-6 (fp32 means of the same masks)."""
    jm, pm = _twins(family)
    x = _images(4)
    got_flops, got_params = compute_flops(pm, torch.tensor(x), budget=budget)
    want_flops, want_params = jax_flops.compute_flops(jm, jax.numpy.asarray(x), budget=budget)
    assert got_params == want_params
    np.testing.assert_allclose(got_flops, want_flops, rtol=1e-6)
    got = sparsity_per_module(pm, torch.tensor(x), budget=budget)
    want = jax_flops.sparsity_per_module(jm, jax.numpy.asarray(x), budget=budget)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_introspection_matches_jax():
    """The seven introspection helpers on the same weights and inputs:
    expert counts, ranked layers, learned thresholds, the per-layer masks
    (plain and incremental, 1e-6) and their kept shares, the gating
    probabilities' layers."""
    from peekvit_tpu.utils import introspection as jax_intro
    from peekvit_torch.utils import introspection as intro

    x = _images(4)
    jm, pm = _twins("moevit")
    assert intro.get_moes(pm) == jax_intro.get_moes(jm.module)
    with torch.no_grad():
        got = intro.get_gating_probs(pm(torch.tensor(x))[1])
    assert list(got) == list(jax_intro.get_gating_probs(jm(jax.numpy.asarray(x))[1]))
    jm, pm = _twins("rankvit")
    assert intro.get_ranking_layers(pm) == jax_intro.get_ranking_layers(jm.module)
    jm, pm = _twins("residualvit")
    assert intro.get_learned_thresholds(pm) == jax_intro.get_learned_thresholds(jm.params)
    with torch.no_grad():
        aux = pm(torch.tensor(x), budget=0.5)[1]
    jaux = jm(jax.numpy.asarray(x), budget=0.5)[1]
    for incremental in (False, True):
        got = intro.get_forward_masks(aux, incremental)
        want = jax_intro.get_forward_masks(jaux, incremental)
        assert list(got) == list(want) and got
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    got, want = intro.sparsity_per_layer(aux), jax_intro.sparsity_per_layer(jaux)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-6)
