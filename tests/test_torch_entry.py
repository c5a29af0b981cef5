"""The port's entry points (``peekvit_torch.cli.train``,
``cli.train_img_reconstruction``, ``cli.test``) against the JAX package's
(``train/train.py``, ``validate/test.py``) on the CPU, at the tiny sizes
of tests/test_train_entry.py:17-36, driven by the repo's configs/.

- training: the port starts from JAX's seed-0 weights (a port checkpoint
  of them, through ``load_from``); SGD (the update is linear in the
  gradient, so last-bit differences stay last-bit); the per-epoch mean
  total loss agrees at rtol 1e-4, validation accuracy is equal, and the
  logs and checkpoints have the same keys and epochs;
- eval: the sweep's summary has JAX's keys and values (accuracy up to the
  images whose JAX top-2 margin is under the bf16 engines' tolerance);
- preemption: SIGTERM raised in-process after the second step;
- every option the port refuses, and the card as the default device.
"""

import ast
import importlib.util
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from peekvit_torch.cli import test as cli_test
from peekvit_torch.cli import train as cli_train
from peekvit_torch.cli import train_img_reconstruction as cli_recon
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.models.registry import build_model
from peekvit_torch.training.trainer import Trainer
from peekvit_torch.utils.checkpoint import get_checkpoint_path, load_state, save_state

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=64",
        "dataset.val_size=32", "training.train_batch_size=16", "training.eval_batch_size=16",
        "training.num_epochs=2", "training.eval_every=2", "training.checkpoint_every=2",
        "training.num_workers=0", "model.patch_size=8", "model.num_layers=2",
        "model.hidden_dim=32", "model.mlp_dim=64", "model.num_heads=2"]
PARITY = ["optimizer=sgd", "training.fused=false"]
TEST = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=64",
        "dataset.val_size=32", "test.test_batch_size=16", "test.num_workers=0"]
# the bf16 engines (port and JAX) against each other: an image whose fp32
# top-2 logit margin is above this cannot change its top-1
MARGIN_TOL = 5e-2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these shapes are tiny, and a shared machine's
    thread pool costs more than it gives."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_entry(path: str, name: str):
    """A JAX entry script as a module of its own name (validate/test.py
    would otherwise shadow the standard library's ``test``)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


def _log(exp):
    with open(os.path.join(exp, "log.txt")) as f:
        return [ast.literal_eval(line) for line in f]


def _epoch_means(lines, steps_per_epoch):
    losses = [line["train/total_loss"] for line in lines if "train/total_loss" in line]
    return [float(np.mean(losses[i:i + steps_per_epoch]))
            for i in range(0, len(losses), steps_per_epoch)]


def _keys(lines):
    return set().union(*(line.keys() for line in lines))


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    """The JAX CLI's run (its seed-0 init) and the port CLI's run from a
    port checkpoint of those weights, on the same overrides."""
    tmp = tmp_path_factory.mktemp("parity")
    jax_train = _jax_entry("train/train.py", "jax_train_entry")
    jres = jax_train.main([f"workspace={tmp}/jax", "experiment_name=run"] + TINY + PARITY)[0]
    cfg = jax_train.load_config(os.path.join(REPO, "configs"), "train_config",
                                [f"workspace={tmp}/jax"] + TINY + PARITY)
    from peekvit_tpu.models.registry import build_model as jax_build_model

    model_cfg = jax_train.to_plain(cfg.model)
    cls = model_cfg.pop("_target_").rsplit(".", 1)[-1]
    jm = jax_build_model(cls, model_cfg, seed=0)
    init = params_from_jax(build_model(cls, model_cfg, device="cpu"),
                           jax.tree.map(np.asarray, jm.params))
    start = save_state(str(tmp / "init"), init)
    pres = cli_train.main([f"workspace={tmp}/port", "experiment_name=run",
                           f"load_from={start}", "--device", "cpu"] + TINY + PARITY)[0]
    return jres, pres, tmp


def test_training_matches_jax(parity_runs):
    jres, pres, _ = parity_runs
    jlines, plines = _log(jres["experiment_dir"]), _log(pres["experiment_dir"])
    assert _keys(plines) == _keys(jlines)
    steps = 64 // 16
    got, want = _epoch_means(plines, steps), _epoch_means(jlines, steps)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert pres["val_accuracy"] == jres["val_accuracy"]
    assert ([line["val/accuracy"] for line in plines if "val/accuracy" in line]
            == [line["val/accuracy"] for line in jlines if "val/accuracy" in line])
    for res in (jres, pres):
        assert sorted(os.listdir(os.path.join(res["experiment_dir"], "checkpoints"))) == [
            "epoch_000", "epoch_002"]
        assert os.path.isfile(os.path.join(res["experiment_dir"], "config.yaml"))


def test_eval_sweep_matches_jax(parity_runs, capsys):
    """cli.test on the port run's checkpoint against JAX's validate() on the
    same weights (params_to_jax): the same summary keys, accuracy up to the
    images whose JAX top-2 margin is under MARGIN_TOL, FLOPs at rtol 1e-6
    and the same sparsities."""
    _, pres, tmp = parity_runs
    exp = pres["experiment_dir"]
    summary = cli_test.main([f"workspace={tmp}/port", "experiment_name=eval",
                             f"load_from={exp}", "--device", "cpu"] + TEST)[exp]
    assert "eval path: fused InferenceEngine" in capsys.readouterr().out

    jax_test = _jax_entry("validate/test.py", "jax_validate_entry")
    from peekvit_tpu.models.registry import build_model as jax_build_model
    from peekvit_tpu.utils.config import instantiate, load_config

    model = load_state(get_checkpoint_path(exp), device="cpu")
    jm = jax_build_model(model.model_class, model.model_args, params=params_to_jax(model))
    cfg = load_config(os.path.join(REPO, "configs"), "test_config",
                      [f"workspace={tmp}/jax", "experiment_name=eval", f"load_from={exp}"] + TEST)
    dataset = instantiate(cfg.dataset)

    class Quiet:
        def log(self, metrics):
            pass

    want = jax_test.validate(jm, cfg, dataset, str(tmp / "jax_eval"), Quiet())
    assert set(summary) == set(want)
    for key in summary:
        assert set(summary[key]) == set(want[key]), key
    x = dataset.val_dataset.data
    logits = np.sort(np.asarray(jm(jax.numpy.asarray(x))[0]), axis=-1)
    undecided = int(np.sum(logits[:, -1] - logits[:, -2] < MARGIN_TOL))
    n = len(x)
    for b, by_noise in want["results_per_budget"].items():
        for nv, acc in by_noise.items():
            assert abs(summary["results_per_budget"][b][nv] - acc) * n <= undecided + 1e-9
    for b in want["flops"]:
        np.testing.assert_allclose(summary["flops"][b], want["flops"][b], rtol=1e-6)
    assert summary["sparsities_per_budget"] == want["sparsities_per_budget"]
    assert all(v > 0 for v in summary["timings_wall"].values())
    assert all(v > 0 for v in summary["timings_device"].values())


def test_residualvit_run_logs_jax_keys(tmp_path, capsys):
    """A ResidualViT with the mse regularizer, validated at two budgets, then
    swept by cli.test at three budgets with a retrofitted NoiseBlock: the
    keys JAX's run logs (tests/test_train_entry.py:65-90)."""
    res = cli_train.main([f"workspace={tmp_path}", "experiment_name=res", "--device", "cpu"]
                         + TINY + ["model=residualvit",
                                   "model.residual_layers=['attention+mlp','attention+mlp']",
                                   "loss=crossentropy_mse",
                                   "loss.additional_losses.mse.skip_layers=[]",
                                   "training.val_budgets=[0.5,1.0]",
                                   "scheduler=cosineannealing"])[0]
    keys = _keys(_log(res["experiment_dir"]))
    assert keys == {"train/total_loss", "train/classification_loss", "train/mse", "train/lr",
                    "budget_0.5/val/accuracy", "budget_0.5/val/loss",
                    "budget_1.0/val/accuracy", "budget_1.0/val/loss"}
    out = cli_test.main([f"workspace={tmp_path}", "experiment_name=sweep",
                         f"load_from={res['experiment_dir']}", "--device", "cpu",
                         "test.budgets=[0.25,0.5,1.0]", "noise=gaussian", "noise.layer=1",
                         "test.noises=[10.0]"] + TEST)[res["experiment_dir"]]
    printed = capsys.readouterr().out
    assert "eval path: fused InferenceEngine" in printed
    assert "recap plots skipped" in printed and "item 8 part 3" in printed
    assert set(out["results_per_budget"]) == {0.25, 0.5, 1.0}
    assert all(set(v) == {10.0} for v in out["results_per_budget"].values())
    assert set(out["sparsities_per_budget"][0.5]) == {"layer_0", "layer_1"}


def test_sigterm_checkpoints_and_auto_resume_completes(tmp_path, monkeypatch, capsys):
    """SIGTERM from inside the second train step (in-process, no race): the
    run stops after that step, writes one partial checkpoint with the
    optimizer state and returns; auto_resume restarts at that epoch (JAX
    train/train.py:121-132) with the optimizer state, and finishes."""
    overrides = [f"workspace={tmp_path}", "experiment_name=pre", "--device", "cpu",
                 "training.auto_resume=true", "optimizer=adam"] + TINY
    step = Trainer.train_step
    calls = []

    def train_step(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(Trainer, "train_step", train_step)
    hits = []

    def harness(signum, frame):
        hits.append(signum)

    outer = signal.signal(signal.SIGTERM, harness)
    try:
        first = cli_train.main(overrides)[0]
        assert hits == [signal.SIGTERM]  # the guard chained the handler before it
        assert signal.getsignal(signal.SIGTERM) is harness  # and put it back
    finally:
        signal.signal(signal.SIGTERM, outer)
    assert first["preempted"] and len(calls) == 2
    exp = first["experiment_dir"]
    path = get_checkpoint_path(exp)
    assert path.endswith("epoch_000")
    assert sorted(os.listdir(path)) == ["metadata.json", "opt_state.pt", "params.pt"]
    import json

    with open(os.path.join(path, "metadata.json")) as f:
        assert json.load(f)["partial"] is True
    second = cli_train.main(overrides)[0]
    printed = capsys.readouterr().out
    assert "auto_resume:" in printed and "optimizer state restored" in printed
    assert second["start_epoch"] == 0 and "preempted" not in second
    assert len(calls) == 2 + 3 * 4
    assert get_checkpoint_path(exp).endswith("epoch_002")


def test_reconstruction_run(tmp_path):
    """cli.train_img_reconstruction trains a tiny EncDec (encoder and decoder
    at one width): the reconstruction loss is logged and finite, and the
    checkpoint rebuilds the model."""
    res = cli_recon.main([f"workspace={tmp_path}", "experiment_name=rec", "--device", "cpu",
                          "model=residualvitwithdecoder",
                          "model.residual_layers=['attention+mlp','attention+mlp']",
                          "model.decoder_hidden_dim=32", "model.decoder_num_layers=1",
                          "model.decoder_num_heads=2", "model.decoder_mlp_dim=64"] + TINY)
    lines = _log(res["experiment_dir"])
    rec = [line["train/reconstruction_loss"] for line in lines
           if "train/reconstruction_loss" in line]
    assert len(rec) == 12 and np.isfinite(rec).all()
    assert "budget_1.0/val/accuracy" in _keys(lines)
    model = load_state(get_checkpoint_path(res["experiment_dir"]), device="cpu")
    assert model.model_class == "ResidualVisionTransformerWithDecoder"


@pytest.mark.parametrize("entry, overrides, item", [
    (cli_train, ["training.qat=true"], "item 8 part 2"),
    (cli_train, ["training.qat=static"], "item 8 part 2"),
    (cli_train, ["training.plot_masks_every=1"], "item 8 part 3"),
    (cli_train, ["+distributed=true"], "item 9"),
    (cli_recon, ["model=residualvitwithdecoder", "training.plot_masks_every=1"],
     "item 8 part 3"),
    (cli_test, ["test.export_bundle=/nonexistent/bundle"], "item 9"),
    (cli_test, ["test.tensor_parallel_devices=2"], "item 9"),
    (cli_test, ["+distributed=true"], "item 9"),
])
def test_not_ported_options_raise(tmp_path, entry, overrides, item):
    base = TEST if entry is cli_test else TINY
    with pytest.raises(NotImplementedError, match=item):
        entry.main([f"workspace={tmp_path}", "experiment_name=x", "--device", "cpu"]
                   + base + overrides)


@pytest.mark.parametrize("entry", [cli_train, cli_recon, cli_test])
def test_entry_points_need_a_card_unless_asked(tmp_path, monkeypatch, entry):
    """Without --device cpu and with no card, each CLI raises before it
    builds or reads anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.main([f"workspace={tmp_path}"] + (TEST if entry is cli_test else TINY))
    assert not os.path.exists(os.path.join(tmp_path, "runs"))
