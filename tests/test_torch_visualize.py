"""The port's plots (``peekvit_torch/utils/visualize.py``) against the JAX
package's (``peekvit_tpu/utils/visualize.py``), on the CPU: the arrays each
plot draws (the mask grids and their dataset distribution, the MoE expert
maps, the per-layer class tokens, their distances and the token norms, the
reconstructions, and the PCA coordinates against sklearn's up to each
component's sign) equal JAX's at 2e-4 (the masks exactly); every function
writes its PNG; importing the module does not import matplotlib; and the
entry points draw: ``cli.train training.plot_masks_every``,
``cli.train_img_reconstruction``'s reconstructions, ``cli.test``'s recap and
cumulative plots, ``cli.create_mask_plots`` and
``cli.create_cls_token_plots``, with one printed line where matplotlib is
missing. Toy sizes (2 layers, d 32, 16 px), weights carried to JAX through
``params_to_jax``, images from numpy with a seed."""

import functools
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.utils import introspection as jintro
from peekvit_tpu.utils import visualize as jviz
from peekvit_torch import build_model
from peekvit_torch.cli import create_cls_token_plots as cli_cls
from peekvit_torch.cli import create_mask_plots as cli_masks
from peekvit_torch.cli import test as cli_test
from peekvit_torch.cli import train as cli_train
from peekvit_torch.cli import train_img_reconstruction as cli_recon
from peekvit_torch.models.adapters import params_to_jax
from peekvit_torch.utils import visualize as viz

BASE = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5)
RESIDUAL = dict(BASE, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
                gate_bias=0.0, add_budget_token="learnable")
MODELS = {
    "vit": BASE,
    "rankvit": dict(BASE, rankvit_layers=[1]),
    "residualvit": RESIDUAL,
    "encdecresidualvit": dict(RESIDUAL, decoder_num_layers=1, decoder_num_heads=2,
                              decoder_mlp_dim=64),
    "maevit": dict(BASE, mask_ratio=0.25, decoder_hidden_dim=32, decoder_mlp_dim=64,
                   num_decoder_layers=1, num_decoder_heads=2),
    "moevit": dict(BASE, mlp_moes=[1, 3], attn_moes=[2, 1]),
}
TOL = 2e-4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed=0, n=3):
    return list(np.random.default_rng(seed).normal(size=(n, 16, 16, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(port model, JAX model) on the same seeded weights; the gates biased
    so that the masks keep some patches and drop others."""
    args = MODELS[name]
    tm = build_model(name, args, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for key, p in tm.named_parameters():
            if key == "head.kernel" or "residual_gate" in key:
                p.copy_(torch.randn(p.shape, generator=gen) * (3.0 if "gate" in key else 0.2))
    tree = jax.tree.map(jnp.asarray, params_to_jax(tm))
    jm = JaxModel(module=resolve_model_class(name)(**args), params=tree, model_class=name,
                  model_args=args)
    return tm, jm


class _JitApply:
    """A JAX model whose module's ``apply`` (the capture run of
    ``extract_intermediates`` included) is jitted: the same function,
    compiled once instead of op by op."""

    def __init__(self, jm):
        self._jm = jm
        module = jm.module

        @functools.partial(jax.jit, static_argnames=("train", "capture"))
        def apply(variables, x, budget, noise_value, rngs, train, capture):
            kw = dict(capture_intermediates=True, mutable=["intermediates"]) if capture else {}
            return module.apply(variables, x, train=train, budget=budget,
                                noise_value=noise_value, rngs=rngs, **kw)

        class _Module:
            def __getattr__(self, name):
                return getattr(module, name)

            def apply(self, variables, x, *, train=False, budget=None, noise_value=None,
                      rngs=None, capture_intermediates=False, mutable=()):
                assert list(mutable) == (["intermediates"] if capture_intermediates else [])
                return apply(variables, x, budget, noise_value, rngs, train,
                             capture_intermediates)

        self.module = _Module()

    def __getattr__(self, name):
        return getattr(self._jm, name)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- drawn arrays


@pytest.mark.parametrize("hard, skip", [(True, ()), (False, (0,))])
def test_mask_grids_match_jax(hard, skip):
    """The incremental per-layer masks of plot_masked_images, as JAX draws
    them (``_mask_to_grid`` of ``get_forward_masks(aux, incremental=True)``)."""
    tm, jm = _pair("residualvit")
    images = _images(1)
    got = viz.masked_image_grids(tm, images, hard=hard, skip_layers=skip, budget=0.5)
    pps = 16 // 4
    kept = []
    for img, grids in zip(images, got):
        _, aux = jm(jnp.asarray(img)[None], budget=0.5)
        masks = jintro.get_forward_masks(aux, incremental=True)
        want = {n: jviz._mask_to_grid(np.asarray(m[0]), pps)
                for i, (n, m) in enumerate(masks.items()) if i not in skip}
        assert list(grids) == list(want)
        for name in want:
            w = np.ceil(want[name]) if hard else want[name]
            if hard:
                np.testing.assert_array_equal(grids[name], w)
            else:
                _close(grids[name], w)
            kept.append(float(np.ceil(w).mean()))
    assert 0.0 < min(kept) < 1.0  # some patches kept, some dropped


def test_mask_distribution_matches_jax():
    tm, jm = _pair("residualvit")
    dataset = [(img, 0) for img in _images(2, n=4)]
    got = viz.mask_distribution(tm, dataset, num_images=3, budget=0.5)
    acc = {}
    for img, _ in dataset[:3]:
        _, aux = jm(jnp.asarray(img)[None], budget=0.5)
        for name, m in jintro.get_forward_masks(aux, incremental=True).items():
            acc[name] = acc.get(name, 0) + jviz._mask_to_grid(np.ceil(np.asarray(m[0])), 4)
    assert list(got) == list(acc)
    for name in acc:
        np.testing.assert_array_equal(got[name], acc[name] / 3)


@pytest.mark.parametrize("name, budget", [("vit", None), ("rankvit", 0.5),
                                          ("residualvit", 0.5)])
def test_class_token_tools_match_jax(name, budget):
    """_per_layer_tokens and what plot_class_tokens,
    plot_class_tokens_distances and plot_token_norms draw of them."""
    tm, jm = _pair(name)
    img = _images(3, n=1)[0]
    want = jviz._per_layer_tokens(_JitApply(jm), jnp.asarray(img)[None], budget)
    got = viz._per_layer_tokens(tm, img[None], budget)
    assert list(got) == list(want) == ["layer_0", "layer_1"]
    for layer in want:
        _close(got[layer], want[layer])
    ncls = tm.num_class_tokens
    rows = viz.class_token_matrix(tm, img, budget)
    for layer, v in want.items():
        _close(rows[layer], np.asarray(v)[0, :ncls].reshape(-1))
    toks = np.stack([np.asarray(v)[0, :ncls].mean(axis=0) for v in want.values()])
    _close(viz.class_token_distances(tm, img, budget),
           np.sqrt(((toks[:, None] - toks[None]) ** 2).sum(-1)))
    norms = viz.token_norms(tm, img, budget)
    for layer, v in want.items():
        _close(norms[layer], np.sort(np.linalg.norm(np.asarray(v)[0], axis=-1))[::-1])


@pytest.mark.parametrize("name", ["encdecresidualvit", "maevit"])
def test_reconstructions_match_jax(name):
    """What plot_reconstructed_images draws: the reconstruction, and the
    EncDec's mask."""
    tm, jm = _pair(name)
    images = _images(4, n=2)
    budget = 0.5 if name == "encdecresidualvit" else None
    got = viz.reconstruction_arrays(tm, images, budget)
    for img, (recon, mask) in zip(images, got):
        out, _ = jm(jnp.asarray(img)[None], budget=budget)
        _close(recon, np.asarray(out[1][0]))
        if len(out) > 2:
            _close(mask, np.asarray(out[2][0]))
        else:
            assert mask is None


def test_moe_expert_maps_match_jax():
    tm, jm = _pair("moevit")
    images = _images(5, n=2)
    for img, grids in zip(images, viz.moe_expert_assignments(tm, images)):
        _, aux = jm(jnp.asarray(img)[None])
        want = {}
        for name, v in jintro.get_gating_probs(aux).items():
            sub = v if isinstance(v, dict) else {"": v}
            for kind, probs in sub.items():
                if probs is not None and probs.shape[-1] > 1:
                    assign = np.argmax(np.asarray(probs[0]), axis=-1)
                    want[f"{name}/{kind}".rstrip("/")] = assign[-16:].reshape(4, 4)
        assert list(grids) == list(want) and len(want) == 2
        for key in want:
            np.testing.assert_array_equal(grids[key][0], want[key])


@pytest.mark.parametrize("rows", [2, 7, 60])
def test_expert_pca_matches_sklearn(rows):
    """numpy's SVD with sklearn's centring: sklearn's PCA coordinates, each
    component up to its sign (the first two columns at two rows or fewer,
    as JAX draws them)."""
    from sklearn.decomposition import PCA

    emb = np.random.default_rng(rows).normal(size=(rows, 3, 8)).astype(np.float32)
    emb[..., 0] *= 4.0
    got = viz.expert_pca_points(emb)
    flat = emb.reshape(-1, 8)
    want = PCA(n_components=2).fit_transform(flat)
    assert got.shape == want.shape == (rows * 3, 2)
    for j in range(2):
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        _close(got[:, j] * sign, want[:, j], 1e-4)


# ------------------------------------------------------------- the PNGs


def _draw(fn, tmp_path):
    """Call ``fn`` with a path under tmp_path; the PNGs it wrote."""
    tm_r, _ = _pair("residualvit")
    tm_v, _ = _pair("vit")
    tm_e, _ = _pair("encdecresidualvit")
    tm_m, _ = _pair("moevit")
    imgs = [(img, 0) for img in _images(6, n=2)]
    p = str(tmp_path / "plot.png")
    d = str(tmp_path / "dir")
    calls = {
        "plot_budget_vs_acc": lambda: viz.plot_budget_vs_acc([0.5, 1.0], [0.4, 0.6], p, "run"),
        "plot_flops_vs_acc": lambda: viz.plot_flops_vs_acc([1e9, 2e9], [0.4, 0.6], p),
        "plot_budget_vs_throughput": lambda: viz.plot_budget_vs_throughput([0.5, 1.0],
                                                                           [900.0, 500.0], p),
        "plot_cumulative_runs": lambda: viz.plot_cumulative_runs(
            {"a": {"flops": [1e9, 2e9], "accuracies": [0.4, 0.6]},
             "b": {"flops": [1e9, 3e9], "accuracies": [0.3, 0.7]}}, "flops", "accuracies", p,
            run_colors={"a": "red"}),
        "plot_budget_noise_grid": lambda: viz.plot_budget_noise_grid(
            {0.5: {0.0: 0.4, 10.0: 0.3}, 1.0: {0.0: 0.6, 10.0: 0.5}}, p),
        "plot_masked_images": lambda: viz.plot_masked_images(tm_r, imgs, budget=0.5, save_dir=d),
        "plot_masked_images_overlay": lambda: viz.plot_masked_images(
            tm_r, imgs, lambda a: a * 0.2 + 0.5, overlay=True, budget=0.5, save_dir=d),
        "img_mask_distribution": lambda: viz.img_mask_distribution(tm_r, imgs, 2, 0.5, p),
        "plot_moe_expert_maps": lambda: viz.plot_moe_expert_maps(tm_m, imgs, save_dir=d),
        "plot_moe_expert_pca": lambda: viz.plot_moe_expert_pca(
            {"e0": np.ones((4, 3)) * np.arange(3), "e1": np.random.default_rng(0).normal(
                size=(9, 3))}, p),
        "plot_class_tokens": lambda: viz.plot_class_tokens(tm_v, imgs[0][0], save_path=p),
        "plot_class_tokens_distances": lambda: viz.plot_class_tokens_distances(
            tm_r, imgs[0][0], 0.5, p),
        "plot_token_norms": lambda: viz.plot_token_norms(tm_v, imgs[0][0], save_path=p),
        "plot_reconstructed_images": lambda: viz.plot_reconstructed_images(
            tm_e, imgs, budget=0.5, save_dir=d),
    }
    out = calls[fn]()
    return out if isinstance(out, list) else [out]


@pytest.mark.parametrize("fn", [
    "plot_budget_vs_acc", "plot_flops_vs_acc", "plot_budget_vs_throughput",
    "plot_cumulative_runs", "plot_budget_noise_grid", "plot_masked_images",
    "plot_masked_images_overlay", "img_mask_distribution", "plot_moe_expert_maps",
    "plot_moe_expert_pca", "plot_class_tokens", "plot_class_tokens_distances",
    "plot_token_norms", "plot_reconstructed_images"])
def test_each_plot_writes_its_png(fn, tmp_path):
    paths = _draw(fn, tmp_path)
    assert paths and all(os.path.getsize(path) > 0 and path.endswith(".png") for path in paths)
    with open(paths[0], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("name", ["peekvit_torch.utils.visualize", "peekvit_torch.cli.train",
                                  "peekvit_torch.cli.train_img_reconstruction",
                                  "peekvit_torch.cli.test", "peekvit_torch.cli.create_mask_plots",
                                  "peekvit_torch.cli.create_cls_token_plots"])
def test_import_does_not_import_matplotlib(name, monkeypatch):
    """Each module imports afresh where any import of matplotlib raises."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, name)
    assert importlib.import_module(name).__name__ == name


# ------------------------------------------------------------- the entry points

TINY = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=32",
        "dataset.val_size=16", "training.train_batch_size=16", "training.eval_batch_size=16",
        "training.num_epochs=0", "training.eval_every=1", "training.checkpoint_every=1",
        "training.num_workers=0", "model.patch_size=8", "model.num_layers=2",
        "model.hidden_dim=32", "model.mlp_dim=64", "model.num_heads=2",
        "model.residual_layers=['attention+mlp','attention+mlp']"]
TEST = ["dataset=synthetic", "dataset.image_size=16", "dataset.train_size=32",
        "dataset.val_size=16", "test.test_batch_size=16", "test.num_workers=0",
        "test.budgets=[0.5,1.0]", "test.num_images=2", "test.skip_layers_for_masks=[]"]


@pytest.fixture(scope="module")
def residual_run(tmp_path_factory):
    """A tiny ResidualViT trained one epoch by cli.train with
    plot_masks_every=1 at two validation budgets."""
    tmp = tmp_path_factory.mktemp("viz")
    torch.set_num_threads(1)
    res = cli_train.main([f"workspace={tmp}", "experiment_name=res", "--device", "cpu",
                          "model=residualvit", "training.plot_masks_every=1",
                          "training.num_images_to_plot=2",
                          "training.val_budgets=[0.5,1.0]"] + TINY)[0]
    return tmp, res["experiment_dir"]


def test_cli_train_plots_masks(residual_run):
    _, exp = residual_run
    for b in (0.5, 1.0):
        d = os.path.join(exp, "images", "epoch_0", f"budget_{b}")
        assert sorted(os.listdir(d)) == ["image_0.png", "image_1.png"]


def test_cli_train_reconstruction_plots(tmp_path):
    res = cli_recon.main([f"workspace={tmp_path}", "experiment_name=rec", "--device", "cpu",
                          "model=residualvitwithdecoder", "model.decoder_hidden_dim=32",
                          "model.decoder_num_layers=1", "model.decoder_num_heads=2",
                          "model.decoder_mlp_dim=64", "training.plot_masks_every=1",
                          "training.num_images_to_plot=2"] + TINY)
    d = os.path.join(res["experiment_dir"], "images", "epoch_0", "recon")
    assert sorted(os.listdir(d)) == ["recon_0.png", "recon_1.png"]


def test_cli_test_recap_and_cumulative_plots(residual_run, tmp_path):
    tmp, exp = residual_run
    other = os.path.join(tmp, "runs", "copy")
    if not os.path.exists(other):
        import shutil

        shutil.copytree(exp, other)
    out = cli_test.main([f"workspace={tmp_path}", "experiment_name=sweep", "--device", "cpu",
                         f"load_from=[{exp},{other}]", "test.cumulative_plot=true",
                         f"test.cumulative_plot_dir={tmp_path}/cum"] + TEST)
    assert set(out) == {exp, other}
    for d in (exp, other):
        files = set(os.listdir(os.path.join(d, "images")))
        assert {"budget_vs_acc.png", "flops_vs_acc.png", "budget_vs_throughput.png"} <= files
    assert {"cumulative_budget_vs_acc.png", "cumulative_flops_vs_acc.png",
            "cumulative_log.txt"} <= set(os.listdir(tmp_path / "cum"))


def test_cli_test_noise_grid(residual_run, tmp_path):
    _, exp = residual_run
    cli_test.main([f"workspace={tmp_path}", "experiment_name=sweep", "--device", "cpu",
                   f"load_from={exp}", "noise=gaussian", "noise.layer=1",
                   "test.noises=[10.0,20.0]", "test.skip_flops_count=true"] + TEST)
    assert os.path.getsize(os.path.join(exp, "images", "budget_noise_grid.png")) > 0


def test_plot_entry_points(residual_run, capsys):
    tmp, exp = residual_run
    common = [f"workspace={tmp}", f"load_from={exp}", "--device", "cpu"] + TEST
    paths = cli_masks.main(common)
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
    assert os.path.isdir(os.path.join(exp, "images", "epoch_0", "budget_0.5"))
    paths = cli_cls.main(common)
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        f"{stem}_{i}.png" for stem in ("cls_tokens", "cls_distances", "token_norms")
        for i in range(2))
    assert "wrote 6 plots" in capsys.readouterr().out


def test_without_matplotlib_the_runs_print_one_line(residual_run, tmp_path, monkeypatch,
                                                   capsys):
    """matplotlib missing: cli.train skips its mask plots and cli.test its
    recap plots, each with one printed line, and both run on."""
    for mod in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tmp, exp = residual_run
    res = cli_train.main([f"workspace={tmp_path}", "experiment_name=nomp", "--device", "cpu",
                          "model=residualvit", "training.plot_masks_every=1",
                          "training.num_images_to_plot=1"] + TINY)[0]
    cli_test.main([f"workspace={tmp_path}", "experiment_name=sweep", "--device", "cpu",
                   f"load_from={res['experiment_dir']}", "test.skip_flops_count=true"] + TEST)
    printed = capsys.readouterr().out
    assert printed.count("visualize module unavailable; skipping mask plots") == 1
    assert "recap plots skipped: matplotlib is not installed" in printed
    assert not os.listdir(os.path.join(res["experiment_dir"], "images"))
