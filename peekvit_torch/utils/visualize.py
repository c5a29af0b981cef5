"""Plots of the port (counterpart of peekvit_tpu/utils/visualize.py): the
recap plots (budget, FLOPs and throughput against accuracy, multi-run
overlays, the budget x noise grid), the per-layer token masks and their
dataset distribution, the MoE expert maps and the PCA of expert
embeddings, the class-token tools (per-layer class tokens, their
distances, token norms) and the reconstruction triptychs. Every function
keeps JAX's name and arguments.

matplotlib (Agg backend) is imported where a plot is drawn, never when
this module is imported, so the module imports on a machine without it.
The data each plot draws is computed by a helper that returns numpy
arrays (``masked_image_grids``, ``mask_distribution``,
``moe_expert_assignments``, ``expert_pca_points``, ``class_token_matrix``,
``class_token_distances``, ``token_norms``, ``reconstruction_arrays``),
so that it can be held against JAX's. The PCA is numpy's SVD with
sklearn's centring and sign rule (``svd_flip``), the same function as
sklearn's ``PCA(n_components=2).fit_transform``. The models run through
their eval forward (``utils/flops_count.eval_forward``); the per-layer
tokens come from forward hooks, the counterpart of flax's
``capture_intermediates``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from peekvit_torch.utils.flops_count import eval_forward
from peekvit_torch.utils.introspection import get_forward_masks, get_gating_probs


def _plt():
    """matplotlib.pyplot on the Agg backend, imported on first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _savefig(fig, save_path: Optional[str]):
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, bbox_inches="tight", dpi=120)
        _plt().close(fig)
        return save_path
    return fig


def _image(item) -> np.ndarray:
    """The HWC image of a dataset item ((img, label) or an array)."""
    img = item[0] if isinstance(item, (tuple, list)) else item
    return np.asarray(img, dtype=np.float32)


def _shown(img: np.ndarray, denormalize) -> np.ndarray:
    return np.asarray(denormalize(np.asarray(img))) if denormalize else np.asarray(img)


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ----------------------------------------------------------- recap plots


def _line_plot(xs, ys, save_path, label, title, xlabel, ylabel, marker):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(xs, ys, marker=marker, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    if label:
        ax.legend()
    return _savefig(fig, save_path)


def plot_budget_vs_acc(budgets, accuracies, save_path=None, label=None,
                       title="Budget vs accuracy"):
    return _line_plot(budgets, accuracies, save_path, label, title, "budget",
                      "top-1 accuracy", "o")


def plot_flops_vs_acc(flops, accuracies, save_path=None, label=None,
                      title="FLOPs vs accuracy"):
    """``flops`` per image, drawn in GFLOPs."""
    return _line_plot(np.asarray(flops) / 1e9, accuracies, save_path, label, title,
                      "GFLOPs / image", "top-1 accuracy", "o")


def plot_budget_vs_throughput(budgets, images_per_sec, save_path=None, label=None,
                              title="Budget vs throughput"):
    return _line_plot(budgets, images_per_sec, save_path, label, title, "budget",
                      "images / second", "s")


def plot_cumulative_runs(runs: Dict[str, dict], x_key: str = "budgets",
                         y_key: str = "accuracies", save_path=None, run_colors=None,
                         title="Cumulative"):
    """Multi-run overlay; ``runs`` maps a run's name to {budgets / flops:
    [...], accuracies: [...]}."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for name, data in runs.items():
        xs = np.asarray(data[x_key], dtype=float)
        if x_key == "flops":
            xs = xs / 1e9
        ax.plot(xs, data[y_key], marker="o", label=name, color=(run_colors or {}).get(name))
    ax.set_xlabel("GFLOPs / image" if x_key == "flops" else x_key)
    ax.set_ylabel(y_key)
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend()
    return _savefig(fig, save_path)


def plot_budget_noise_grid(results: Dict[float, Dict[float, float]], save_path=None,
                           title="accuracy: budget x noise"):
    """Heatmap of ``results[budget][noise] = accuracy``."""
    plt = _plt()
    budgets = sorted(results)
    noises = sorted(next(iter(results.values())))
    grid = np.array([[results[b][n] for n in noises] for b in budgets])
    fig, ax = plt.subplots(figsize=(1.2 * len(noises) + 2, 0.8 * len(budgets) + 2))
    im = ax.imshow(grid, cmap="viridis", aspect="auto")
    ax.set_xticks(range(len(noises)), [f"{n:g}" for n in noises])
    ax.set_yticks(range(len(budgets)), [f"{b:g}" for b in budgets])
    ax.set_xlabel("noise")
    ax.set_ylabel("budget")
    ax.set_title(title)
    for i in range(len(budgets)):
        for j in range(len(noises)):
            ax.text(j, i, f"{grid[i, j]:.3f}", ha="center", va="center", color="w", fontsize=8)
    fig.colorbar(im)
    return _savefig(fig, save_path)


# ------------------------------------------------------------ mask plots


def _mask_to_grid(mask: np.ndarray, patches_per_side: int) -> np.ndarray:
    """(N_img, 1) image-token mask -> (P, P) grid (special tokens are not
    in the masks)."""
    m = np.asarray(mask).reshape(-1)[: patches_per_side * patches_per_side]
    return m.reshape(patches_per_side, patches_per_side)


def masked_image_grids(model, images: Sequence, hard: bool = True,
                       skip_layers: Sequence[int] = (),
                       budget: Optional[float] = None) -> List[Dict[str, np.ndarray]]:
    """Per image, the (P, P) grid of each layer's incremental token mask
    (``get_forward_masks(incremental=True)``), ceiled when ``hard``, the
    layers of ``skip_layers`` (by position) left out."""
    skip = set(int(s) for s in skip_layers)
    pps = model.image_size // model.patch_size
    out = []
    for item in images:
        _, aux = eval_forward(model, _image(item)[None], budget)
        masks = get_forward_masks(aux, incremental=True)
        grids = {}
        for i, (name, mask) in enumerate(masks.items()):
            if i in skip:
                continue
            grid = _mask_to_grid(_numpy(mask[0]), pps)
            grids[name] = np.ceil(grid) if hard else grid
        out.append(grids)
    return out


def plot_masked_images(model, images: Sequence, denormalize=None, hard: bool = True,
                       skip_layers: Sequence[int] = (), overlay: bool = False,
                       masked_region_color: str = "lightsteelblue",
                       budget: Optional[float] = None, save_dir: Optional[str] = None) -> List:
    """Per image, the input beside each layer's incremental token mask, as a
    heatmap or as a colour overlay of the dropped patches; one
    ``image_{i}.png`` per image under ``save_dir``."""
    plt = _plt()
    import matplotlib

    pps = model.image_size // model.patch_size
    rgba_masked = np.asarray(matplotlib.colors.to_rgba(masked_region_color))
    outputs = []
    all_grids = masked_image_grids(model, images, hard, skip_layers, budget)
    for idx, (item, grids) in enumerate(zip(images, all_grids)):
        shown = np.clip(_shown(_image(item), denormalize), 0, 1)
        ncols = len(grids) + 1
        fig, axes = plt.subplots(1, ncols, figsize=(2.2 * ncols, 2.4))
        axes = np.atleast_1d(axes)
        axes[0].imshow(shown)
        axes[0].set_title("input", fontsize=8)
        axes[0].axis("off")
        for ax, (name, grid) in zip(axes[1:], grids.items()):
            if overlay:
                up = np.kron(grid, np.ones((shown.shape[0] // pps, shown.shape[1] // pps)))[
                    : shown.shape[0], : shown.shape[1]]
                img = shown.copy()
                dropped = up < 0.5
                img[dropped] = 0.6 * rgba_masked[:3] + 0.4 * img[dropped]
                ax.imshow(img)
            else:
                ax.imshow(grid, cmap="viridis", vmin=0, vmax=1)
            ax.set_title(name, fontsize=8)
            ax.axis("off")
        outputs.append(_savefig(fig, os.path.join(save_dir, f"image_{idx}.png"))
                       if save_dir else fig)
    return outputs


def mask_distribution(model, dataset, num_images: int = 100,
                      budget: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Per layer, the mean over the first ``num_images`` images of the
    dataset of the ceiled incremental mask at each patch position."""
    pps = model.image_size // model.patch_size
    acc: Dict[str, np.ndarray] = {}
    n = min(num_images, len(dataset))
    for i in range(n):
        _, aux = eval_forward(model, _image(dataset[i])[None], budget)
        for name, m in get_forward_masks(aux, incremental=True).items():
            acc[name] = acc.get(name, 0) + _mask_to_grid(np.ceil(_numpy(m[0])), pps)
    return {name: g / n for name, g in acc.items()}


def img_mask_distribution(model, dataset, num_images: int = 100,
                          budget: Optional[float] = None, save_path: Optional[str] = None):
    """The dataset-level keep share per patch position, one panel a layer."""
    plt = _plt()
    dist = mask_distribution(model, dataset, num_images, budget)
    fig, axes = plt.subplots(1, len(dist), figsize=(2.2 * len(dist), 2.4))
    for ax, (name, g) in zip(np.atleast_1d(axes), dist.items()):
        im = ax.imshow(g, cmap="viridis", vmin=0, vmax=1)
        ax.set_title(name, fontsize=8)
        ax.axis("off")
    fig.colorbar(im, ax=axes, shrink=0.8)
    return _savefig(fig, save_path)


# -------------------------------------------------------------- MoE plots


def moe_expert_assignments(model, images: Sequence) -> List[Dict[str, np.ndarray]]:
    """Per image, for each gate with more than one expert
    (``layer_i/attn`` / ``layer_i/mlp``), the (P, P) grid of the expert
    each image token routes to."""
    pps = model.image_size // model.patch_size
    out = []
    for item in images:
        _, aux = eval_forward(model, _image(item)[None])
        grids = {}
        for name, v in get_gating_probs(aux).items():
            sub = v if isinstance(v, dict) else {"": v}
            for kind, probs in sub.items():
                if probs is not None and probs.shape[-1] > 1:
                    assign = np.argmax(_numpy(probs[0]), axis=-1)
                    grids[f"{name}/{kind}".rstrip("/")] = (
                        assign[-pps * pps:].reshape(pps, pps), int(probs.shape[-1]))
        out.append(grids)
    return out


def plot_moe_expert_maps(model, images: Sequence, denormalize=None,
                         save_dir: Optional[str] = None):
    """Per image, the map of the expert each token routes to, one panel a
    gate; ``experts_{i}.png`` under ``save_dir``."""
    plt = _plt()
    outputs = []
    for idx, (item, grids) in enumerate(zip(images, moe_expert_assignments(model, images))):
        shown = _shown(_image(item), denormalize)
        ncols = len(grids) + 1
        fig, axes = plt.subplots(1, ncols, figsize=(2.2 * ncols, 2.4))
        axes = np.atleast_1d(axes)
        axes[0].imshow(np.clip(shown, 0, 1))
        axes[0].axis("off")
        axes[0].set_title("input", fontsize=8)
        for ax, (name, (grid, experts)) in zip(axes[1:], grids.items()):
            ax.imshow(grid, cmap="tab10", vmin=0, vmax=max(9, experts - 1))
            ax.set_title(name, fontsize=8)
            ax.axis("off")
        outputs.append(_savefig(fig, os.path.join(save_dir, f"experts_{idx}.png"))
                       if save_dir else fig)
    return outputs


def expert_pca_points(emb) -> np.ndarray:
    """(M, 2): the rows of ``emb`` (flattened to (M, D)) on their first two
    principal components, sklearn's ``PCA(n_components=2).fit_transform``
    (centred, full SVD, ``svd_flip``'s signs: each component's largest
    |loading| positive); the first two coordinates when M <= 2."""
    emb = np.asarray(emb)
    emb = emb.reshape(-1, emb.shape[-1])
    if emb.shape[0] <= 2:
        return emb[:, :2]
    x = emb.astype(np.float64) - emb.mean(axis=0)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    u = u * np.sign(vt[np.arange(vt.shape[0]), np.argmax(np.abs(vt), axis=1)])
    return (u[:, :2] * s[:2]).astype(emb.dtype)


def plot_moe_expert_pca(expert_embeddings: Dict[str, np.ndarray],
                        save_path: Optional[str] = None):
    """PCA scatter of each expert's token embeddings."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4.5))
    for name, emb in expert_embeddings.items():
        pts = expert_pca_points(emb)
        ax.scatter(pts[:, 0], pts[:, 1], s=8, alpha=0.6, label=name)
    ax.legend(fontsize=7)
    ax.set_title("expert embeddings (PCA)")
    return _savefig(fig, save_path)


# -------------------------------------------------------- class-token tools


def extract_intermediates(model, x, budget=None) -> Dict[str, np.ndarray]:
    """Every submodule's first output that is a (B, N, D) token array (of a
    tuple output, its first element), by its "/"-joined module path: the
    counterpart of flax's ``capture_intermediates`` over the eval forward."""
    flat: Dict[str, np.ndarray] = {}

    def hook(name):
        def fn(module, args, out):
            if isinstance(out, tuple):
                out = out[0] if out else None
            if isinstance(out, torch.Tensor) and out.dim() == 3 and name not in flat:
                flat[name] = _numpy(out)
        return fn

    handles = [m.register_forward_hook(hook(n.replace(".", "/")))
               for n, m in model.named_modules() if n]
    try:
        eval_forward(model, x, budget)
    finally:
        for h in handles:
            h.remove()
    return flat


def _per_layer_tokens(model, x, budget=None) -> Dict[str, np.ndarray]:
    """One token array per encoder layer: of the captures under a
    ``layers_{i}`` path whose feature width is the hidden width, the
    shortest path."""
    d = model.hidden_dim
    by_layer: Dict[int, tuple] = {}
    for k, v in extract_intermediates(model, x, budget).items():
        m = re.search(r"layers?_(\d+)", k)
        if m is None or v.shape[-1] != d:
            continue
        i = int(m.group(1))
        if i not in by_layer or len(k) < len(by_layer[i][0]):
            by_layer[i] = (k, v)
    return {f"layer_{i}": v for i, (_, v) in sorted(by_layer.items())}


def class_token_matrix(model, img, budget=None) -> Dict[str, np.ndarray]:
    """{layer: (num_class_tokens * D,)}: each layer's class tokens."""
    layers = _per_layer_tokens(model, np.asarray(img, np.float32)[None], budget)
    ncls = getattr(model, "num_class_tokens", 1)
    return {name: v[0, :ncls].reshape(-1) for name, v in layers.items()}


def class_token_distances(model, img, budget=None) -> np.ndarray:
    """(L, L): the L2 distance between the layers' mean class tokens."""
    layers = _per_layer_tokens(model, np.asarray(img, np.float32)[None], budget)
    ncls = getattr(model, "num_class_tokens", 1)
    toks = np.stack([v[0, :ncls].mean(axis=0) for v in layers.values()])
    return np.sqrt(((toks[:, None] - toks[None]) ** 2).sum(-1))


def token_norms(model, img, budget=None) -> Dict[str, np.ndarray]:
    """{layer: every token's L2 norm, sorted descending}."""
    layers = _per_layer_tokens(model, np.asarray(img, np.float32)[None], budget)
    return {name: np.sort(np.linalg.norm(v[0], axis=-1))[::-1] for name, v in layers.items()}


def plot_class_tokens(model, img, budget=None, save_path=None):
    """Each layer's class-token values as a heatmap row."""
    plt = _plt()
    rows = class_token_matrix(model, img, budget)
    mat = np.stack(list(rows.values()))
    fig, ax = plt.subplots(figsize=(8, 0.4 * len(mat) + 1.5))
    im = ax.imshow(mat, aspect="auto", cmap="coolwarm")
    ax.set_yticks(range(len(rows)), list(rows), fontsize=6)
    ax.set_xlabel("class-token features")
    fig.colorbar(im)
    return _savefig(fig, save_path)


def plot_class_tokens_distances(model, img, budget=None, save_path=None):
    """The pairwise distances of the layers' class tokens as a heatmap."""
    plt = _plt()
    d = class_token_distances(model, img, budget)
    fig, ax = plt.subplots(figsize=(5, 4.5))
    im = ax.imshow(d, cmap="magma")
    ax.set_xticks(range(len(d)), range(len(d)))
    ax.set_yticks(range(len(d)), range(len(d)))
    ax.set_title("class-token distances across layers")
    fig.colorbar(im)
    return _savefig(fig, save_path)


def plot_token_norms(model, img, budget=None, save_path=None):
    """Each layer's sorted token norms: the signal RankViT ranks by."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, norms in token_norms(model, img, budget).items():
        ax.plot(norms, label=name, alpha=0.8)
    ax.set_xlabel("token rank")
    ax.set_ylabel("L2 norm")
    ax.legend(fontsize=6)
    ax.set_title("token norms per layer")
    return _savefig(fig, save_path)


# --------------------------------------------------------- reconstruction


def reconstruction_arrays(model, images: Sequence, budget: Optional[float] = None) -> List:
    """Per image (reconstruction HWC, mask or None) of a model whose
    forward returns (logits, recon[, mask])."""
    out = []
    for item in images:
        res, _ = eval_forward(model, _image(item)[None], budget)
        out.append((_numpy(res[1][0]), _numpy(res[2][0]) if len(res) > 2 else None))
    return out


def plot_reconstructed_images(model, images: Sequence, denormalize=None,
                              budget: Optional[float] = None, save_dir: Optional[str] = None):
    """input | reconstruction | mask triptychs; ``recon_{i}.png`` under
    ``save_dir``."""
    plt = _plt()
    outputs = []
    for idx, (item, (recon, rmask)) in enumerate(
            zip(images, reconstruction_arrays(model, images, budget))):
        shown = _shown(_image(item), denormalize)
        recon_shown = np.asarray(denormalize(recon)) if denormalize else recon
        ncols = 3 if rmask is not None else 2
        fig, axes = plt.subplots(1, ncols, figsize=(2.4 * ncols, 2.6))
        axes[0].imshow(np.clip(shown, 0, 1))
        axes[0].set_title("input", fontsize=8)
        axes[1].imshow(np.clip(recon_shown, 0, 1))
        axes[1].set_title("reconstruction", fontsize=8)
        if rmask is not None:
            axes[2].imshow(rmask.squeeze(), cmap="viridis", vmin=0, vmax=1)
            axes[2].set_title("mask", fontsize=8)
        for ax in axes:
            ax.axis("off")
        outputs.append(_savefig(fig, os.path.join(save_dir, f"recon_{idx}.png"))
                       if save_dir else fig)
    return outputs
