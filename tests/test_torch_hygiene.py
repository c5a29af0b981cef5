"""The port stands alone: no JAX import anywhere in peekvit_torch/ or
chip_smoke.py, and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "peekvit_tpu"}
SMALL = dict(image_size=32, patch_size=8, num_layers=1, num_heads=2,
             hidden_dim=32, mlp_dim=64, num_classes=5)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "peekvit_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10, files
    bad = {os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without device="cpu", build_model, InferenceEngine, Trainer,
    load_serving_bundle and the serving CLIs need a card and raise when
    there is none (decided here, not at import time)."""
    from peekvit_torch import InferenceEngine, Trainer, build_model
    from peekvit_torch import serving, serving_host
    from peekvit_torch.training.optim import AdamW

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("vit", SMALL)
    model = build_model("vit", SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, AdamW())
    assert Trainer(model, AdamW(), device="cpu").device == torch.device("cpu")
    path = serving.save_serving_bundle(
        InferenceEngine(model, compute_dtype=torch.float32, device="cpu"),
        str(tmp_path / "bundle"), np.zeros((2, 32, 32, 3), np.float32))
    for load in (lambda: serving.load_serving_bundle(path),
                 lambda: serving._main([path, str(tmp_path / "x.npy")]),
                 lambda: serving_host._main([path, "--port", "0"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()
    assert serving.load_serving_bundle(path, device="cpu").device == torch.device("cpu")


def test_import_builds_nothing():
    """Importing the port starts no nvcc and loads no kernel library."""
    from peekvit_torch.ops.cuda import _build

    assert _build._libs == {}
    assert _build.SOURCES == ("norm_rows", "gemm_bias_epilogue", "attn_scores_pv",
                              "attn_softmax_fwd", "attn_softmax_bwd", "ln_bwd_rows",
                              "quant_rows", "gemm_s8_epilogue", "arpe_tokens", "gemm_wgrad")
    assert set(_build._SIGNATURES) == set(_build.SOURCES)
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.CSRC, name + ".cu"))
