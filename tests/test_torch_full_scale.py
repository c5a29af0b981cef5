"""ViT-B/16 @ 224 golden parity of the port's fp32 engine on the CPU,
without JAX compute: the seeded torch reference of tests/test_full_scale.py
-> convert_torch_state_dict (the JAX package's adapter, a numpy-level key
and layout map) -> params_from_jax -> the port's InferenceEngine, held
against the committed golden logits with the tolerance of
tests/test_full_scale.py:86-92 (2e-3 of the logit spread, equal argmax)."""

import os

import numpy as np
import torch

from peekvit_tpu.models.adapters import convert_torch_state_dict
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.models.adapters import params_from_jax
from tests.torch_reference import TorchViT

B16 = dict(image_size=224, patch_size=16, num_layers=12, num_heads=12,
           hidden_dim=768, mlp_dim=3072, num_classes=1000)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "vit_b16_golden_logits.npy")


def _make_torch_vit():  # as tests/test_full_scale.py:50-57
    torch.manual_seed(0)
    tm = TorchViT(**B16)
    with torch.no_grad():
        tm.head.weight.normal_(0, 0.02)
        tm.head.bias.zero_()
        tm.class_tokens.normal_(0, 0.02)
    return tm.eval()


def test_port_engine_matches_golden_logits_b16():
    tree = convert_torch_state_dict(_make_torch_vit().peekvit_state_dict())
    model = params_from_jax(build_model("vit", B16, device="cpu"), tree)
    x = np.random.default_rng(42).normal(size=(2, 224, 224, 3)).astype(np.float32)
    got = InferenceEngine(model, compute_dtype=torch.float32, device="cpu")(x).numpy()
    want = np.load(FIXTURE)
    spread = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-3 * max(spread, 1.0)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
