"""The port's model and InferenceEngine against the JAX package's, on the
CPU: the same weights (a seeded JAX tree loaded with params_from_jax) and
the same numpy images go through both. JAX runs as its own tests run it
(``interpret=True``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.inference import prepare_engine_params, vit_forward_fused, vit_forward_plain
from peekvit_torch.models.adapters import module_params, params_from_jax, params_to_jax

SMALL = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
             hidden_dim=64, mlp_dim=128, num_classes=7)


def _pair(args, seed, head_key):
    """A seeded JAX model with a randomised head, and the port's model
    holding the same weights."""
    jm = jax_build_model("vit", args, seed=seed)
    jm.params["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.key(head_key), jm.params["head"]["kernel"].shape)
    tree = jax.tree.map(np.asarray, jm.params)
    tm = params_from_jax(build_model("vit", args, device="cpu"), tree)
    return jm, tm, tree


@pytest.fixture(scope="module", params=[(1, 0), (2, 3)], ids=["cls1", "cls2_reg3"])
def fp32_pair(request):
    """The tests/test_inference.py:12-34 configs, both engines in fp32."""
    c, r = request.param
    jm, tm, tree = _pair(dict(SMALL, num_class_tokens=c, num_registers=r), 3, 9)
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    jax_logits = np.asarray(JaxEngine(jm, compute_dtype=jnp.float32, interpret=True)(
        jnp.asarray(x)))
    return jm, tm, tree, x, jax_logits


def test_engine_fp32_matches_jax_engine(fp32_pair):
    """fp32 at 2e-4, the JAX engine's own tolerance against linen."""
    _, tm, _, x, want = fp32_pair
    got = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _forward(tm, params, x, fused_mlp):
    return vit_forward_fused(
        params, torch.from_numpy(x), patch_size=tm.patch_size, num_heads=tm.num_heads,
        num_class_tokens=tm.num_class_tokens, num_registers=tm.num_registers,
        compute_dtype=torch.float32, fused_mlp=fused_mlp)


def test_split_engine_fp32_matches_jax_engine(fp32_pair):
    """vit_forward_fused(fused_mlp=False) over the engine's params: the
    attention-block kernels + eager tanh-gelu MLP. Held
    against JAX's merged engine: both are the same layer in fp32 with the
    LN affine folded or not (rounding-level differences)."""
    _, tm, _, x, want = fp32_pair
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    got = _forward(tm, engine.params, x, fused_mlp=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_unfolded_params_match_jax_engine(fp32_pair):
    """prepare_engine_params(fold_ln=False): the unfolded embed plus pos
    add, and one fused_layer_block_folded per layer with the LN affines
    folded at call time. fp32 at 2e-4, as the engine."""
    _, tm, _, x, want = fp32_pair
    params = prepare_engine_params(module_params(tm), torch.float32, fold_ln=False)
    assert "_embed_special" not in params and "_stacked_layers" not in params["encoder"]
    got = _forward(tm, params, x, fused_mlp=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_plain_forward_equals_cpu_engine(fp32_pair):
    """vit_forward_plain, the reference the card's engine is held against,
    is on the CPU exactly the engine (whose wrappers run the plain versions
    there)."""
    _, tm, _, x, _ = fp32_pair
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    want = engine(x)
    got = vit_forward_plain(
        engine.params, torch.from_numpy(x), patch_size=tm.patch_size, num_heads=tm.num_heads,
        num_class_tokens=tm.num_class_tokens, num_registers=tm.num_registers,
        compute_dtype=torch.float32)
    assert torch.equal(got, want)


def test_model_matches_jax_model(fp32_pair):
    """The port's erf-gelu VisionTransformer against the linen model(x)."""
    jm, tm, _, x, _ = fp32_pair
    want, _ = jm(jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_params_round_trip(fp32_pair):
    """params_from_jax then params_to_jax gives back the JAX tree exactly."""
    _, tm, tree, _, _ = fp32_pair
    back = params_to_jax(tm)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_params_from_jax_rejects_mismatch(fp32_pair):
    _, tm, tree, _, _ = fp32_pair
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        params_from_jax(tm, bad)


def test_engine_bf16_matches_jax_engine():
    """bf16 engines (tests/test_inference.py:37-56 config): same argmax, at
    the repo's bf16 kernel tolerance (tests/test_pallas.py:42)."""
    args = dict(image_size=16, patch_size=8, num_layers=1, num_heads=2,
                hidden_dim=32, mlp_dim=64, num_classes=5)
    jm, tm, _ = _pair(args, 1, 2)
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(JaxEngine(jm, interpret=True)(jnp.asarray(x)), np.float32)
    got = InferenceEngine(tm, compute_dtype=torch.bfloat16, device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_engine_refuses_unported_modes(fp32_pair):
    _, tm, _, _, _ = fp32_pair
    for kwargs in (dict(quantized=True, max_budget=0.5), dict(max_budget=0.5), dict(compact=0.5)):
        with pytest.raises(NotImplementedError):
            InferenceEngine(tm, device="cpu", **kwargs)
    # the NoiseBlock is ported: both build with it, and the ViT engine takes
    # a noise value only where the model has one (JAX inference.py:2930-2934)
    assert build_model("moevit", dict(SMALL, noise_layer=1), device="cpu").noise_layer == 1
    noisy = build_model("vit", SMALL, noise_args={"layer": 1}, device="cpu")
    x = np.zeros((1, 32, 32, 3), np.float32)
    assert InferenceEngine(noisy, device="cpu")(x, noise_value=10.0).shape == (1, 7)
    with pytest.raises(ValueError, match="without a noise layer"):
        InferenceEngine(tm, device="cpu")(x, noise_value=10.0)
