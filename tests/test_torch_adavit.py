"""The port's A-ViT against the JAX package's, on the CPU: ``norm_rows``'s
``avit`` mode and ``avit_layer_block`` against the Pallas function in
interpret mode (0/1 and fractional masks), the weights (the scanned
block's stacked tree loaded with params_from_jax), the module against
linen (logits and the three aux fields) and
``InferenceEngine(adavit, device="cpu")`` against the JAX engine with
tokens halting at mixed depths (the JAX test's settings and tolerance,
tests/test_inference.py:388-414). Inputs come from numpy with a seed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_tpu.utils import losses as jlosses
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.inference import adavit_forward_fused, adavit_forward_plain
from peekvit_torch.models.adapters import params_from_jax, params_to_jax
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.utils import losses as tlosses

B, N, D, H, M = 2, 17, 64, 4, 128
EPS = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": 2e-4, "bf16": 3e-2}  # the repo's Pallas tolerances (tests/test_pallas.py)
# tests/test_inference.py:392-399: gates tuned so that tokens halt at mixed depths
ARGS = dict(image_size=32, patch_size=8, num_layers=4, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=10, gate_scale=5.0, gate_center=0.0)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(20)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    a = {"x": normal(B, N, D, scale=1.5, shift=0.3),
         "binary": (rng.uniform(size=(B, N, 1)) < 0.6).astype(np.float32),
         "fraction": rng.uniform(0.0, 1.0, size=(B, N, 1)).astype(np.float32),
         "ln1s": normal(D, scale=0.2, shift=1.0), "ln1b": normal(D, scale=0.1),
         "wqkv": normal(D, 3 * D, scale=D ** -0.5), "bqkv": normal(3 * D, scale=0.1),
         "wo": normal(D, D, scale=D ** -0.5), "bo": normal(D, scale=0.1),
         "ln2s": normal(D, scale=0.2, shift=1.0), "ln2b": normal(D, scale=0.1),
         "w1": normal(D, M, scale=D ** -0.5), "b1": normal(M, scale=0.1),
         "w2": normal(M, D, scale=M ** -0.5), "b2": normal(D, scale=0.1)}
    a["binary"][:, 0] = 1.0
    return a


WEIGHTS = ("ln1s", "ln1b", "wqkv", "bqkv", "wo", "bo", "ln2s", "ln2b", "w1", "b1", "w2", "b2")


def _both(a, names, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a[k], jdt) for k in names],
            [torch.from_numpy(a[k]).to(tdt) for k in names])


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(got.float().numpy() - want).max() / np.abs(want).max()


@pytest.mark.parametrize("mask", ["binary", "fraction"])
def test_norm_rows_avit_is_ln_of_masked_rows(arrays, mask):
    """LN(x * a) * a against the Pallas ``_ln_f32_rows(x * a) * a`` (fp32,
    1e-6); for a 0/1 mask it equals the masked mode's mask * LN(x)."""
    x = arrays["x"].reshape(B * N, D)
    a = arrays[mask].reshape(-1, 1)
    s, b = arrays["ln1s"], arrays["ln1b"]
    want = jfa._ln_f32_rows(jnp.asarray(x * a), jnp.asarray(s)[None], jnp.asarray(b)[None],
                            EPS) * a
    t = [torch.from_numpy(v) for v in (x, s, b, a)]
    got = tfa.norm_rows(t[0], EPS, torch.float32, t[1], t[2], t[3], premask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    masked = tfa.norm_rows(t[0], EPS, torch.float32, t[1], t[2], t[3])
    assert torch.allclose(got, masked, atol=1e-6) == (mask == "binary")
    with pytest.raises(ValueError, match="premask needs"):
        tfa.norm_rows(t[0], EPS, torch.float32, premask=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mask", ["binary", "fraction"])
def test_avit_layer_block(arrays, dtype, mask):
    """Against the Pallas ``avit_layer_block`` in interpret mode: fp32
    2e-4, bf16 3e-2 of max|out|; the plain twin equals the CPU wrapper."""
    j, t = _both(arrays, ("x", mask) + WEIGHTS, dtype)
    want = jfa.avit_layer_block(*j, H, EPS, True)
    got = tfa.avit_layer_block(*t, H, EPS)
    assert got.dtype == t[0].dtype and got.shape == (B, N, D)
    assert _rel_err(got, want) <= TOL[dtype]
    assert torch.equal(tfa.avit_layer_block_ref(*t, H, EPS), got)
    tfa.reset_launch_counts()
    tfa.avit_layer_block(*t, H, EPS)
    assert tfa.LAUNCHES == {}  # CPU tensors take the plain versions


# -------------------------------------------------------------- model, engine


@pytest.fixture(scope="module")
def pair():
    """The JAX test's A-ViT (seed 8, head re-drawn at std 0.05) and the
    port's model with its weights; images from the same generator."""
    jm = jax_build_model("adavit", ARGS, seed=8)
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda v: np.array(v, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.05, tree["head"]["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    return jm, params_from_jax(build_model("adavit", ARGS, device="cpu"), tree), tree, x


def test_params_round_trip(pair):
    """The stacked block tree (leading layer axis) loads strictly and comes
    back exactly."""
    _, tm, tree, _ = pair
    assert tree["encoder"]["blocks"]["block"]["ln_1"]["scale"].shape == (4, 32)
    back = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(tm)))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf)


def test_module_matches_linen(pair):
    """Logits and the three aux fields at fp32 2e-4; the A-ViT losses on
    the port's aux equal JAX's on linen's."""
    jm, tm, _, x = pair
    want, jaux = jm(jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    assert set(aux) == set(jaux) == {"rho_token", "counter_token", "halting_score_layer"}
    for k in aux:
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]), rtol=2e-4, atol=2e-4)
    assert float(np.asarray(jaux["counter_token"]).min()) < ARGS["num_layers"]
    for tl, jl in ((tlosses.AViTPonderLoss(), jlosses.AViTPonderLoss()),
                   (tlosses.AViTDPriorLoss(), jlosses.AViTDPriorLoss())):
        np.testing.assert_allclose(float(tl(aux)), float(jl(jaux)), rtol=1e-4)


def test_engine_matches_jax_engine(pair):
    """The JAX test's own settings and tolerance (1e-3: a token on the
    c ~ 1 - eps boundary may flip); some tokens halt early. The plain twin
    fed the engine's halting decisions equals the CPU engine."""
    jm, tm, _, x = pair
    _, aux = jm(jnp.asarray(x))
    assert float(np.asarray(aux["counter_token"]).min()) < ARGS["num_layers"]
    want = np.asarray(JaxEngine(jm, compute_dtype=jnp.float32, interpret=True)(jnp.asarray(x)))
    engine = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu")
    got = engine(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    decisions = []
    images = torch.from_numpy(x)
    fused = adavit_forward_fused(engine.params, images, active_out=decisions, **engine._forward)
    assert len(decisions) == ARGS["num_layers"]
    assert torch.equal(adavit_forward_plain(engine.params, images, active_in=decisions,
                                            **engine._forward), fused)
    below = decisions[0][1]
    assert 0 < below.mean() < 1  # mixed depths after the first layer


def test_guards(pair):
    """int8 and max_budget= refused with the JAX reason; the NoiseBlock
    builds (noise_layer= and noise_args=) and the engine refuses it, as
    JAX's does (the noise sits inside the ACT loop); training with
    dropout draws from its generator."""
    _, tm, _, _ = pair
    for kwargs in (dict(quantized=True), dict(max_budget=0.5)):
        with pytest.raises(NotImplementedError, match="bf16-only"):
            InferenceEngine(tm, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="ResidualViT family"):
        InferenceEngine(tm, device="cpu", compact=0.5)
    for noisy in (build_model("adavit", dict(ARGS, noise_layer=1), device="cpu"),
                  build_model("adavit", ARGS, noise_args={"layer": 1}, device="cpu")):
        assert noisy.encoder.noise_layer == 1
        with pytest.raises(NotImplementedError, match="ACT loop"):
            InferenceEngine(noisy, device="cpu")
    # dropout is ported (tests/test_torch_dropout.py): a train forward draws
    # its masks from the generator; the eval forward has none
    dropout = build_model("AdaptiveVisionTransformer", dict(ARGS, dropout=0.1), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    drawn = [dropout(x, train=True, generator=torch.Generator().manual_seed(s))[1]["rho_token"]
             for s in (0, 0, 1)]
    assert torch.equal(drawn[0], drawn[1]) and not torch.equal(drawn[0], drawn[2])
    plain = build_model("AdaptiveVisionTransformer", ARGS, device="cpu")
    plain.load_state_dict(dropout.state_dict())
    assert torch.equal(dropout(x)[1]["rho_token"], plain(x)[1]["rho_token"])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("adavit", ARGS)
    model = build_model("adavit", ARGS, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
