"""The port's attention switch and the Pallas attention sites 1 and 2
(``fused_mhsa``, ``fused_attention``) against the JAX package's, on the
CPU.

Mirrors tests/test_pallas.py: the kernels' plain versions against the
Pallas functions in interpret mode, ``multi_head_attention`` under
"pallas" against "xla", training (non-deterministic) forwards and key
masks taking the module's own attention, and a toy ViT module's eval
forward under "pallas" against linen under JAX's "pallas". Both switches
are reset in ``finally``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops import attention as jax_attention
from peekvit_tpu.ops.pallas.fused_attention import fused_attention as jax_fused_attention
from peekvit_tpu.ops.pallas.fused_attention import fused_mhsa as jax_fused_mhsa
from peekvit_torch import build_model
from peekvit_torch.models.adapters import params_from_jax
from peekvit_torch.ops import attention as tatt
from peekvit_torch.ops import get_attention_impl, multi_head_attention, set_attention_impl
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp

ARGS = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4,
            hidden_dim=64, mlp_dim=128, num_classes=10)  # tests/test_vit.py:21-24


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,n,tol", [("float32", 9, 2e-5), ("float32", 197, 2e-5),
                                         ("bfloat16", 197, 3e-2)])
def test_fused_mhsa_matches_jax(dtype, n, tol):
    """Site 1 against the Pallas ``fused_mhsa`` (tests/test_pallas.py:
    128-140: b 2, d 48, 4 heads; fp32 2e-5, bf16 3e-2)."""
    rng = np.random.default_rng(4)
    qkv = rng.normal(size=(2, n, 3 * 48)).astype(np.float32)
    want = jax_fused_mhsa(jnp.asarray(qkv, getattr(jnp, dtype)), 4, True)
    tfa.reset_launch_counts()
    got = tfa.fused_mhsa(torch.tensor(qkv).to(getattr(torch, dtype)), 4)
    assert tfa.LAUNCHES == {} and got.dtype == getattr(torch, dtype)
    _close(got, want, tol)
    assert torch.equal(got, tfa.fused_mhsa_ref(torch.tensor(qkv).to(got.dtype), 4))


@pytest.mark.parametrize("n", [7, 64, 197])
@pytest.mark.parametrize("num_heads", [1, 4])
def test_fused_attention_matches_jax(n, num_heads):
    """Site 2 against the Pallas ``fused_attention`` with its padding
    (tests/test_pallas.py:18-29: b 2, d 32, fp32 2e-5)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, n, 32)).astype(np.float32) for _ in range(3))
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads, True)
    got = tfa.fused_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), num_heads)
    _close(got, want, 2e-5)


def test_fused_attention_bf16_matches_jax():
    """tests/test_pallas.py:32-43: bf16, b 2, n 50, d 64, 4 heads, 3e-2."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 50, 64)).astype(np.float32) for _ in range(3))
    want = jax_fused_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), 4, True)
    got = tfa.fused_attention(*(torch.tensor(t).to(torch.bfloat16) for t in (q, k, v)), 4)
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)


@pytest.mark.parametrize("n", [16, 17, 256, 257])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_attn_softmax_fwd_at_the_kernel_edges(n, dtype, tol):
    """``attn_softmax_fwd`` (packed qkv) at the key counts where the CUDA
    kernel changes its padding or instance (16 / 17: one or two 16-key
    chunks; 256: the wgmma kernel's last count, 257: the two-pass
    kernel's first), head dim 64 as the kernel's, against the Pallas
    ``fused_attention`` in interpret mode on the same q, k, v (fp32 2e-5,
    bf16 3e-2); on the CPU the wrapper is its plain version, bit for bit,
    and counts no launch."""
    rng = np.random.default_rng(n)
    d, heads = 128, 2
    qkv = rng.normal(size=(1, n, 3 * d)).astype(np.float32)
    q, k, v = (jnp.asarray(qkv[..., i * d:(i + 1) * d], getattr(jnp, dtype)) for i in range(3))
    want = jax_fused_attention(q, k, v, heads, True)
    packed = torch.tensor(qkv).to(getattr(torch, dtype))
    tfa.reset_launch_counts()
    got = tvjp.attn_softmax_fwd(packed, heads)
    assert tfa.LAUNCHES == {} and got.dtype == packed.dtype
    assert torch.equal(got, tvjp.attn_softmax_fwd_ref(packed, heads))
    _close(got, want, tol)


def _mhsa_params(rng, d, in_bias=True):
    return {"in_proj": {"kernel": rng.normal(size=(d, 3 * d)) * 0.1,
                        "bias": rng.normal(size=(3 * d,)) * 0.1 if in_bias else np.zeros(3 * d)},
            "out_proj": {"kernel": rng.normal(size=(d, d)) * 0.1, "bias": np.zeros(d)}}


def _torch_tree(tree, requires_grad=False):
    return {k: {kk: torch.tensor(v, dtype=torch.float32, requires_grad=requires_grad)
                for kk, v in sub.items()} for k, sub in tree.items()}


def test_impl_switch_full_mhsa(monkeypatch):
    """tests/test_pallas.py:46-70: multi_head_attention under "pallas"
    matches "xla" end to end at 2e-5, through fused_mhsa exactly once."""
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(2, 17, 32)), dtype=torch.float32)
    params = _torch_tree(_mhsa_params(rng, 32))
    calls = []
    monkeypatch.setattr(tatt, "fused_mhsa", lambda *a: calls.append(1) or tfa.fused_mhsa(*a))
    want = multi_head_attention(x, params, 4)
    assert get_attention_impl() == "xla" and calls == []
    set_attention_impl("pallas")
    try:
        got = multi_head_attention(x, params, 4)
    finally:
        set_attention_impl("xla")
    assert calls == [1]
    _close(got, want.numpy(), 2e-5)
    with pytest.raises(ValueError, match="unknown attention impl"):
        set_attention_impl("triton")
    assert get_attention_impl() == "xla"


def test_pallas_impl_training_grads(monkeypatch):
    """tests/test_pallas.py:73-106: a non-deterministic (training)
    forward under "pallas" takes the module's own attention, so its
    gradients equal "xla"'s."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.normal(size=(2, 9, 32)), dtype=torch.float32)
    tree = _mhsa_params(rng, 32, in_bias=False)
    monkeypatch.setattr(tatt, "fused_mhsa", lambda *a: pytest.fail("fused_mhsa in training"))

    def grads():
        params = _torch_tree(tree, requires_grad=True)
        (multi_head_attention(x, params, 4, deterministic=False) ** 2).sum().backward()
        return [params[p]["kernel"].grad for p in ("in_proj", "out_proj")]

    want = grads()
    set_attention_impl("pallas")
    try:
        got = grads()
    finally:
        set_attention_impl("xla")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pallas_path_respects_mask_fallback(monkeypatch):
    """tests/test_pallas.py:109-125: a key mask forces the plain path even
    under "pallas"."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(1, 9, 16)), dtype=torch.float32)
    params = {"in_proj": {"kernel": torch.eye(16, 48), "bias": torch.zeros(48)},
              "out_proj": {"kernel": torch.eye(16), "bias": torch.zeros(16)}}
    mask = torch.ones(1, 9)
    mask[0, -3:] = 0
    monkeypatch.setattr(tatt, "fused_mhsa", lambda *a: pytest.fail("fused_mhsa with a mask"))
    want = multi_head_attention(x, params, 2, key_mask=mask)
    set_attention_impl("pallas")
    try:
        out = multi_head_attention(x, params, 2, key_mask=mask)
    finally:
        set_attention_impl("xla")
    assert torch.isfinite(out).all() and torch.equal(out, want)


def test_vit_module_under_pallas_matches_linen(monkeypatch):
    """A toy ViT module's eval forward under "pallas" against the linen
    module under JAX's "pallas" (fused_mhsa in interpret mode), fp32 at
    rtol 1e-4 / atol 1e-5 (tests/test_vit.py:50); each layer's attention
    goes through fused_mhsa, and a train-mode forward does not."""
    jm = jax_build_model("vit", ARGS, seed=0)
    jm.params["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.key(1), jm.params["head"]["kernel"].shape)
    tm = params_from_jax(build_model("vit", ARGS, device="cpu"),
                         jax.tree.map(np.asarray, jm.params))
    x = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    calls = []
    monkeypatch.setattr(tatt, "fused_mhsa", lambda *a: calls.append(1) or tfa.fused_mhsa(*a))
    jax_attention.set_attention_impl("pallas")
    set_attention_impl("pallas")
    try:
        want, _ = jm(jnp.asarray(x))
        with torch.no_grad():
            got, _ = tm(torch.from_numpy(x))
            assert len(calls) == ARGS["num_layers"]
            tm.train()
            train_out, _ = tm(torch.from_numpy(x))
            tm.eval()
    finally:
        jax_attention.set_attention_impl("xla")
        set_attention_impl("xla")
    assert len(calls) == ARGS["num_layers"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        xla_out, _ = tm(torch.from_numpy(x))
    assert torch.equal(train_out, xla_out)
