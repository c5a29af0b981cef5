"""The port's merged trainable layer (Pallas sites 10-11) against the JAX
package's, on the CPU.

The same numpy inputs go through both packages: ``layer_block_trainable``
and ``layer_block_hybrid`` (output and all thirteen gradients), the new
kernels' plain versions against float64 autograd, the merged ViT forward
and its gradients, and one merged train step. JAX runs as its own tests
run it (``interpret=True``, one and two images per grid cell). On the CPU
the port's kernel wrappers run their plain versions; chip_smoke.py holds
the kernels against them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas.fused_layer_vjp import layer_block_hybrid as jax_hybrid
from peekvit_tpu.ops.pallas.fused_layer_vjp import layer_block_trainable as jax_trainable
from peekvit_tpu.training.fused import make_fused_train_step as jax_train_step
from peekvit_tpu.training.fused import vit_forward_trainable as jax_forward_trainable
from peekvit_torch import build_model
from peekvit_torch.models.adapters import live_params, params_from_jax, tree_leaves
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp
from peekvit_torch.ops.cuda import fused_layer_vjp as tlv
from peekvit_torch.training import optim
from peekvit_torch.training.fused import make_fused_train_step, vit_forward_trainable

GRAD_NAMES = ["dx", "dlns1", "dlnb1", "dwqkv", "dbqkv", "dwo", "dbo", "dlns2", "dlnb2", "dw1",
              "db1", "dw2", "db2"]
ARGS = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2,
            hidden_dim=32, mlp_dim=64, num_classes=5)  # tests/test_fused_training.py:13-24
PORT = {"trainable": (tlv.layer_block_trainable, tlv.layer_block_trainable_ref),
        "hybrid": (tlv.layer_block_hybrid, tlv.layer_block_hybrid_ref)}
JAX = {"trainable": jax_trainable, "hybrid": jax_hybrid}


def _layer_inputs(seed=0, b=2, n=17, d=32, m=64):
    """tests/test_pallas_vjp.py:209-217 inputs (N not a multiple of 8)."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.5).astype(np.float32)

    x = f(b, n, d)
    args = (x, 1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, 3 * d), 0.05 * f(3 * d),
            0.2 * f(d, d), 0.05 * f(d), 1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, m),
            0.05 * f(m), 0.2 * f(m, d), 0.05 * f(d))
    return args, f(b, n, d)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


@pytest.mark.parametrize("mi", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["trainable", "hybrid"])
def test_layer_block_matches_jax(kind, dtype, mi):
    """Output and all thirteen gradients against the Pallas custom VJP in
    interpret mode with ``mi`` images per grid cell. fp32: 2e-5 on the
    output, 5e-4 on the gradients (tests/test_pallas_vjp.py:222, 233, 256,
    264); bf16: 3e-2, the repo's bf16 kernel tolerance."""
    heads = 4
    args, g = _layer_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    fn = JAX[kind]
    want = fn(*jargs, heads, 1e-5, True, mi)
    want_grads = jax.grad(
        lambda *a: jnp.sum((fn(*a, heads, 1e-5, True, mi) * jg).astype(jnp.float32)),
        argnums=tuple(range(13)))(*jargs)

    targs = [torch.tensor(a).to(tdt).requires_grad_() for a in args]
    tfa.reset_launch_counts()
    got = PORT[kind][0](*targs, heads, 1e-5)
    (got.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    assert tfa.LAUNCHES == {}  # CPU tensors: plain versions, no launch
    assert got.dtype == tdt and got.shape == args[0].shape
    out_tol, grad_tol = (2e-5, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=out_tol, atol=out_tol)
    for name, t, w in zip(GRAD_NAMES, targs, want_grads):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape, name
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"{kind} grad mismatch: {name}")


@pytest.mark.parametrize("kind", ["trainable", "hybrid"])
def test_ref_twin_equals_block_on_cpu(kind):
    """The ``_ref`` twins (the card's reference) are, on the CPU, the
    blocks themselves bit for bit, and the backward reruns to the same
    bits."""
    args, g = _layer_inputs(seed=3)
    outs = []
    for fn in (*PORT[kind], PORT[kind][0]):
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        out = fn(*targs, 4, 1e-5)
        (out * torch.tensor(g)).sum().backward()
        outs.append([out] + [t.grad for t in targs])
    for run in outs[1:]:
        for a, b in zip(outs[0], run):
            assert torch.equal(a, b)


def test_new_kernels_plain_versions_against_float64():
    """The new kernels' plain versions against float64 autograd: the bias
    sums are sums of the fp32 values (db1 of the unrounded dhpre, dbo of
    dy), the rounded copies round those values; the wrappers on CPU
    tensors count no launch."""
    rng = np.random.default_rng(5)
    r, d, m = 37, 32, 64

    def t(*s, scale=1.0, dtype=torch.float32):
        return torch.tensor(rng.normal(size=s) * scale, dtype=torch.float64).to(dtype)

    tfa.reset_launch_counts()
    # gelu_hpre: h = gelu(a w + b) rounded, hpre the fp32 pre-activation
    a, w, bias = t(r, d, dtype=torch.bfloat16), t(d, m, scale=0.2), t(m, scale=0.1)
    h, hpre = tfa.gemm_gelu_hpre(a, w.to(torch.bfloat16), bias.to(torch.bfloat16))
    want = a.double() @ w.to(torch.bfloat16).double() + bias.to(torch.bfloat16).double()
    torch.testing.assert_close(hpre.double(), want, rtol=1e-6, atol=1e-6)
    assert hpre.dtype == torch.float32 and h.dtype == torch.bfloat16
    torch.testing.assert_close(h, F.gelu(want, approximate="tanh").to(torch.bfloat16),
                               rtol=0, atol=2 ** -6)
    # gelu_grad: dhpre = (g w2^T) gelu'(hpre), db1 partials over the fp32 values
    g, w2 = t(r, d, dtype=torch.bfloat16), t(m, d, scale=0.2, dtype=torch.bfloat16)
    hp64 = t(r, m, dtype=torch.float64).requires_grad_()
    dh = g.double() @ w2.double().t()
    want, = torch.autograd.grad(F.gelu(hp64, approximate="tanh"), hp64, dh)
    dhpre_b, parts = tfa.gemm_nt_gelu_grad(g, w2, hp64.detach().float())
    assert dhpre_b.dtype == torch.bfloat16 and parts.dtype == torch.float32
    torch.testing.assert_close(dhpre_b.double(), want, rtol=2 ** -7, atol=1e-6)
    torch.testing.assert_close(parts.sum(0).double(), want.sum(0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tfa.gelu_tanh_grad(hp64.detach()),
                               torch.autograd.grad(F.gelu(hp64, approximate="tanh").sum(),
                                                   hp64)[0], rtol=1e-12, atol=1e-12)
    # gemm_wgrad: a^T b in fp32 and the column sums of b
    a, b = t(r, d, dtype=torch.bfloat16), t(r, 3 * d, dtype=torch.bfloat16)
    c, sums = tlv.gemm_wgrad(a, b, colsum=True)
    torch.testing.assert_close(c.double(), a.double().t() @ b.double(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sums.double(), b.double().sum(0), rtol=1e-6, atol=1e-6)
    assert tlv.gemm_wgrad(a, b)[1] is None
    # ln_bwd_rows_f32 (LN2 on the fp32 y) and ln_bwd_rows with fp32 g (LN1)
    for x_dtype, g_dtype in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        x = t(r, d, scale=1.5, dtype=x_dtype)
        x64 = x.double().requires_grad_()
        gamma = (1.0 + t(d, scale=0.1)).to(torch.bfloat16)
        gamma64 = gamma.double().requires_grad_()
        beta64 = torch.zeros(d, dtype=torch.float64, requires_grad=True)
        dln, resid = t(r, d), t(r, d, dtype=g_dtype)
        F.layer_norm(x64, (d,), gamma64, beta64, 1e-5).backward(dln.double())
        want_dx = x64.grad + resid.double()
        if x_dtype == torch.float32:
            dy, dy_b, pw, pb, pdy = tvjp.ln_bwd_rows_f32(x, dln, resid, gamma, 1e-5)
            assert dy.dtype == torch.float32 and dy_b.dtype == torch.bfloat16
            torch.testing.assert_close(dy.double(), want_dx, rtol=1e-5, atol=1e-5)
            assert torch.equal(dy_b, dy.to(torch.bfloat16))
            torch.testing.assert_close(pdy.sum(0).double(), want_dx.sum(0), rtol=1e-5,
                                       atol=1e-5)
        else:
            dx, pw, pb = tvjp.ln_bwd_rows(x, dln, resid, gamma, 1e-5)
            assert dx.dtype == torch.bfloat16
            torch.testing.assert_close(dx.double(), want_dx, rtol=2 ** -7, atol=1e-5)
        torch.testing.assert_close(pw.sum(0).double(), gamma64.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pb.sum(0).double(), beta64.grad, rtol=1e-5, atol=1e-5)
    # ln_rows on fp32 rows, rounded to bf16
    y = t(r, d, scale=1.5)
    scale, shift = (1.0 + t(d, scale=0.1)).to(torch.bfloat16), t(d, scale=0.1).to(torch.bfloat16)
    got = tfa.ln_rows(y, scale, shift, 1e-5, out_dtype=torch.bfloat16)
    want = F.layer_norm(y.double(), (d,), scale.double(), shift.double(), 1e-5)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.double(), want, rtol=2 ** -7, atol=1e-6)
    assert tfa.LAUNCHES == {}


VIT_B16_WGRAD = [(50432, 768, 2304), (50432, 768, 768), (50432, 768, 3072), (50432, 3072, 768)]


@pytest.mark.parametrize("rows,k,n", VIT_B16_WGRAD + [(6304, 768, 3072), (37, 32, 96), (0, 64, 64),
                                                      (1000, 768, 776), (1000, 32, 96),
                                                      (33, 768, 776)])
def test_wgrad_splits_cover_the_rows(rows, k, n):
    """wgrad_plan (gemm_wgrad.cu's persistent schedule): every unit is a
    non-empty run of whole 64-row stages, each C tile's units cover every
    stage exactly once, whole tiles write C and split tiles one slot per
    split, at most WGRAD_SMS CTAs take the units, and at the ViT-B/16
    shapes the units fill whole waves of 132."""
    plan = tlv.wgrad_plan(rows, k, n)
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.tiles_m == -(-k // 128) and plan.tiles_n == -(-n // plan.bn)
    assert plan.bn in (128, 256) and plan.stages == -(-rows // tlv.WGRAD_ROWS)
    assert 1 <= plan.grid <= tlv.WGRAD_SMS and plan.grid <= max(1, len(plan.units))
    covered = {t: [] for t in range(tiles)}
    for tile, lo, hi, slot in plan.units:
        assert 0 <= lo < hi <= plan.stages or (rows == 0 and lo == hi == 0)
        covered[tile].append((lo, hi, slot))
    slots = []
    for tile, runs in covered.items():
        stages = sorted(st for lo, hi, _ in runs for st in range(lo, hi))
        assert stages == list(range(plan.stages)), f"tile {tile}: stages {stages}"
        if tile in plan.red_tiles:
            assert len(runs) == plan.splits > 1
            i = plan.red_tiles.index(tile)
            assert [r[2] for r in runs] == [k_ * len(plan.red_tiles) + i
                                            for k_ in range(plan.splits)]
            slots += [r[2] for r in runs]
        else:
            assert runs == [(0, plan.stages, -1)]
    assert sorted(slots) == list(range(len(slots)))
    if (rows, k, n) in VIT_B16_WGRAD:
        assert len(plan.units) % tlv.WGRAD_SMS == 0 and plan.grid == tlv.WGRAD_SMS
        # split-major: one wave of the split units reads few row runs
        if plan.splits > 1:
            split = plan.units[len(plan.units) - plan.splits * len(plan.red_tiles):]
            most = -(-tlv.WGRAD_SMS // len(plan.red_tiles)) + 1
            for w in range(0, len(split), tlv.WGRAD_SMS):
                assert len({u[1] for u in split[w:w + tlv.WGRAD_SMS]}) <= most


@pytest.mark.parametrize("rows,k,n", [(1000, 768, 776), (1000, 32, 96), (333, 136, 264)])
def test_wgrad_plan_partials_sum_to_the_product(rows, k, n):
    """Each unit's partial A[rows]^T B[rows] over its C tile, the split
    tiles' partials added with torch in split order (reduce_kernel's
    order) and the whole tiles written directly, equals gemm_wgrad_ref
    (fp32 sums in another order: 1e-5)."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(rows, k)) * 0.5, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=(rows, n)) * 0.05, dtype=torch.float32)
    plan = tlv.wgrad_plan(rows, k, n)
    assert plan.splits > 1
    r = tlv.WGRAD_ROWS
    c = torch.full((k, n), float("nan"))
    parts = {}
    for tile, lo, hi, slot in plan.units:
        tm, tn = divmod(tile, plan.tiles_n)
        rs, ks, ns = slice(lo * r, hi * r), slice(tm * 128, tm * 128 + 128), \
            slice(tn * plan.bn, tn * plan.bn + plan.bn)
        part = a[rs, ks].t() @ b[rs, ns]
        if slot < 0:
            c[ks, ns] = part
        else:
            parts[slot] = (ks, ns, part)
    for i, _ in enumerate(plan.red_tiles):
        ks, ns, acc = parts[i]
        for k_ in range(1, plan.splits):
            acc = acc + parts[k_ * len(plan.red_tiles) + i][2]
        c[ks, ns] = acc
    want, _ = tlv.gemm_wgrad_ref(a, b)
    torch.testing.assert_close(c, want, rtol=1e-5, atol=1e-5)


def test_kernel_ops_pair_with_their_plain_versions():
    """Each op of the merged layer's kernel set has, under the same field,
    its own plain version in the plain set."""
    for field in tlv._Ops._fields:
        kernel, plain = getattr(tlv._KERNELS, field), getattr(tlv._PLAIN, field)
        assert plain.__name__ == kernel.__name__ + "_ref", field


# ------------------------------------------------------------ the forward


def _model_pair(seed=2, head_key=3):
    """tests/test_fused_training.py:13-24: a seeded JAX ViT with a randomised
    head, and the port's model holding the same weights."""
    jm = jax_build_model("vit", ARGS, seed=seed)
    jm.params["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.key(head_key), jm.params["head"]["kernel"].shape)
    tree = jax.tree.map(np.asarray, jm.params)
    return jm, params_from_jax(build_model("vit", ARGS, device="cpu"), tree)


@pytest.mark.parametrize("merged", [True, "hybrid"])
def test_merged_forward_and_grads_match_jax(merged):
    """vit_forward_trainable(merged=...) in fp32: the loss at rtol 1e-4
    and every gradient leaf, scaled by its max, at 2e-3
    (tests/test_fused_training.py:48, :56-62), against JAX's merged
    forward; remat is a no-op on the merged path."""
    jm, tm = _model_pair()
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.arange(4, dtype=np.int64)

    def jax_loss(p):
        logits = jax_forward_trainable(p, jnp.asarray(x), patch_size=8, num_heads=2,
                                       compute_dtype=jnp.float32, interpret=True,
                                       merged=merged)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    l_ref, g_ref = jax.value_and_grad(jax_loss)(jm.params)
    grads = []
    for remat in (False, True):
        tm.zero_grad(set_to_none=True)
        logits = vit_forward_trainable(live_params(tm), torch.from_numpy(x), patch_size=8,
                                       num_heads=2, compute_dtype=torch.float32,
                                       merged=merged, remat=remat)
        loss = F.cross_entropy(logits, torch.from_numpy(y))
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
        grads.append({name: p.grad.clone() for name, p in tree_leaves(live_params(tm))})
    ref = {_path(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(g_ref)}
    assert set(grads[0]) == set(ref)
    for name, leaf in ref.items():
        scale = max(float(np.abs(np.asarray(leaf)).max()), 1e-3)
        np.testing.assert_allclose(grads[0][name].numpy() / scale, np.asarray(leaf) / scale,
                                   rtol=2e-3, atol=2e-3, err_msg=f"grad mismatch at {name}")
        assert torch.equal(grads[1][name], grads[0][name]), name


def test_merged_train_step_matches_jax():
    """One make_fused_train_step(merged=True) update with SGD(0.1) in fp32
    against JAX's jitted step (optax.sgd): the loss at rtol 1e-4, every
    updated leaf within 1e-4 (0.1 x the 2e-3 gradient bar at gradients of
    order 0.5)."""
    jm, tm = _model_pair()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.array([0, 1, 2, 3])
    tx = optax.sgd(0.1)
    step = jax_train_step(jm, tx, compute_dtype=jnp.float32, interpret=True, merged=True)
    params, _, l_ref = step(jm.params, tx.init(jm.params), jnp.asarray(x), jnp.asarray(y))
    tstep = make_fused_train_step(tm, optim.SGD(lr=0.1).build(live_params(tm)),
                                  compute_dtype=torch.float32, merged=True)
    loss = tstep(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(l_ref), rtol=1e-4)
    got = dict(tree_leaves(live_params(tm)))
    for p, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_allclose(got[_path(p)].detach().numpy(), np.asarray(leaf),
                                   rtol=1e-4, atol=1e-4, err_msg=_path(p))


def test_merged_guards():
    """An unknown ``merged`` value raises; the fp32 guard on the card is
    decided from the images' device (a CPU run in fp32 is the parity
    path above)."""
    _, tm = _model_pair()
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="merged"):
        vit_forward_trainable(live_params(tm), x, patch_size=8, num_heads=2, merged="yes")
    out = vit_forward_trainable(live_params(tm), x, patch_size=8, num_heads=2, merged=True)
    assert out.dtype == torch.float32 and out.shape == (1, 5)
