"""The training attention at every head dim and length the shipped configs
need, and the Trainer's choice of path, on the CPU.

``attn_softmax_fwd`` and ``attn_softmax_bwd`` (and the SP tail's
``attn_softmax_fwd_kmask``) take head dims 32 and 64 at any token count on
the card: past the kept kernels' reach a key-tiled kernel streams K and V
in 64-key tiles. Here their plain versions are held against the JAX
package at a partial tile and at the Trainer's token counts (JAX jitted
once per shape, Pallas in interpret mode), a torch model of
the tiled kernels' own order of work is held against the plain versions,
the Trainer's shape predicate is tested as a pure function, and one step
of the port's Trainer at ``vit_tiny``'s widths is held against the JAX
Trainer's. chip_smoke.py holds the kernels against the plain versions on
the card."""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas import fused_layer_vjp as jlv
from peekvit_tpu.ops.pallas.fused_attention import fused_attention as jax_fused_attention
from peekvit_tpu.ops.pallas.fused_attention_vjp import (
    attention_block_trainable as jax_block,
    masked_attention_block_trainable as jax_masked_block,
)
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import live_params, params_to_jax, tree_leaves
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp
from peekvit_torch.ops.cuda import fused_layer_vjp as tlv
from peekvit_torch.training import optim
from peekvit_torch.training.trainer import fused_train_limit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = 2
# a partial 64-key tile, then the Trainer's token counts: ViT-Ti / RankViT
# at 160 px have 401 tokens, ResidualViT 402, and 786 at 224 px. The plain
# versions are dense torch with no routes or tiles; chip_smoke.py holds
# the kernels against them at every route and tile edge.
EDGE_TOKENS = (17, 401, 402, 786)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # the JAX package's fp32 pin; the repo's bf16 one
# Each JAX reference compiles once for one shape and runs once: XLA's LLVM
# optimisation passes cost more than they save there.
_ONE_SHOT = {"xla_backend_optimization_level": 0}


def _run_once(fn, *args):
    """fn(*args), jitted without the backend's optimisation passes."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_ONE_SHOT)(*args)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


def _key_mask(rng, b, n):
    """fp32 (b, n), 1 = attend: about 60% of keys, key 0 always; image 0
    also excludes its whole first 64-key tile where it has a key past it."""
    km = (rng.uniform(size=(b, n)) > 0.4).astype(np.float32)
    km[:, 0] = 1.0
    if n > 64:
        km[0, :64] = 0.0
        km[0, n - 1] = 1.0
    return km


def _jax_site2(q, k, v):
    """Site 2 (``fused_attention`` in interpret mode), fp32 and bf16."""
    return [jax_fused_attention(*(t.astype(dt) for t in (q, k, v)), HEADS, True)
            for dt in (jnp.float32, jnp.bfloat16)]


def _kmask_case(hd, n):
    """The SP tail's attention inputs at head dim hd and N keys: n_q =
    ceil(N / 2) query rows against N keys under a key mask."""
    rng = np.random.default_rng(hd * 1000 + n + 1)
    d = HEADS * hd
    q = rng.normal(size=(2, (n + 1) // 2, d)).astype(np.float32)
    kv = rng.normal(size=(2, n, 2 * d)).astype(np.float32)
    return q, kv, _key_mask(rng, 2, n)


@functools.lru_cache(maxsize=None)
def _jax_kmask(hd):
    """Site 12's attention (``_sp_tail_math``, the Pallas tail kernel's
    math, fed x = 0, Wo = I and a zero MLP so that its output is the
    attention: y = attn Wo + x is an exact product and h = gelu(0) = 0) for
    every EDGE_TOKENS case at this head dim in one jitted call, fp32 and
    bf16: each case's keys padded to the longest and the padding excluded
    by its key mask, which is site 12's own semantics. {n: (fp32, bf16)}."""
    d = HEADS * hd
    nk, nq = max(EDGE_TOKENS), (max(EDGE_TOKENS) + 1) // 2
    cases = [_kmask_case(hd, n) for n in EDGE_TOKENS]
    qs = np.zeros((2 * len(cases), nq, d), np.float32)
    kvs = np.zeros((2 * len(cases), nk, 2 * d), np.float32)
    kms = np.zeros((2 * len(cases), nk), np.float32)
    for i, (q, kv, km) in enumerate(cases):
        qs[2 * i:2 * i + 2, :q.shape[1]] = q
        kvs[2 * i:2 * i + 2, :kv.shape[1]] = kv
        kms[2 * i:2 * i + 2, :km.shape[1]] = km

    def run(qs, kvs, kms):
        outs = []
        for dt in (jnp.float32, jnp.bfloat16):
            eye, zero, zd, one = (jnp.eye(d, dtype=dt), jnp.zeros((d, d), dt),
                                  jnp.zeros((d,), dt), jnp.ones((d,), dt))
            q = qs.astype(dt)
            outs.append(jlv._sp_tail_math(jnp.zeros_like(q), q, kvs[..., :d].astype(dt),
                                          kvs[..., d:].astype(dt), kms, eye, zd, one, zd, zero,
                                          zd, zero, zd, HEADS, 1e-5, rows_2d=False))
        return outs

    outs = [np.asarray(o, np.float32) for o in _run_once(run, qs, kvs, kms)]
    return {n: tuple(o[2 * i:2 * i + 2, :(n + 1) // 2] for o in outs)
            for i, n in enumerate(EDGE_TOKENS)}


@pytest.mark.parametrize("n", EDGE_TOKENS)
@pytest.mark.parametrize("hd", [32, 64])
def test_forward_plain_versions_match_jax(hd, n):
    """``attn_softmax_fwd_ref`` (packed qkv) and ``fused_attention_ref``
    (separate q, k, v) against site 2, and ``attn_softmax_fwd_kmask_ref``
    (n_q = ceil(N / 2) queries against N keys under a key mask, a whole
    64-key tile excluded in image 0) against site 12's attention, at head
    dims 32 and 64, two heads, two images; fp32 at 2e-5, bf16 at 3e-2. On
    CPU tensors the wrappers are their plain versions, bit for bit, and
    count no launch."""
    rng = np.random.default_rng(hd * 1000 + n)
    b, d = 2, HEADS * hd
    qkv = rng.normal(size=(b, n, 3 * d)).astype(np.float32)
    want = _run_once(_jax_site2, *(jnp.asarray(qkv[..., i * d:(i + 1) * d]) for i in range(3)))
    q, kv, km = _kmask_case(hd, n)
    want_masked = _jax_kmask(hd)[n]
    for i, dtype in enumerate(("float32", "bfloat16")):
        tdt = getattr(torch, dtype)
        tqkv, tq, tkv = (torch.tensor(t).to(tdt) for t in (qkv, q, kv))
        tkm = torch.tensor(km)
        tfa.reset_launch_counts()
        got = tvjp.attn_softmax_fwd(tqkv, HEADS)
        sep = tfa.fused_attention(tqkv[..., :d], tqkv[..., d:2 * d], tqkv[..., 2 * d:], HEADS)
        masked = tlv.attn_softmax_fwd_kmask(tq, tkv[..., :d], tkv[..., d:], tkm, HEADS)
        assert tfa.LAUNCHES == {}
        assert torch.equal(got, tvjp.attn_softmax_fwd_ref(tqkv, HEADS)) and torch.equal(got, sep)
        assert torch.equal(masked, tlv.attn_softmax_fwd_kmask_ref(tq, tkv[..., :d], tkv[..., d:],
                                                                  tkm, HEADS))
        assert got.dtype == tdt and got.shape == (b, n, d) and masked.shape == q.shape
        tol = TOL[dtype]
        np.testing.assert_allclose(_np(got), _np(want[i]), rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(masked), want_masked[i], rtol=tol, atol=tol)


def _block_inputs(rng, n, d, masked):
    def f(*s):
        return (rng.normal(size=s) * 0.5).astype(np.float32)

    x = f(1, n, d)
    params = (1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, 3 * d), 0.05 * f(3 * d), 0.2 * f(d, d),
              0.05 * f(d))
    if masked:
        mask = rng.uniform(size=(1, n, 1)).astype(np.float32)
        mask[0, 1:4] = 0.0  # rows a relu gate zeroes
        return (x, mask) + params, f(1, n, d)
    return (x,) + params, f(1, n, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [("vit", 401, 32), ("residual", 402, 64)])
def test_block_gradients_match_jax_at_the_trainer_shapes(case, dtype):
    """The trainable blocks at the Trainer's attention shapes, two heads:
    ``attention_block_trainable`` at N = 401, head dim 32 (ViT-Ti and
    RankViT at 160 px) and ``masked_attention_block_trainable`` at N = 402,
    head dim 64 (ResidualViT), output and every gradient against
    ``jax.vjp`` of the Pallas blocks in interpret mode (saved qkv). On the
    CPU their backward is ``attn_softmax_bwd_ref``, which the card's tiled
    backward is held against. fp32: 2e-5 on the output and 5e-4 on the
    gradients, the JAX package's pins (tests/test_pallas_vjp.py:57, 64);
    bf16: 3e-2."""
    kind, n, hd = case
    masked = kind == "residual"
    eps = 1e-6 if masked else 1e-5
    args, g = _block_inputs(np.random.default_rng(n), n, HEADS * hd, masked)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    if masked:
        def jfn(*a):
            return jax_masked_block(*a, HEADS, eps, True, True)
    else:
        def jfn(*a):
            return jax_block(*a, HEADS, eps, True, 1, True)
    def out_and_grads(*a):
        out, vjp_fn = jax.vjp(jfn, *a[:-1])
        return out, vjp_fn(a[-1])

    want, want_grads = _run_once(out_and_grads, *jargs, jnp.asarray(g, jdt))

    targs = [torch.tensor(a).to(tdt).requires_grad_() for a in args]
    block = tvjp.masked_attention_block_trainable if masked else tvjp.attention_block_trainable
    got = block(*targs, HEADS, eps, True)
    got.backward(torch.tensor(g).to(tdt))
    out_tol, grad_tol = (2e-5, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=out_tol, atol=out_tol)
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"gradient {i} of the {kind} block")


# --------------------------------------- the tiled kernels' order, in torch

TILE = 64  # keys (queries) per streamed stage of the key-tiled kernels
LOG2E = 1.4426950408889634


def _heads(t, parts, heads):
    b, n, w = t.shape
    return t.float().reshape(b, n, parts, heads, w // parts // heads).permute(2, 0, 3, 1, 4)


def _scale_log2e(scale):
    """scale * log2(e) as the kernels' entry points form it, in fp32."""
    return torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)


def _tiled_forward(q, k, v, kmask, scale, dt):
    """attn_tiled_fwd_kernel's work per (image, head) in fp32: pass 1 takes
    each 64-key stage's raw logits (scaled only in the exponent), the row
    max, and the running sum of exp2(x * scale log2 e - max * scale log2
    e): the stage's terms summed, then added to the sum rescaled to the new
    max (the exponent's base 0 while a row has seen no key); pass 2 forms
    P = exp2(...) * (1 / sum) stage by stage, rounds it to ``dt`` and sums
    P V over the stages. q (B, H, nq, hd), k, v (B, H, nk, hd) fp32;
    kmask (B, nk) or None."""
    nk = k.shape[2]
    sl2e = _scale_log2e(scale)
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    stages = range(0, nk, TILE)

    def logits(t0):
        s = torch.matmul(q, k[:, :, t0:t0 + TILE].transpose(-1, -2))
        if kmask is not None:
            s = torch.where(kmask[:, None, None, t0:t0 + TILE] > 0, s, float("-inf"))
        return s

    def base_of(mx):  # -max * scale log2 e, 0 where a row has seen no key
        return torch.where(mx == float("-inf"), torch.zeros_like(mx), -mx * sl2e)

    for t0 in stages:
        s = logits(t0)
        new = torch.maximum(m, s.amax(-1))
        base = base_of(new)
        terms = torch.exp2(s * sl2e + base[..., None]).sum(-1)
        l = l * torch.exp2(m * sl2e + base) + terms
        m = new
    inv, base = 1.0 / l, base_of(m)
    o = torch.zeros(q.shape)
    for t0 in stages:
        p = (torch.exp2(logits(t0) * sl2e + base[..., None]) * inv[..., None]).to(dt).float()
        o = o + torch.matmul(p, v[:, :, t0:t0 + TILE].to(dt).float())
    return o


def _tiled_backward(q, k, v, da, scale, dt):
    """The key-tiled backward pair per (image, head) in fp32. Launch 1
    (query tiles) sweeps the keys in 64-key stages twice: first the online
    row max, sum and D numerator sum(e dS), the last two rescaled together
    as the max grows, then D = numerator * (1 / sum); then dQ = sum of
    bf16(P (dS - D) scale) K with P = exp2(s * scale log2 e - max * scale
    log2 e) * (1 / sum). It keeps (-max * scale log2 e, 1 / sum, D). Launch 2
    (key tiles) sweeps the queries in 64-query stages with those statistics,
    forming the same P: dV = sum of bf16(P)^T dA, dK = sum of bf16(dZ *
    scale)^T Q. Returns dq, dk, dv (B, H, N, hd)."""
    n = q.shape[2]
    sl2e = _scale_log2e(scale)
    m = torch.full(q.shape[:3], float("-inf"))
    l, u = torch.zeros(q.shape[:3]), torch.zeros(q.shape[:3])
    stages = range(0, n, TILE)
    for c0 in stages:
        s = torch.matmul(q, k[:, :, c0:c0 + TILE].transpose(-1, -2))
        ds = torch.matmul(da, v[:, :, c0:c0 + TILE].transpose(-1, -2))
        new = torch.maximum(m, s.amax(-1))
        e = torch.exp2(s * sl2e - new[..., None] * sl2e)
        rescale = torch.exp2(m * sl2e - new * sl2e)
        l = l * rescale + e.sum(-1)
        u = u * rescale + (e * ds).sum(-1)
        m = new
    base, inv = -m * sl2e, 1.0 / l
    dd = u * inv

    def probs(qq, kk, bb, ii):  # P of rows qq against keys kk with their rows' stats
        return torch.exp2(torch.matmul(qq, kk.transpose(-1, -2)) * sl2e + bb[..., None]) * \
            ii[..., None]

    dq = torch.zeros(q.shape)
    for c0 in stages:
        kc = k[:, :, c0:c0 + TILE]
        p = probs(q, kc, base, inv)
        dz = p * (torch.matmul(da, v[:, :, c0:c0 + TILE].transpose(-1, -2)) - dd[..., None])
        dq = dq + torch.matmul((dz * scale).to(dt).float(), kc)
    dk, dv = torch.zeros(q.shape), torch.zeros(q.shape)
    for c0 in stages:  # launch 2: S^T and dS^T of every key against 64 queries
        sl = slice(c0, c0 + TILE)
        pt = probs(q[:, :, sl], k, base[..., sl], inv[..., sl]).transpose(-1, -2)
        dst = torch.matmul(v, da[:, :, sl].transpose(-1, -2))
        dzt = pt * (dst - dd[..., None, sl])
        dv = dv + torch.matmul(pt.to(dt).float(), da[:, :, sl])
        dk = dk + torch.matmul((dzt * scale).to(dt).float(), q[:, :, sl])
    return dq, dk, dv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 65, 200])
def test_tiled_order_matches_plain_versions(n, dtype):
    """The key-tiled kernels' order of work (per 64-key stage: the stage's
    row max and the rescaled running sum in exp2 form, one reciprocal a
    row, P normalised and rounded per stage before its P V; the backward's
    merged statistics-and-D sweep, its dQ sweep and its query-stage pass)
    on the same inputs as the plain versions, at head dim 32, with a
    partial last stage (65, 200) and, under a key mask, image 0's first
    64-key stage wholly excluded: no NaN, fp32 within 2e-5 and bf16 within
    3e-2 of the plain versions."""
    rng = np.random.default_rng(n)
    b, hd = 2, 32
    d = HEADS * hd
    dt = getattr(torch, dtype)
    qkv = torch.tensor(rng.normal(size=(b, n, 3 * d)), dtype=torch.float32).to(dt)
    da = torch.tensor(rng.normal(size=(b, n, d)) * 0.5, dtype=torch.float32).to(dt)
    km = torch.tensor(_key_mask(rng, b, n))
    q, k, v = _heads(qkv, 3, HEADS)
    scale = hd ** -0.5

    def merge(t):
        return t.permute(0, 2, 1, 3).reshape(b, n, d)

    tol = TOL[dtype]
    got = merge(_tiled_forward(q, k, v, None, scale, dt)).to(dt)
    masked = merge(_tiled_forward(q, k, v, km, scale, dt)).to(dt)
    grads = torch.cat([merge(t) for t in _tiled_backward(q, k, v, _heads(da, 1, HEADS)[0],
                                                         scale, dt)], -1).to(dt)
    want = (tvjp.attn_softmax_fwd_ref(qkv, HEADS),
            tlv.attn_softmax_fwd_kmask_ref(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                                           km, HEADS),
            tvjp.attn_softmax_bwd_ref(qkv, da, HEADS))
    for name, a, w in zip(("forward", "masked forward", "backward"), (got, masked, grads), want):
        assert torch.isfinite(a.float()).all(), name
        np.testing.assert_allclose(_np(a), _np(w), rtol=tol, atol=tol, err_msg=name)


# ------------------------------------------------- the Trainer's one predicate

TRAINED = ("models.vit.VisionTransformer", "models.rankvit.RankVisionTransformer",
           "models.residualvit.ResidualVisionTransformer",
           "models.eeresidualvit.EEResidualVisionTransformer")


def _shipped_configs():
    """Every shipped model config the Trainer trains, by file name."""
    out = {}
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "model", "*.yaml"))):
        with open(path) as f:
            cfg = yaml.safe_load(f)
        if cfg.get("_target_", "").endswith(TRAINED):
            out[os.path.basename(path)[:-5]] = cfg
    return out


def test_every_shipped_config_fits_the_fused_path():
    """Every shipped ViT, RankViT and ResidualViT config: the fused path's
    kernels take it on "cuda" at any image size (head dim 32 or 64 at any
    token count: 65-786 at 64-224 px; the GEMM and LN-backward widths)."""
    configs = _shipped_configs()
    assert {"vit_tiny", "rankvit", "residualvit", "vit_b_16", "residualvit_b_16"} <= set(configs)
    for name, cfg in configs.items():
        d, h, m = cfg["hidden_dim"], cfg["num_heads"], cfg["mlp_dim"]
        assert fused_train_limit(d, h, m, "cuda") is None, name
        assert tfa.softmax_head_dim(name, d, h) in (32, 64)


def test_predicate_names_each_limit():
    """Head dim 48 (ViT-B at 16 heads), a GEMM width off its multiple and
    a row past the LN backward's 1024 fail on "cuda" and pass on the CPU,
    whose plain versions take any shape."""
    cases = {(768, 16, 3072): "head dim 48", (100, 2, 256): "head dim 50",
             (256, 8, 100): "mlp_dim 100", (96, 3, 384): None, (2048, 32, 4096): "at most 1024"}
    for (d, h, m), want in cases.items():
        got = fused_train_limit(d, h, m, "cuda")
        assert (got is None) if want is None else (want in got), (d, h, m, got)
        assert fused_train_limit(d, h, m, "cpu") is None
    with pytest.raises(ValueError, match="head dims"):
        tfa.softmax_head_dim("attn_softmax_fwd", 96, 2)


VIT_TINY_1L = dict(image_size=160, patch_size=8, num_layers=1, num_heads=8, hidden_dim=256,
                   mlp_dim=768, num_classes=10)


def test_trainer_takes_the_module_path_or_raises_outside_the_limits(monkeypatch):
    """At head dim 48 on CUDA, ``fused="auto"`` and ``fused=True`` raise at
    construction, naming the limit, before the model moves, and
    ``fused=False`` takes the module path; inside the limits "auto" and
    True resolve to the fused path."""
    args = dict(VIT_TINY_1L, image_size=32, hidden_dim=96, mlp_dim=192, num_heads=2)  # hd 48
    model = build_model("vit", args, device="cpu")
    trainer = Trainer(model=model, optimizer=optim.SGD(), device="cpu")
    trainer.device = torch.device("cuda")
    for fused in ("auto", True):
        trainer.fused = fused
        with pytest.raises(ValueError, match="head dim 48"):
            trainer._fused_kind()
    trainer.fused = False
    assert trainer._fused_kind() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for fused in ("auto", True):
        with pytest.raises(ValueError, match="head dim 48"):
            Trainer(model=model, optimizer=optim.SGD(), fused=fused, device="cuda")
    assert next(model.parameters()).device.type == "cpu"
    fits = build_model("vit", dict(args, hidden_dim=64), device="cpu")  # head dim 32
    for fused in ("auto", True):
        t = Trainer(model=fits, optimizer=optim.SGD(), fused=fused, device="cpu")
        t.device = torch.device("cuda")
        assert t._fused_kind() == "vit"


def test_trainer_step_matches_jax_at_vit_tiny_width():
    """One SGD step of the port's Trainer(fused=True) on the CPU against the
    JAX Trainer(fused=True) (bf16 compute, Pallas in interpret mode) at
    vit_tiny's widths at 160 px (401 tokens, head dim 32), one layer,
    batch 2, on the same weights and batch: the loss and every leaf's
    update at 3e-2 of its largest, the repo's bf16 tolerance."""
    rng = np.random.default_rng(6)
    tm = build_model("vit", VIT_TINY_1L, seed=4, device="cpu")
    with torch.no_grad():  # a zero-initialised head gives every image the same logits
        tm.head.kernel.copy_(torch.tensor(rng.normal(size=tm.head.kernel.shape) * 0.05))
    jm = jax_build_model("vit", VIT_TINY_1L, params=jax.tree.map(jnp.asarray, params_to_jax(tm)))
    x = rng.normal(size=(2, 160, 160, 3)).astype(np.float32)
    y = np.array([3, 7])
    lr = 0.5
    jt = JaxTrainer(model=jm, optimizer=jax_optim.SGD(lr=lr), fused=True)
    tt = Trainer(model=tm, optimizer=optim.SGD(lr=lr), fused=True, device="cpu")
    assert tt._fused_kind() == "vit"
    def leaves():
        return {"/".join(str(getattr(k, "key", k)) for k in path): np.array(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(jm.params)}

    before_t = {name: p.detach().clone() for name, p in tree_leaves(live_params(tm))}
    before_j = leaves()
    want = float(jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=0)["total_loss"])
    got = float(tt.train_step(x, y, step_idx=0)["total_loss"])
    assert tt._train_kind == "fused_vit"
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    after_j = leaves()
    assert set(after_j) == set(before_t)
    for name, p in tree_leaves(live_params(tm)):
        step_t = (p.detach() - before_t[name]).numpy()
        step_j = after_j[name] - before_j[name]
        scale = max(float(np.abs(step_j).max()), 1e-6)
        np.testing.assert_allclose(step_t / scale, step_j / scale, rtol=3e-2, atol=3e-2,
                                   err_msg=f"update of {name}")
