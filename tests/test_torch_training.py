"""The port's training slice against the JAX package's, on the CPU.

The same numpy inputs go through both packages: the trainable attention
block and its plain kernel versions, the fused ViT forward and its
gradients, one optimizer update per optax chain, and the Trainer. JAX runs
as its own tests run it (``interpret=True``). On the CPU the port's kernel
wrappers run their plain versions; chip_smoke.py holds the kernels
against them on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas.fused_attention_vjp import (
    attention_block_trainable as jax_block,
)
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.fused import vit_forward_trainable as jax_forward_trainable
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.training.trainer import param_filter_mask as jax_param_filter_mask
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import live_params, params_from_jax, tree_leaves
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_attention_vjp as tvjp
from peekvit_torch.training import optim
from peekvit_torch.training.fused import make_fused_train_step, vit_forward_trainable
from peekvit_torch.training.trainer import param_filter_mask

GRAD_NAMES = ["dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwo", "dbo"]
ARGS = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2,
            hidden_dim=32, mlp_dim=64, num_classes=5)  # tests/test_fused_training.py:13-24


def _block_inputs(seed=0, b=2, n=17, d=32):
    """tests/test_pallas_vjp.py:30-41 inputs (N not a multiple of 8)."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.5).astype(np.float32)

    x = f(b, n, d)
    args = (x, 1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, 3 * d), 0.05 * f(3 * d),
            0.2 * f(d, d), 0.05 * f(d))
    return args, f(b, n, d)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("save_qkv", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_matches_jax(save_qkv, dtype):
    """Forward and all seven gradients against the Pallas custom VJP. fp32:
    2e-5 on the output, 5e-4 on the gradients (tests/test_pallas_vjp.py:57,
    64); bf16: 3e-2, the repo's bf16 kernel tolerance."""
    heads = 4
    args, g = _block_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jdt) for a in args]
    jg = jnp.asarray(g, jdt)
    want = jax_block(*jargs, heads, 1e-5, True, 1, save_qkv)
    want_grads = jax.grad(
        lambda *a: jnp.sum((jax_block(*a, heads, 1e-5, True, 1, save_qkv) * jg)
                           .astype(jnp.float32)),
        argnums=tuple(range(7)))(*jargs)

    targs = [torch.tensor(a).to(tdt).requires_grad_() for a in args]
    tfa.reset_launch_counts()
    got = tvjp.attention_block_trainable(*targs, heads, 1e-5, save_qkv)
    (got.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    assert tfa.LAUNCHES == {}  # CPU tensors: plain versions, no launch
    assert got.dtype == tdt and got.shape == args[0].shape
    out_tol, grad_tol = (2e-5, 5e-4) if dtype == "float32" else (3e-2, 3e-2)
    np.testing.assert_allclose(_np(got), _np(want), rtol=out_tol, atol=out_tol)
    for name, t, w in zip(GRAD_NAMES, targs, want_grads):
        assert t.grad.dtype == tdt, name
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"grad mismatch: {name}")


@pytest.mark.parametrize("save_qkv", [False, True])
def test_block_ref_twin_equals_block_on_cpu(save_qkv):
    """attention_block_trainable_ref (the card's reference) is, on the CPU,
    the block itself bit for bit."""
    args, g = _block_inputs(seed=3)
    outs = []
    for fn in (tvjp.attention_block_trainable, tvjp.attention_block_trainable_ref):
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        out = fn(*targs, 4, 1e-5, save_qkv)
        (out * torch.tensor(g)).sum().backward()
        outs.append([out] + [t.grad for t in targs])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_kernel_plain_versions():
    """The new wrappers' plain versions against direct formulas, and the
    wrappers on CPU tensors count no launch."""
    rng = np.random.default_rng(5)
    b, n, h, hd = 2, 11, 2, 8
    d = h * hd
    qkv = torch.tensor(rng.normal(size=(b, n, 3 * d)), dtype=torch.float32)
    dattn = torch.tensor(rng.normal(size=(b, n, d)), dtype=torch.float32)
    tfa.reset_launch_counts()
    attn = tvjp.attn_softmax_fwd(qkv, h)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, h, hd).transpose(1, 2)
               for i in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, -1) @ v
    torch.testing.assert_close(attn, want.transpose(1, 2).reshape(b, n, d))
    # backward against autograd of the same fp32 attention
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = torch.softmax(q @ k.transpose(-1, -2) / hd ** 0.5, -1) @ v
    out.backward(dattn.reshape(b, n, h, hd).transpose(1, 2))
    want = torch.cat([t.grad.transpose(1, 2).reshape(b, n, d) for t in (q, k, v)], -1)
    torch.testing.assert_close(tvjp.attn_softmax_bwd(qkv, dattn, h), want)
    # ln_bwd_rows: dx and the LN-param grads against autograd of F.layer_norm
    x = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, requires_grad=True)
    gamma = torch.tensor(1.0 + 0.1 * rng.normal(size=d), dtype=torch.float32,
                         requires_grad=True)
    beta = torch.zeros(d, requires_grad=True)
    dln = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    resid = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    torch.nn.functional.layer_norm(x, (d,), gamma, beta, 1e-5).backward(dln)
    dx, pw, pb = tvjp.ln_bwd_rows(x.detach(), dln, resid, gamma.detach(), 1e-5)
    torch.testing.assert_close(dx, x.grad + resid)
    torch.testing.assert_close(pw.sum(0), gamma.grad)
    torch.testing.assert_close(pb.sum(0), beta.grad)
    # gemm_nt: a @ w^T
    a, w = torch.randn(5, 32), torch.randn(16, 32)
    for epi in ("none", "none_f32"):
        torch.testing.assert_close(tfa.gemm_nt(a, w, epi), a @ w.t())
    with pytest.raises(ValueError):
        tfa.gemm_nt(a, w, "bias")
    assert tfa.LAUNCHES == {}
    with pytest.raises(ValueError):
        tvjp.attn_softmax_fwd(torch.empty(1, 4, 3 * 64, device="meta"), 1)


# ------------------------------------------------------------ the forward


def _model_pair(seed=2, head_key=3):
    """tests/test_fused_training.py:13-24: a seeded JAX ViT with a randomised
    head, and the port's model holding the same weights."""
    jm = jax_build_model("vit", ARGS, seed=seed)
    jm.params["head"]["kernel"] = 0.05 * jax.random.normal(
        jax.random.key(head_key), jm.params["head"]["kernel"].shape)
    tree = jax.tree.map(np.asarray, jm.params)
    return jm, params_from_jax(build_model("vit", ARGS, device="cpu"), tree)


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


def _port_loss(model, x, y, **kwargs):
    logits = vit_forward_trainable(live_params(model), torch.from_numpy(x), patch_size=8,
                                   num_heads=2, compute_dtype=torch.float32, **kwargs)
    return torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))


def test_forward_and_grads_match_jax():
    """Loss at rtol 1e-4 and every gradient leaf, scaled by its max, at
    2e-3 (tests/test_fused_training.py:48, :56-62), fp32."""
    jm, tm = _model_pair()
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(np.float32)
    y = np.arange(4, dtype=np.int64)

    def jax_loss(p):
        logits = jax_forward_trainable(p, jnp.asarray(x), patch_size=8, num_heads=2,
                                       compute_dtype=jnp.float32, interpret=True)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    l_ref, g_ref = jax.value_and_grad(jax_loss)(jm.params)
    loss = _port_loss(tm, x, y)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref), rtol=1e-4)
    got = {name: p.grad for name, p in tree_leaves(live_params(tm))}
    ref = {_path(p): leaf for p, leaf in jax.tree_util.tree_leaves_with_path(g_ref)}
    assert set(got) == set(ref)
    for name, leaf in ref.items():
        scale = max(float(np.abs(np.asarray(leaf)).max()), 1e-3)
        np.testing.assert_allclose(got[name].numpy() / scale, np.asarray(leaf) / scale,
                                   rtol=2e-3, atol=2e-3, err_msg=f"grad mismatch at {name}")


def test_remat_grads_match_no_remat():
    """Per-layer checkpointing (and with it the recompute backward) changes
    memory, not gradients (tests/test_fused_training.py:156-174)."""
    _, tm = _model_pair()
    x = np.random.default_rng(2).normal(size=(3, 16, 16, 3)).astype(np.float32)
    y = np.arange(3, dtype=np.int64)
    grads = []
    for remat in (False, True):
        tm.zero_grad(set_to_none=True)
        _port_loss(tm, x, y, remat=remat).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_make_fused_train_step_converges():
    """tests/test_fused_training.py:65-80: the fused step with Adam in fp32
    halves the loss within 20 steps."""
    _, tm = _model_pair()
    x, y = _batch(1)
    step = make_fused_train_step(tm, optim.Adam(lr=5e-3).build(live_params(tm)),
                                 compute_dtype=torch.float32)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y))) for _ in range(20)]
    assert losses[-1] < losses[0] * 0.5, losses[::5]


def test_live_params_reach_every_parameter():
    """Every model parameter gets a nonzero gradient through the live tree
    (module_params detaches; a detached tree would train nothing)."""
    _, tm = _model_pair()
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 3)).astype(np.float32)
    _port_loss(tm, x, np.array([0, 3])).backward()
    names = [n for n, _ in tm.named_parameters()]
    assert len(names) == len(tree_leaves(live_params(tm)))
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
    bf16 = vit_forward_trainable(live_params(tm), torch.from_numpy(x), patch_size=8,
                                 num_heads=2, merged="auto")
    assert bf16.dtype == torch.float32 and bf16.shape == (2, 5)
    for merged in (True, "hybrid"):
        with pytest.raises(NotImplementedError, match="item 14"):
            vit_forward_trainable(live_params(tm), torch.from_numpy(x), patch_size=8,
                                  num_heads=2, merged=merged)


# ----------------------------------------------------------- the optimizer


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"encoder": {"layers_0": {"w": rng.normal(size=(4, 3)).astype(np.float32)}},
            "head": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                     "bias": rng.normal(size=(2,)).astype(np.float32)},
            "class_tokens": rng.normal(size=(1, 1, 3)).astype(np.float32)}


OPT_CASES = {
    "adam": (jax_optim.Adam(lr=1e-2), optim.Adam(lr=1e-2), {}),
    "adam_l2": (jax_optim.Adam(lr=1e-2, weight_decay=0.1),
                optim.Adam(lr=1e-2, weight_decay=0.1), {}),
    "adamw": (jax_optim.AdamW(lr=1e-2, weight_decay=0.1),
              optim.AdamW(lr=1e-2, weight_decay=0.1), {}),
    "sgd_momentum_l2": (jax_optim.SGD(lr=0.1, weight_decay=0.05, momentum=0.9),
                        optim.SGD(lr=0.1, weight_decay=0.05, momentum=0.9), {}),
    "clip": (jax_optim.Adam(lr=1e-2), optim.Adam(lr=1e-2), {"clip": 0.5}),
    "frozen_adamw": (jax_optim.AdamW(lr=1e-2, weight_decay=0.1),
                     optim.AdamW(lr=1e-2, weight_decay=0.1), {"frozen": True}),
    "frozen_adam_l2": (jax_optim.Adam(lr=1e-2, weight_decay=0.1),
                       optim.Adam(lr=1e-2, weight_decay=0.1), {"frozen": True, "clip": 1.0}),
    "grad_accumulation_2": (jax_optim.Adam(lr=1e-2), optim.Adam(lr=1e-2),
                            {"accum": 2, "clip": 1.0}),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_update_matches_optax(case):
    """Two updates (from the same params and grads) give optax's params
    within 1e-6: the JAX Trainer's chain (trainer.py:161-171) against
    OptimizerSpec.build + GradientTransform."""
    jspec, tspec, opts = OPT_CASES[case]
    k = opts.get("accum", 1)
    params = _opt_tree(0)
    grads = [jax.tree.map(lambda a: a * 3.0, _opt_tree(10 + i)) for i in range(2 * k)]
    mask_j = jax_param_filter_mask(params) if opts.get("frozen") else None
    tx = jspec.build(param_mask=mask_j)
    if opts.get("clip"):
        tx = optax.chain(optax.clip_by_global_norm(opts["clip"]), tx)
    if k > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=k)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)

    tree = jax.tree.map(lambda a: torch.nn.Parameter(torch.tensor(a)), params)
    mask_t = param_filter_mask(tree) if opts.get("frozen") else None
    if mask_t is not None:
        assert dict(tree_leaves(mask_t)) == {_path(p): v for p, v in
                                             jax.tree_util.tree_leaves_with_path(mask_j)}
        assert not all(v for _, v in tree_leaves(mask_t))
    opt = tspec.build(tree, param_mask=mask_t)
    leaves = tree_leaves(tree)
    tx_t = optim.GradientTransform(opt, [p for _, p in leaves], opts.get("clip"), k)
    moved = []
    for gr in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, gr), state, jp)
        jp = optax.apply_updates(jp, upd)
        flat = dict(tree_leaves(gr))
        for name, p in leaves:
            p.grad = torch.tensor(flat[name])
        moved.append(tx_t())
    assert moved == [(i + 1) % k == 0 for i in range(2 * k)]
    want = {_path(p): v for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    for name, p in leaves:
        assert p.grad is None
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    if opts.get("frozen"):  # weight decay still moves a frozen leaf
        assert not np.allclose(dict(leaves)["encoder/layers_0/w"].detach().numpy(),
                               params["encoder"]["layers_0"]["w"])


def test_learning_rate_and_schedule():
    tree = {"w": torch.nn.Parameter(torch.zeros(3))}
    opt = optim.SGD(lr=0.1).build(tree)
    assert optim.get_learning_rate(opt) == 0.1
    optim.set_learning_rate(opt, 0.05)
    assert optim.get_learning_rate(opt) == 0.05
    jsched, tsched = jax_optim.CosineAnnealingLR(T_max=10), optim.CosineAnnealingLR(T_max=10)
    for epoch in (0, 3, 10, 12):
        assert tsched.lr_at(epoch, 0.1) == jsched.lr_at(epoch, 0.1)
    with pytest.raises(ValueError):
        optim.OptimizerSpec("lamb", lr=0.1).build(tree)
    logits = torch.tensor([[1.0, 2.0, 0.5], [0.1, 0.2, 3.0]])
    labels = torch.tensor([1, 0])
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits.numpy()), jnp.asarray(labels.numpy())).mean()
    np.testing.assert_allclose(float(optim.CrossEntropyLoss()(logits, labels)), float(want),
                               rtol=1e-6)
    np.testing.assert_allclose(float(optim.MSELossMain()(logits, logits + 2.0)), 4.0)


# -------------------------------------------------------------- the Trainer


def _batch(seed, n=20):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(5, 16, 16, 3)).astype(np.float32)
    y = np.arange(n) % 5
    x = (base[y] + 0.1 * rng.normal(size=(n, 16, 16, 3))).astype(np.float32)
    return x, y


def test_trainer_matches_jax_trainer():
    """Trainer(fused=True) on the CPU against the JAX Trainer(fused=True)
    (bf16 compute, Pallas in interpret mode) on the same weights and batch:
    the first three losses at 3e-2, the repo's bf16 tolerance."""
    jm, tm = _model_pair()
    x, y = _batch(4)
    jt = JaxTrainer(model=jm, optimizer=jax_optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True)
    tt = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True,
                 device="cpu")
    assert tt._fused_kind() == "vit"
    want = [float(jt.train_step(jnp.asarray(x), jnp.asarray(y), step_idx=i)["total_loss"])
            for i in range(3)]
    got = [float(tt.train_step(x, y, step_idx=i)["total_loss"]) for i in range(3)]
    assert tt._train_kind == "fused_vit"
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def test_trainer_fused_loss_falls():
    """tests/test_fused_training.py:83-105: the metric keys, and the loss
    falls over 12 steps."""
    _, tm = _model_pair()
    x, y = _batch(4)
    trainer = Trainer(model=tm, optimizer=optim.Adam(lr=5e-3), clip_grad_norm=1.0, fused=True,
                      device="cpu")
    losses = []
    for i in range(12):
        metrics = trainer.train_step(x, y, step_idx=i)
        assert set(metrics) == {"classification_loss", "total_loss"}
        losses.append(float(metrics["total_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


class _Logger:
    def __init__(self):
        self.records = []

    def log(self, rec):
        self.records.append(rec)


def test_trainer_module_path_epoch_and_validate():
    """fused='auto' on the CPU takes the module path (the linen step's
    counterpart); train_epoch writes the scheduled lr, logs every batch in
    buffered flushes and returns the mean; validate counts accuracy."""
    _, tm = _model_pair()
    x, y = _batch(7, n=8)
    loader = [(x[:4], y[:4]), (x[4:], y[4:])]
    trainer = Trainer(model=tm, optimizer=optim.SGD(lr=0.05),
                      scheduler=optim.CosineAnnealingLR(T_max=4), log_every=1, device="cpu")
    assert not trainer._fused_eligible()
    logger = _Logger()
    summary = trainer.train_epoch(loader, epoch=1, logger=logger)
    assert trainer._train_kind == "module"
    assert summary["num_batches"] == 2 and np.isfinite(summary["total_loss"])
    losses = [r["train/total_loss"] for r in logger.records if "train/total_loss" in r]
    assert len(losses) == 2
    np.testing.assert_allclose(summary["total_loss"], np.mean(losses), rtol=1e-6)
    lr = optim.CosineAnnealingLR(T_max=4).lr_at(1, 0.05)
    assert logger.records[-1] == {"train/lr": lr}
    stop = trainer.train_epoch(loader, epoch=2, should_stop=lambda: True)
    assert stop["num_batches"] == 1 and stop["interrupted"] == 1.0
    acc, loss = trainer.validate(loader)
    assert 0.0 <= acc <= 1.0 and np.isfinite(loss)
    correct, _, aux = trainer.eval_step(x, y)
    assert aux == {} and 0 <= int(correct) <= 8


def test_trainer_grad_accumulation_and_freezing():
    """grad_accumulation=2 moves the params on every second call only;
    train_backbone=False still decays the frozen encoder under AdamW."""
    _, tm = _model_pair()
    x, y = _batch(9, n=4)
    trainer = Trainer(model=tm, optimizer=optim.AdamW(lr=1e-2, weight_decay=0.1),
                      grad_accumulation=2, train_backbone=False, fused=True, device="cpu")
    w = tm.encoder.layers_0.mlp.fc1_kernel
    before = w.detach().clone()
    trainer.train_step(x, y)
    assert torch.equal(w, before)
    trainer.train_step(x, y)
    torch.testing.assert_close(w.detach(), before * (1 - 1e-2 * 0.1))


def test_trainer_refuses_what_is_not_ported():
    _, tm = _model_pair()
    base = dict(model=tm, optimizer=optim.Adam(), device="cpu")
    for kwargs in (dict(mesh=object()), dict(pipeline_stages=2),
                   dict(sequence_parallel_devices=2), dict(tensor_parallel=True),
                   dict(fsdp_sharded_params=True), dict(zero_sharded_optimizer=True),
                   dict(qat=True), dict(qat="static"), dict(ee_weights=[1.0]),
                   dict(reconstruction_weight=0.5)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md port queue A item"):
            Trainer(**base, **kwargs)
    trainer = Trainer(**base)
    x, y = _batch(1, n=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        trainer.train_step(x, y, noise_value=0.5)
    with pytest.raises(NotImplementedError, match="items 4-5"):
        trainer.train_step(x, y, budget=0.5)
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(**base, remat=True, fused=False).train_step(x, y)
    dropout = build_model("vit", dict(ARGS, dropout=0.1), device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        Trainer(model=dropout, optimizer=optim.Adam(), device="cpu")
