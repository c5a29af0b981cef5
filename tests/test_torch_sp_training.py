"""The port's sequence-parallel (SP) training against the JAX package's,
on the CPU: the SP tail ``sp_tail_block`` (its plain version) against the
Pallas ``sp_tail_block`` in interpret mode, output and every gradient;
``sequence_parallel_vit_forward`` in both ``kernels`` forms and the
``Trainer(sequence_parallel_devices=...)`` step run as spawned gloo ranks
(one process per rank, ``tests/torch_sp_worker.py``; one spawn per world
size) against the JAX SP forward and the JAX SP Trainer on the virtual
8-device mesh, every rank's outputs bit-identical; and the guards. Inputs
come from numpy with a seed.

Tolerances: the tail at fp32 2e-4 and bf16 3e-2 (sums in another order;
tests/test_pallas.py:42); the forwards at JAX's own 1e-4 / 1e-5
(tests/test_parallel.py:420-449); the steps at JAX's SP step pins: loss
1e-5 / 1e-6, params 1e-4 (:448-467), the Pallas tail against the XLA tail
5e-3 (the tanh against the erf gelu, :819-848), grad accumulation 2e-5 /
1e-6 (:1020-1035)."""

import functools
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import torch_sp_worker
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas.fused_layer_vjp import sp_tail_block as jax_sp_tail
from peekvit_tpu.parallel import make_mesh as jax_make_mesh
from peekvit_tpu.parallel import shard_batch
from peekvit_tpu.parallel.sequence import sequence_parallel_vit_block as jax_sp_block
from peekvit_tpu.parallel.sequence import sequence_parallel_vit_forward as jax_sp_forward
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import params_from_jax, tree_leaves
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import fused_layer_vjp as tlv
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.parallel.sequence import sequence_parallel_vit_forward
from peekvit_torch.training import optim

JOIN_TIMEOUT = 240.0  # seconds for every rank to finish; a hung collective fails the test
LR = 0.05
# tests/test_parallel.py:_model and the SP RankViT models
VIT = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
           num_classes=10)
RANK_FWD = dict(VIT, image_size=32, num_layers=3, rankvit_layers=[1, 2])
RANK_TRAIN = dict(VIT, rankvit_layers=[1])
FWD_BUDGETS = [1.0, 0.6, 0.3]
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
GELU_TOL = dict(rtol=5e-3, atol=5e-3)

TAIL_GRADS = ["dx", "dq", "dk", "dv", "dw_out", "db_out", "dlns2", "dlnb2", "dw1", "db1", "dw2",
              "db2"]


# ------------------------------------------------------------------ the tail


def _tail_inputs(b=2, nq=5, nk=12, d=64, m=128, seed=0):
    """x, q (B, n_q, D), k, v (B, n_k, D), a key mask that excludes the
    last two keys (padding) and a few ranked-off image keys per image, the
    class key attended, and the weights; the cotangent."""
    rng = np.random.default_rng(seed)

    def f(*s):
        return (rng.normal(size=s) * 0.5).astype(np.float32)

    kmask = np.ones((b, nk), np.float32)
    kmask[:, -2:] = 0.0
    kmask[0, [3, 5, 7]] = 0.0
    kmask[1, [1, 2, 4, 8]] = 0.0
    arrays = (f(b, nq, d), f(b, nq, d), f(b, nk, d), f(b, nk, d), kmask, 0.2 * f(d, d),
              0.05 * f(d), 1.0 + 0.1 * f(d), 0.1 * f(d), 0.2 * f(d, m), 0.05 * f(m),
              0.2 * f(m, d), 0.05 * f(d))
    return arrays, f(b, nq, d)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_tail_matches_pallas(dtype):
    """``sp_tail_block`` on the CPU (its plain version) against the Pallas
    ``sp_tail_block`` in interpret mode, with n_q != n_k and a mask that
    excludes padding and ranked keys: the output and all twelve gradients
    against ``jax.vjp``; kmask takes no gradient (JAX's is zero)."""
    heads = 4
    arrays, g = _tail_inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jnp.float32 if i == 4 else jdt) for i, a in enumerate(arrays)]
    want, vjp = jax.vjp(lambda *a: jax_sp_tail(*a, heads, 1e-5, True), *jargs)
    want_grads = vjp(jnp.asarray(g, jdt))
    assert not np.any(np.asarray(want_grads[4]))

    targs = [torch.tensor(a).to(torch.float32 if i == 4 else tdt).requires_grad_()
             for i, a in enumerate(arrays)]
    tfa.reset_launch_counts()
    got = tlv.sp_tail_block(*targs, heads, 1e-5)
    grads = torch.autograd.grad(got, targs, torch.tensor(g).to(tdt), allow_unused=True)
    assert tfa.LAUNCHES == {}  # CPU tensors: plain versions, no launch
    assert got.dtype == tdt and got.shape == arrays[0].shape
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert grads[4] is None  # kmask is a selection input
    leaves = [t for i, t in enumerate(targs) if i != 4]
    for name, t, gt, w in zip(TAIL_GRADS, leaves, grads[:4] + grads[5:],
                              want_grads[:4] + want_grads[5:]):
        assert gt.dtype == tdt and gt.shape == t.shape, name
        np.testing.assert_allclose(_np(gt), _np(w), **tol, err_msg=f"tail grad {name}")
    ref = tlv.sp_tail_block_ref(*targs, heads, 1e-5)
    assert torch.equal(ref, got)  # the wrapper takes the plain versions on the CPU


def test_sp_tail_attention_plain_version():
    """The tail's attention: a row's only attended key may sit anywhere
    (the first 64 keys all excluded), and q / k / v may be column slices of
    wider buffers; the result is softmax over the attended keys alone."""
    rng = np.random.default_rng(3)
    b, nq, nk, d, h = 2, 7, 80, 64, 1
    qkv = torch.tensor(rng.normal(size=(b, nq, 3 * d)), dtype=torch.float32)
    kv = torch.tensor(rng.normal(size=(b, nk, 2 * d)), dtype=torch.float32)
    kmask = torch.zeros(b, nk)
    kmask[0, 70] = 1.0
    kmask[1, 65:] = 1.0
    got = tlv.attn_softmax_fwd_kmask(qkv[..., :d], kv[..., :d], kv[..., d:], kmask, h)
    assert torch.isfinite(got).all()
    for i in range(b):
        keep = kmask[i] > 0
        k, v = kv[i, keep, :d], kv[i, keep, d:]
        s = torch.softmax(qkv[i, :, :d] @ k.t() / d ** 0.5, dim=-1)
        torch.testing.assert_close(got[i], s @ v, rtol=1e-5, atol=1e-5)


# ------------------------------------------------ the SP forward and step


def _tree(family, args, seed):
    """A seeded JAX param tree (numpy) with a random head and class tokens
    (a zero-initialised head gives every logit 0)."""
    jm = jax_build_model(family, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    return tree


def _jax_model(family, args, tree):
    jm = jax_build_model(family, args, seed=0)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return jm


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


MODELS = {"vit": ("vit", VIT, 301, "images16"), "rank_fwd": ("rankvit", RANK_FWD, 302, "images32"),
          "rank_train": ("rankvit", RANK_TRAIN, 303, "images16")}


def _cases(world: int) -> list:
    """The rank-side cases of one spawn (the mesh's model axis is the
    world size, or 2 on the (2, 2) dp x sp mesh)."""
    sp = (1, world)
    cases = [dict(kind="block", name="block", weights="vit", family="vit", args=VIT,
                  images="images16", mesh=sp)]
    for kernels in ("xla", "pallas"):
        cases.append(dict(kind="forward", name=f"fwd_vit_{kernels}", weights="vit", family="vit",
                          args=VIT, images="images16", budgets=[None], kernels=kernels, mesh=sp))
        cases.append(dict(kind="forward", name=f"fwd_rank_{kernels}", weights="rank_fwd",
                          family="rankvit", args=RANK_FWD, images="images32",
                          budgets=FWD_BUDGETS, kernels=kernels, mesh=sp))

    def train(name, weights, family, args, batches, mesh=None, budget=None, step_idx=None,
              **trainer):
        case = dict(kind="train", name=name, weights=weights, family=family, args=args,
                    images="images16", lr=LR, batches=batches, mesh=mesh, budget=budget,
                    trainer=dict(sequence_parallel_devices=(mesh or sp)[1], **trainer))
        if step_idx is not None:
            case["step_idx"] = step_idx
        cases.append(case)

    two = [(0, 8), (0, 8)]
    train("train_vit", "vit", "vit", VIT, two)
    if world == 2:
        train("train_vit_pallas", "vit", "vit", VIT, two, parallel_kernels="pallas")
        train("train_rank", "rank_train", "rankvit", RANK_TRAIN, two, budget=0.5)
        train("train_rank_full", "rank_train", "rankvit", RANK_TRAIN, [(0, 8)])
        train("train_big", "vit", "vit", VIT, [(0, 8)])
        train("train_accum", "vit", "vit", VIT, [(0, 4), (4, 8)], step_idx=0,
              grad_accumulation=2)
    else:
        for kernels in ("xla", "pallas"):
            train(f"train_rank_{kernels}", "rank_train", "rankvit", RANK_TRAIN, two, budget=0.6,
                  parallel_kernels=kernels)
        train("train_dpsp", "vit", "vit", VIT, two, mesh=(2, 2))
    return cases


def _jax_train(family, args, tree, s, x, y, budget=None, mesh=None, kernels="auto"):
    """The JAX SP Trainer (SGD, two steps on the whole batch): losses and
    the params by path."""
    t = JaxTrainer(model=_jax_model(family, args, tree), optimizer=jax_optim.SGD(lr=LR),
                   fused=False, sequence_parallel_devices=s, mesh=mesh, parallel_kernels=kernels)
    if mesh is not None:
        x, y = shard_batch(x, mesh), shard_batch(y, mesh)
    losses = [float(t.train_step(x, y, budget=budget, step_idx=i)["total_loss"])
              for i in range(2)]
    leaves = jax.tree_util.tree_flatten_with_path(t.model.params)[0]
    return losses, {_path(p): np.asarray(leaf) for p, leaf in leaves}


def _join(ctx, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"SP ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _params(rank: dict, name: str) -> dict:
    prefix = f"{name}/param/"
    return {k[len(prefix):]: v for k, v in rank.items() if k.startswith(prefix)}


def _assert_params(got: dict, want: dict, tol: dict, what: str) -> None:
    assert set(got) == set(want), what
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], **tol, err_msg=f"{what}: {path}")


@pytest.mark.parametrize("world", [2, 4])
def test_sp_matches_jax(tmp_path, world):
    """One spawn of ``world`` gloo ranks runs every case of ``_cases``;
    every rank's outputs are bit-identical. The SP block against JAX's
    (``sequence_parallel_vit_block``, 8 tokens). The SP forward, both forms,
    ViT (N = 5 padded) and RankViT at budgets 1.0 / 0.6 / 0.3, against JAX's
    SP forward at S = world and the port's single-device model. The SP
    step against the JAX SP Trainer: ViT; at S = 2 the tail kernel's form
    (its plain version here) against JAX's and the XLA form, RankViT at
    budget 0.5 (which changes the step), grad_accumulation=2 against the
    big batch; at S = 4 RankViT at 0.6 in both forms (JAX's own
    test_sp_pallas_kernels_train_step) and dp x sp on a (2, 2) mesh.
    ``parallel_kernels="auto"`` resolves to "xla" on the CPU."""
    rng = np.random.default_rng(11)
    data = {"images16": rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
            "images32": rng.normal(size=(4, 32, 32, 3)).astype(np.float32)}
    labels = rng.integers(0, 10, 8).astype(np.int32)
    for key, arr in data.items():
        np.save(tmp_path / f"{key}.npy", arr)
    np.save(tmp_path / "labels.npy", labels)
    tokens = rng.normal(size=(2, 8, VIT["hidden_dim"])).astype(np.float32)
    np.save(tmp_path / "tokens.npy", tokens)
    trees = {}
    for key, (family, args, seed, _) in MODELS.items():
        trees[key] = _tree(family, args, seed)
        np.savez(tmp_path / f"{key}.npz",
                 **{k.replace("/", "."): v for k, v in tree_leaves(trees[key])})
    cases = _cases(world)
    ctx = mp.start_processes(torch_sp_worker.run, args=(world, str(tmp_path), cases),
                             nprocs=world, join=False, start_method="spawn")
    try:  # the references, computed while the ranks run
        want = {}
        jmesh = jax_make_mesh(n_data=1, n_model=world)
        want["block"] = np.asarray(jax_sp_block(
            jax.tree.map(jnp.asarray, trees["vit"]["encoder"]["layers_0"]), jnp.asarray(tokens),
            VIT["num_heads"], mesh=jmesh))
        for key in ("vit", "rank_fwd"):
            family, args, _, images = MODELS[key]
            jm = _jax_model(family, args, trees[key])
            single = params_from_jax(build_model(family, args, device="cpu"), trees[key])
            x = data[images]
            budgets = [None] if family == "vit" else FWD_BUDGETS
            fwd = {kernels: jax.jit(functools.partial(
                jax_sp_forward, num_heads=args["num_heads"], patch_size=args["patch_size"],
                mesh=jmesh, rankvit_layers=tuple(args.get("rankvit_layers", ())),
                kernels=kernels, interpret=True)) for kernels in ("xla", "pallas")}
            for budget in budgets:
                for kernels in ("xla", "pallas"):
                    want[(key, kernels, budget)] = np.asarray(
                        fwd[kernels](jm.params, jnp.asarray(x), budget=budget))
                with torch.no_grad():
                    out = (single(torch.from_numpy(x)) if family == "vit"
                           else single(torch.from_numpy(x), budget=budget))
                want[(key, "single", budget)] = out[0].numpy()
        x16, y = jnp.asarray(data["images16"]), jnp.asarray(labels)
        jax_steps = {"train_vit": _jax_train("vit", VIT, trees["vit"], world, x16, y)}
        if world == 2:
            jax_steps["train_vit_pallas"] = _jax_train("vit", VIT, trees["vit"], 2, x16, y,
                                                       kernels="pallas")
            jax_steps["train_rank"] = _jax_train("rankvit", RANK_TRAIN, trees["rank_train"], 2,
                                                 x16, y, budget=0.5)
        else:
            for kernels in ("xla", "pallas"):
                jax_steps[f"train_rank_{kernels}"] = _jax_train(
                    "rankvit", RANK_TRAIN, trees["rank_train"], 4, x16, y, budget=0.6,
                    kernels=kernels)
            jax_steps["train_dpsp"] = _jax_train("vit", VIT, trees["vit"], 2, x16, y,
                                                 mesh=jax_make_mesh(n_data=2, n_model=2))
    finally:
        _join(ctx, JOIN_TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for key in sorted(ranks[0]):
        for r in range(1, world):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r}: {key}")
    got = ranks[0]

    # the block (N = 8 tokens over the axis), and the forward in both forms
    np.testing.assert_allclose(got["block"], want["block"], **FWD_TOL, err_msg="block")
    for key, prefix in (("vit", "fwd_vit"), ("rank_fwd", "fwd_rank")):
        budgets = [None] if key == "vit" else FWD_BUDGETS
        for kernels in ("xla", "pallas"):
            for budget in budgets:
                logits = got[f"{prefix}_{kernels}/{budget}"]
                assert logits.shape == (data[MODELS[key][3]].shape[0], 10)
                np.testing.assert_allclose(logits, want[(key, kernels, budget)], **FWD_TOL,
                                           err_msg=f"{prefix} {kernels} {budget} against JAX")
                np.testing.assert_allclose(
                    logits, want[(key, "single", budget)],
                    **(FWD_TOL if kernels == "xla" else GELU_TOL),
                    err_msg=f"{prefix} {kernels} {budget} against the single-device model")
                fed = got.get(f"{prefix}_{kernels}/{budget}/fed_kept")
                assert (fed is not None) == (budget is not None)
                if fed is not None:  # kept= replays the ranking exactly
                    np.testing.assert_array_equal(fed, logits)

    # the step
    for name, (losses, params) in jax_steps.items():
        for i, loss in enumerate(losses):
            np.testing.assert_allclose(got[f"{name}/loss/{i}"], loss, **LOSS_TOL,
                                       err_msg=f"{name} loss {i}")
        _assert_params(_params(got, name), params, PARAM_TOL, name)
    pallas_pairs = ([("train_vit_pallas", "train_vit")] if world == 2
                    else [("train_rank_pallas", "train_rank_xla")])
    for pal, xla in pallas_pairs:
        assert str(got[f"{pal}/kernels"]) == "pallas" and str(got[f"{xla}/kernels"]) == "xla"
        for i in range(2):
            np.testing.assert_allclose(got[f"{pal}/loss/{i}"], got[f"{xla}/loss/{i}"],
                                       rtol=5e-3)
        _assert_params(_params(got, pal), _params(got, xla), GELU_TOL, f"{pal} against {xla}")
    if world == 2:
        assert abs(float(got["train_rank_full/loss/0"]) - float(got["train_rank/loss/0"])) > 0
        _assert_params(_params(got, "train_accum"), _params(got, "train_big"),
                       dict(rtol=2e-5, atol=1e-6), "grad_accumulation=2 against the big batch")


# ------------------------------------------------------------------ the guards


def _fake_mesh(n_data=1, n_model=2):
    """A mesh view with no process group: enough for every check that
    raises before a collective."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, None, None, 0, 0, torch.device("cpu"))


def test_sp_guards():
    x = np.zeros((4, 16, 16, 3), np.float32)
    y = np.zeros(4, np.int32)
    vit = build_model("vit", VIT, device="cpu")
    base = dict(optimizer=optim.SGD(lr=LR), device="cpu")
    with pytest.raises(ValueError, match="'model' axis has 2 devices but "
                                         "sequence_parallel_devices=4"):
        Trainer(model=vit, sequence_parallel_devices=4, mesh=_fake_mesh(1, 2),
                **base).train_step(x, y)
    with pytest.raises(ValueError, match="process group of 4 ranks .* have 1"):
        Trainer(model=vit, sequence_parallel_devices=4, **base).train_step(x, y)
    res = build_model("residualvit", dict(VIT, residual_layers=["attention+mlp"] * 2,
                                          gate_type="sigmoid", add_budget_token="learnable"),
                      device="cpu")
    # the gated ResidualViT's SP step is ported (tests/test_torch_pipeline.py):
    # the shipped-config model passes JAX's model check and needs its ranks
    with pytest.raises(ValueError, match="process group of 2 ranks .* have 1"):
        Trainer(model=res, sequence_parallel_devices=2, **base).train_step(x, y)
    with pytest.raises(NotImplementedError, match="supports ResidualViT in the shipped-config "
                                                  "mode"):
        Trainer(model=build_model("residualvit", dict(VIT, residual_layers=["attention+mlp"] * 2,
                                                      gate_type="gumbel",
                                                      add_budget_token="learnable"),
                                  device="cpu"),
                sequence_parallel_devices=2, **base).train_step(x, y)
    with pytest.raises(ValueError, match="parallel_kernels"):
        Trainer(model=vit, sequence_parallel_devices=2, parallel_kernels="cuda", **base)
    # mesh= without SP runs the module step, replicated over the model axis
    # (tests/test_torch_sharded_training.py); the fused path refuses it
    assert Trainer(model=vit, mesh=_fake_mesh(), fused=False, **base).fused is False
    with pytest.raises(NotImplementedError, match="shards over 'data' only"):
        Trainer(model=vit, mesh=_fake_mesh(), fused=True, **base).train_step(x, y)
    with pytest.raises(ValueError, match="kernels must be"):
        sequence_parallel_vit_forward({}, torch.zeros(1, 16, 16, 3), num_heads=2, patch_size=8,
                                      mesh=_fake_mesh(), kernels="cuda")
    # "auto" resolves from the shapes: the tail kernel needs head dim 32 or
    # 64 (at any number of padded keys: the key-tiled kernel past the kept
    # one's 704 masked keys), and a CUDA device
    trainer = Trainer(model=vit, sequence_parallel_devices=2, **base)
    assert trainer._sp_kernels(vit, 2) == "xla"
    trainer.device = torch.device("cuda")
    b16 = build_model("vit", dict(VIT, hidden_dim=128), device="cpu")  # 2 heads of 64
    assert trainer._sp_kernels(b16, 2) == "pallas"
    assert trainer._sp_kernels(vit, 2) == "xla"  # head dim 16
    big = build_model("vit", dict(VIT, hidden_dim=128, image_size=224), device="cpu")  # N 785
    assert trainer._sp_kernels(big, 2) == "pallas"
