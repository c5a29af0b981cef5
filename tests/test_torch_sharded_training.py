"""The port's sharded training against the JAX package's, on the CPU:
``Trainer(fsdp_sharded_params=True)``, ``Trainer(tensor_parallel=True)``
(the MoE experts split included) and ``zero_sharded_optimizer`` under
sequence parallelism, each in a spawn of gloo ranks of its own (one process
per rank, ``tests/torch_shard_worker.py``; one test function per world),
against JAX's Trainer in the same mode on the virtual 8-device mesh
(computed while the ranks run) and the port's replicated or single-device
step on the same global batch; every rank's outputs bit-identical. Then the
cheap single-process cases: the placement rules leaf by leaf against
JAX's, and JAX's guards with JAX's words. Inputs come from numpy with a
seed.

Tolerances: JAX's pins for these modes (tests/test_parallel.py:1042-1160):
loss rtol 1e-5 (atol 1e-6), parameters rtol = atol = 2e-5, against JAX's
step and the port's unsharded one. FSDP holds the replicated step's values
and gradients, so against the port's replicated step it is bit for bit
without clipping. ZeRO-1 under SP against the SP step without it bit for
bit (elementwise optimizers), against JAX's SP step at the SP tests' pins
(loss 1e-5 / 1e-6, parameters 1e-4, tests/test_torch_sp_training.py).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_shard_worker
from test_torch_dropout import _Recorder
from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.parallel import make_mesh as jax_make_mesh
from peekvit_tpu.parallel import shard_batch
from peekvit_tpu.parallel.mesh import _data_axis_spec as jax_data_axis_spec
from peekvit_tpu.parallel.mesh import param_spec as jax_param_spec
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils import losses as jax_losses
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import live_params, module_params, params_to_jax, tree_leaves
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.parallel.mesh import data_axis_spec, param_spec
from peekvit_torch.training import optim
from peekvit_torch.utils.checkpoint import save_state

JOIN_TIMEOUT = 240.0  # seconds for every rank to finish; a hung collective fails the test
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-5, atol=2e-5)
SP_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_parallel.py:_model, its gated ResidualViT and MoE
VIT = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
           num_classes=10)
RES = dict(VIT, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
           add_budget_token="learnable")
MOE = dict(VIT, mlp_moes=[2, 2], attn_moes=[1, 2])
AVIT = dict(VIT, gate_scale=10.0, gate_center=30.0)
DROP = dict(VIT, dropout=0.1, attention_dropout=0.1)
SPARSITY = {"sparsity": {"_target_": "peekvit.utils.losses.SparsityLoss", "weight": 0.2,
                         "sparsity_type": "l1"}}
SGD = ("SGD", dict(lr=0.05))
MOMENTUM = ("SGD", dict(lr=0.05, momentum=0.9))
# name -> (registry name, args, seed)
MODELS = {"vit": ("vit", VIT, 21), "res": ("residualvit", RES, 22), "moe": ("moevit", MOE, 23),
          "avit": ("adavit", AVIT, 24), "drop": ("vit", DROP, 25)}
SHARDING = ("fsdp_sharded_params", "tensor_parallel", "zero_sharded_optimizer")


def _tree(family, args, seed):
    """The port's seeded param tree as JAX's (numpy), with a random head and
    class tokens (a zero-initialised head gives every logit 0)."""
    tree = params_to_jax(build_model(family, args, seed=seed, device="cpu"))
    rng = np.random.default_rng(seed + 100)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    key = "class_tokens" if "class_tokens" in tree else "class_token"
    tree[key][:] = rng.normal(0, 0.3, tree[key].shape)
    return tree


def _jax_model(family, args, tree):
    return JaxModel(module=resolve_model_class(family)(**args),
                    params=jax.tree.map(jnp.asarray, tree), model_class=family, model_args=args)


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


def _case(name, weights, trainer, optimizer=SGD, steps=(0, 1), **kw):
    family, args, _ = MODELS[weights]
    return dict(name=name, weights=weights, family=family, args=args, images="images",
                trainer=trainer, optimizer=optimizer, steps=list(steps), **kw)


def _unsharded(case):
    """The case on one device: the sharding options dropped."""
    trainer = {k: v for k, v in case["trainer"].items() if k not in SHARDING}
    return dict(case, trainer=trainer, single=True, ckpt=False)


def _jax_step(case, tree, x, y, jmesh, patches=None, **kw) -> tuple:
    """JAX's Trainer on ``case`` (its optimizer and steps, ``kw`` its mode):
    the losses and the parameters by path."""
    family, args, _ = MODELS[case["weights"]]
    opt_name, opt_kw = case["optimizer"]
    compose = case["trainer"].get("loss_compose")
    t = JaxTrainer(model=_jax_model(family, args, tree),
                   optimizer=getattr(jax_optim, opt_name)(**opt_kw), mesh=jmesh,
                   loss_compose=jax_losses.LossCompose(compose) if compose else None, **kw)
    xd, yd = (shard_batch(jnp.asarray(x), jmesh), shard_batch(jnp.asarray(y), jmesh))
    with pytest.MonkeyPatch.context() as patch:
        for attr, fn in (patches or {}).items():
            patch.setattr(jax.random, attr, fn)
        losses = [float(t.train_step(xd, yd, budget=case.get("budget"), step_idx=i)["total_loss"])
                  for i in case["steps"]]
    return losses, {_path(p): np.asarray(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(t.model.params)[0]}


def _join(ctx, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _data():
    """The global batch: 8 images and their labels."""
    rng = np.random.default_rng(5)
    return (rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
            (np.arange(8) % 10).astype(np.int64))


def _spawn(tmp_path, mesh_shape, cases, references):
    """Save the inputs, spawn the ranks of ``mesh_shape``, run
    ``references(trees, x, y)`` meanwhile; (every rank's outputs, the
    references), the outputs checked bit-identical over the ranks first."""
    x, y = _data()
    np.save(tmp_path / "images.npy", x)
    np.save(tmp_path / "labels.npy", y)
    trees = {}
    for key in {c["weights"] for c in cases}:
        trees[key] = _tree(*MODELS[key])
        np.savez(tmp_path / f"{key}.npz",
                 **{k.replace("/", "."): v for k, v in tree_leaves(trees[key])})
    world = mesh_shape[0] * mesh_shape[1]
    ctx = mp.start_processes(torch_shard_worker.run,
                             args=(world, str(tmp_path), mesh_shape, cases),
                             nprocs=world, join=False, start_method="spawn")
    try:  # the references, computed while the ranks run
        want = references(trees, x, y)
    finally:
        _join(ctx, JOIN_TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    for key in sorted(ranks[0]):
        if "/held_bytes" in key or "/opt_bytes" in key:
            continue  # a rank's own share
        for r in range(1, world):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r}: {key}")
    return ranks, want


def _single(tmp_path, case, x, y) -> dict:
    return torch_shard_worker.train_case(str(tmp_path), _unsharded(case), x, y)


def _params(out: dict, name: str, what: str = "param") -> dict:
    prefix = f"{name}/{what}/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _losses(out: dict, name: str, steps: int) -> list:
    return [float(out[f"{name}/total_loss/{i}"]) for i in range(steps)]


def _assert_params(got: dict, want: dict, what: str, **tol) -> None:
    assert set(got) == set(want), what
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], **tol, err_msg=f"{what}: {path}")


def _assert_step(got: dict, name: str, steps: int, want_losses, want_params, what, loss_tol,
                 param_tol, want_eval=None) -> None:
    """The losses and parameters of run ``name`` against ``what``'s; with
    ``want_eval``, its eval step's (correct count, loss) after the steps."""
    np.testing.assert_allclose(_losses(got, name, steps), want_losses, **loss_tol,
                               err_msg=f"{name} losses against {what}")
    _assert_params(_params(got, name), want_params, f"{name} against {what}", **param_tol)
    if want_eval is not None:
        assert got[f"{name}/eval"][0] == want_eval[0], f"{name} eval correct against {what}"
        np.testing.assert_allclose(got[f"{name}/eval"][1], want_eval[1], **loss_tol,
                                   err_msg=f"{name} eval loss against {what}")


def _assert_held(ranks: list, name: str, n: int) -> None:
    """Each rank holds the whole leaves and 1/n of the split ones."""
    for r, rank in enumerate(ranks):
        whole = int(rank[f"{name}/whole_bytes"])
        split = float(rank[f"{name}/split/after"]) * whole
        assert abs(int(rank[f"{name}/held_bytes"]) - (whole - split + split / n)) < 8, (name, r)


def _assert_checkpoint(got: dict, name: str) -> None:
    """The checkpoint loads byte for byte into one device and back into a
    sharded Trainer."""
    trained = _params(got, name)
    for what in ("ckpt_single", "ckpt_sharded"):
        loaded = _params(got, name, what)
        assert set(loaded) == set(trained), what
        for path, leaf in trained.items():
            np.testing.assert_array_equal(loaded[path], leaf, err_msg=f"{name} {what}: {path}")


# ---------------------------------------------------------------- the worlds


def test_fsdp_matches_jax_and_replicated(tmp_path):
    """FSDP on a (2, 1) mesh: the ViT (SGD, two steps), the gated
    ResidualViT with the sparsity regularizer (SGD, budget 0.6, one step;
    JAX's test_fsdp_gated_residualvit_with_regularizers) against JAX's FSDP
    Trainer and the port's replicated dp step; Adam with clipping and QAT
    against the replicated step. Each rank holds half of every divisible
    leaf (> 0.9 of the model's elements, before and after the steps) and of
    its optimizer state; the checkpoint round trip."""
    fsdp = dict(fused=False, fsdp_sharded_params=True)
    cases = [_case("vit", "vit", fsdp, ckpt=True),
             _case("res", "res", dict(fsdp, loss_compose=SPARSITY), steps=(0,), budget=0.6),
             _case("adam", "vit", dict(fsdp, clip_grad_norm=1.0), ("Adam", dict(lr=1e-2))),
             _case("qat", "vit", dict(fsdp, qat=True), steps=(0,))]
    cases += [dict(c, name=f"rep_{c['name']}", ckpt=False,
                   trainer={k: v for k, v in c["trainer"].items() if k != "fsdp_sharded_params"})
              for c in list(cases)]

    def references(trees, x, y):
        jmesh = jax_make_mesh(n_data=2, n_model=1)
        return {name: _jax_step(cases[i], trees[cases[i]["weights"]], x, y, jmesh,
                                fsdp_sharded_params=True)
                for i, name in ((0, "vit"), (1, "res"))}

    ranks, jax_steps = _spawn(tmp_path, (2, 1), cases, references)
    got = ranks[0]
    exact = dict(rtol=0, atol=0)
    for case in cases[:4]:
        name, steps = case["name"], len(case["steps"])
        assert str(got[f"{name}/kind"]) == "module"
        # bit for bit but with clipping, whose global norm is summed per slice
        loss_tol, param_tol = (LOSS_TOL, PARAM_TOL) if name == "adam" else (exact, exact)
        _assert_step(got, name, steps, _losses(got, f"rep_{name}", steps),
                     _params(got, f"rep_{name}"), "the replicated dp step", loss_tol, param_tol,
                     got[f"rep_{name}/eval"])
        if name in jax_steps:
            _assert_step(got, name, steps, *jax_steps[name], "JAX's FSDP Trainer", LOSS_TOL,
                         PARAM_TOL)
        for when in ("before", "after"):
            assert float(got[f"{name}/split/{when}"]) > 0.9, (name, when)
        _assert_held(ranks, name, 2)
    assert "sparsity" in " ".join(k for k in got if k.startswith("res/"))
    assert int(got["adam/opt_bytes"]) < 0.55 * int(got["rep_adam/opt_bytes"])
    _assert_checkpoint(got, "vit")


def test_tensor_parallel_matches_jax_and_single_device(tmp_path):
    """tensor_parallel=True on a (2, 2) mesh: the ViT (SGD with momentum,
    two steps) and the ViT at dropout and attention dropout 0.1 (JAX's masks
    replayed) against JAX's TP Trainer and the port's single-device step on
    the same global batch; each rank holds its share of the split leaves and
    of the momentum; ZeRO-1 over the data axis of the TP step (as JAX
    composes them) bit-equal to it, half its momentum a rank; the
    checkpoint round trip."""
    tp = dict(fused=False, tensor_parallel=True)
    cases = [_case("vit", "vit", tp, MOMENTUM, ckpt=True),
             _case("drop", "drop", tp, masks="masks"),
             _case("zero", "vit", dict(tp, zero_sharded_optimizer=True), MOMENTUM)]
    x, y = _data()
    jmesh = jax_make_mesh(n_data=2, n_model=2)
    # the masks come from JAX's trace (the global batch's, every head),
    # before the ranks start
    recorder = _Recorder(3)
    drop = _jax_step(cases[1], _tree(*MODELS["drop"]), x, y, jmesh,
                     patches={"bernoulli": recorder}, tensor_parallel=True)
    assert any(m.shape[:2] == (8, 2) and m.ndim == 4 for m in recorder.masks)
    np.savez(tmp_path / "masks.npz", **{f"m{i}": m for i, m in enumerate(recorder.masks)})

    def references(trees, x, y):
        return {"vit": _jax_step(cases[0], trees["vit"], x, y, jmesh, tensor_parallel=True),
                "drop": drop}

    ranks, jax_steps = _spawn(tmp_path, (2, 2), cases, references)
    got = ranks[0]
    for case in cases[:2]:
        name, steps = case["name"], len(case["steps"])
        assert str(got[f"{name}/kind"]) == "module"
        single = _single(tmp_path, case, x, y)
        _assert_step(got, name, steps, _losses(single, name, steps), _params(single, name),
                     "the single-device step", LOSS_TOL, PARAM_TOL, single[f"{name}/eval"])
        _assert_step(got, name, steps, *jax_steps[name], "JAX's TP Trainer", LOSS_TOL, PARAM_TOL)
    _assert_held(ranks, "vit", 2)
    for rank in ranks:  # the momentum of what the rank holds; ZeRO's half of it
        assert int(rank["vit/opt_bytes"]) == int(rank["vit/held_bytes"])
        assert int(rank["zero/opt_bytes"]) < 0.55 * int(rank["vit/opt_bytes"])
    exact = dict(rtol=0, atol=0)
    _assert_step(got, "zero", 2, _losses(got, "vit", 2), _params(got, "vit"), "the TP step",
                 exact, exact)
    _assert_checkpoint(got, "vit")


def test_moe_expert_sharding_matches_jax(tmp_path):
    """tensor_parallel=True on a (1, 2) mesh: the MoE (two MLP experts a
    layer split over the model axis, a stack of two attention experts whose
    in-projection bias JAX's rule splits) with the Gumbel draws fed, against
    JAX's TP Trainer and the port's single-device step; A-ViT (its stacked
    biases split on the layer axis, gathered in front of the forward)
    against the single device."""
    tp = dict(fused=False, tensor_parallel=True)
    cases = [_case("moe", "moe", tp, MOMENTUM, gumbel="gumbel"), _case("avit", "avit", tp)]
    rng = np.random.default_rng(7)
    # per step: layer 0's MLP gate, then layer 1's attention and MLP gates
    draws = [rng.gumbel(size=(8, 5, 2)).astype(np.float32) for _ in range(3)]
    np.savez(tmp_path / "gumbel.npz", **{f"m{i}": m for i, m in enumerate(draws)})

    def references(trees, x, y):
        jmesh = jax_make_mesh(n_data=1, n_model=2)
        it = iter(draws * 2)
        return {"moe": _jax_step(cases[0], trees["moe"], x, y, jmesh, patches={
            "gumbel": lambda key, shape, dtype=jnp.float32: jnp.asarray(next(it))},
            tensor_parallel=True)}

    ranks, jax_steps = _spawn(tmp_path, (1, 2), cases, references)
    got = ranks[0]
    x, y = _data()
    for case in cases:
        name, steps = case["name"], len(case["steps"])
        single = _single(tmp_path, case, x, y)
        _assert_step(got, name, steps, _losses(single, name, steps), _params(single, name),
                     "the single-device step", LOSS_TOL, PARAM_TOL, single[f"{name}/eval"])
    _assert_step(got, "moe", 2, *jax_steps["moe"], "JAX's TP Trainer", LOSS_TOL, PARAM_TOL)
    for name in ("moe", "avit"):
        assert 0 < float(got[f"{name}/split/after"]) < 1
        _assert_held(ranks, name, 2)


def test_zero_under_sp_matches_sp_and_jax(tmp_path):
    """zero_sharded_optimizer with sequence_parallel_devices=2 on a (2, 2)
    mesh (SGD with momentum, two steps): bit-equal to the same SP step
    without ZeRO, against JAX's SP Trainer on the (2, 2) mesh with ZeRO at
    the SP pins; each rank holds half of the momentum."""
    sp = dict(fused=False, sequence_parallel_devices=2)
    cases = [_case("zero", "vit", dict(sp, zero_sharded_optimizer=True), MOMENTUM),
             _case("rep", "vit", sp, MOMENTUM)]

    def references(trees, x, y):
        return {"zero": _jax_step(cases[0], trees["vit"], x, y,
                                  jax_make_mesh(n_data=2, n_model=2), fused=False,
                                  sequence_parallel_devices=2, zero_sharded_optimizer=True)}

    ranks, jax_steps = _spawn(tmp_path, (2, 2), cases, references)
    got = ranks[0]
    assert str(got["zero/kind"]) == "sp"
    _assert_step(got, "zero", 2, _losses(got, "rep", 2), _params(got, "rep"),
                 "the SP step without ZeRO", dict(rtol=0, atol=0), dict(rtol=0, atol=0))
    _assert_step(got, "zero", 2, *jax_steps["zero"], "JAX's SP Trainer", LOSS_TOL, SP_PARAM_TOL)
    for rank in ranks:
        assert int(rank["zero/opt_bytes"]) < 0.55 * int(rank["rep/opt_bytes"])


# ------------------------------------------------------------ single process


@pytest.mark.parametrize("family,args", [("vit", VIT), ("residualvit", RES), ("adavit", AVIT),
                                         ("maevit", dict(VIT, mask_ratio=0.75,
                                                         decoder_hidden_dim=16,
                                                         decoder_mlp_dim=32,
                                                         num_decoder_layers=1,
                                                         num_decoder_heads=2)),
                                         ("moevit", MOE)])
def test_placement_rules_match_jax(family, args):
    """``param_spec`` (JAX's with ``tensor_parallel=True``) and
    ``data_axis_spec`` (at 2, 4 and 8) against JAX's on every leaf of the
    tree."""
    leaves = tree_leaves(live_params(build_model(family, args, device="cpu")))
    split = 0
    for path, p in leaves:
        want = tuple(jax_param_spec(path, p.dim(), True))
        assert param_spec(path, p.dim()) == want, path
        split += bool(want)
        for n in (2, 4, 8):
            want = tuple(jax_data_axis_spec(np.zeros(tuple(p.shape)), n))
            assert data_axis_spec(tuple(p.shape), n) == want, (path, n)
    assert split  # every family has a leaf the rules split


def _fake_mesh(n_data=2, n_model=1):
    """A mesh view with no process group: enough for every check that
    raises before a collective."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, None, None, 0, 0, torch.device("cpu"))


@pytest.mark.parametrize("kwargs,mesh", [
    (dict(tensor_parallel=True), None),
    (dict(tensor_parallel=True), (2, 1)),
    (dict(tensor_parallel=True, fsdp_sharded_params=True), (1, 2)),
    (dict(tensor_parallel=True, sequence_parallel_devices=2), (1, 2)),
    (dict(fsdp_sharded_params=True), None),
    (dict(fsdp_sharded_params=True, sequence_parallel_devices=2), (1, 2)),
    (dict(fsdp_sharded_params=True, pipeline_stages=2), (2, 1)),
    (dict(zero_sharded_optimizer=True), None),
    (dict(fused=True), (1, 2)),
])
def test_guards_match_jax(kwargs, mesh):
    """Each guard raises JAX's exception with JAX's message: the Trainer on
    the same options over a mesh of the same shape (the fused path's at the
    first step, as in JAX)."""
    x, y = np.zeros((2, 16, 16, 3), np.float32), np.zeros(2, np.int64)
    tree = _tree(*MODELS["vit"])
    jmesh = None if mesh is None else jax_make_mesh(n_data=mesh[0], n_model=mesh[1])
    with pytest.raises((ValueError, NotImplementedError)) as want:
        JaxTrainer(model=_jax_model("vit", VIT, tree), optimizer=jax_optim.SGD(lr=0.1),
                   mesh=jmesh, **kwargs).train_step(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(want.type) as got:
        Trainer(model=build_model("vit", VIT, device="cpu"), optimizer=optim.SGD(lr=0.1),
                device="cpu", mesh=None if mesh is None else _fake_mesh(*mesh),
                **kwargs).train_step(x, y)
    assert str(got.value) == str(want.value)


def test_placement_on_construction():
    """FSDP and TP place the parameters at construction (no collective
    yet): the fused path coerced off; FSDP empties each split leaf's
    parameter and holds half; TP swaps in the Megatron forms holding this
    rank's heads and columns; QAT under TP is refused (ROADMAP item 9)."""
    fsdp = Trainer(model=build_model("vit", VIT, device="cpu"), optimizer=optim.SGD(lr=0.1),
                   device="cpu", mesh=_fake_mesh(), fsdp_sharded_params=True, fused=True)
    assert fsdp.fused is False and fsdp._shards.held_bytes() < 0.55 * fsdp._shards.whole_bytes()
    assert fsdp.model.encoder.layers_0.mlp.fc1_kernel.numel() == 0
    model = build_model("vit", VIT, device="cpu")
    tp = Trainer(model=model, optimizer=optim.SGD(lr=0.1), device="cpu",
                 mesh=Mesh({DATA_AXIS: 1, MODEL_AXIS: 2}, None, None, 0, 1, torch.device("cpu")),
                 tensor_parallel=True)
    attn = model.encoder.layers_0.self_attention
    assert type(attn).__name__ == "TPSelfAttention" and attn.num_heads == 1
    assert tuple(attn.in_proj_kernel.shape) == (32, 48)
    assert tuple(model.encoder.layers_0.mlp.fc2_kernel.shape) == (32, 32)
    assert tp.fused is False and 0.6 < tp._shards.split_fraction() < 1  # the LNs, embed, head whole
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(model=build_model("vit", VIT, device="cpu"), optimizer=optim.SGD(lr=0.1),
                device="cpu", mesh=_fake_mesh(1, 2), tensor_parallel=True, qat=True)


@pytest.mark.parametrize("how,mesh", [("fsdp_sharded_params", (2, 1)),
                                      ("tensor_parallel", (1, 2))])
def test_sharded_model_refuses_whole_reads(how, mesh, tmp_path):
    """Once a Trainer shards the model, every read or load of its
    parameters as a whole model raises, naming the Trainer's whole-leaf
    reads; ``Trainer.params`` is this rank's share, the tree its optimizer
    steps."""
    model = build_model("vit", VIT, device="cpu")
    trainer = Trainer(model=model, optimizer=optim.SGD(lr=0.1), device="cpu",
                      mesh=_fake_mesh(*mesh), **{how: True})
    reads = [lambda: live_params(model), lambda: module_params(model),
             lambda: params_to_jax(model), model.state_dict,
             lambda: model.load_state_dict({}), lambda: save_state(str(tmp_path), model)]
    for read in reads:
        with pytest.raises(ValueError, match=rf"Trainer\({how}=True\).*gathered_params"):
            read()
    local = dict(tree_leaves(trainer.params))
    assert [id(p) for p in local.values()] == [id(p) for _, p in
                                              tree_leaves(trainer._shards.local_tree())]
    # the whole (32, 64) leaf: FSDP's first dimension, TP's columns
    assert tuple(local["encoder/layers_0/mlp/fc1_kernel"].shape) == \
        ((32, 32) if how == "tensor_parallel" else (16, 64))
