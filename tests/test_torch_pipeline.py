"""The port's pipeline-parallel training (``parallel/pipeline.py``,
``Trainer(pipeline_stages=...)``) and the gated ResidualViT's pipeline and
sequence-parallel forwards (``parallel/residual.py``) against the JAX
package's, on the CPU. One spawn of 4 gloo ranks (one process a rank,
``tests/torch_pipeline_worker.py``) builds the (1, 4) and (2, 2) meshes it
needs and runs every multi-rank case; the JAX references run on the
virtual 8-device mesh meanwhile. Every rank's outputs are bit-identical.
Then the cheap single-process cases: the bubble, the stacking, and JAX's
guards with JAX's exception types and words. Inputs come from numpy with a
seed, at JAX's test widths (tests/test_parallel.py ``_pp_model``,
``_res_model``).

Tolerances are JAX's pins (tests/test_parallel.py): ``pipeline_forward``
1e-5 (:237-270); the pipelined forward 1e-4 / 1e-5 and its gradients 1e-5
/ 1e-6 (:305-347); the steps' losses 1e-5 / 1e-6 and parameters 1e-4
(:350-372, :469-497, :665-747); the gated forwards and masks 1e-4 / 1e-5
(:613-720); the ``"pallas"`` step against the ``"xla"`` one 5e-3 (the tanh
against the erf gelu, :794-815). The ``"pallas"`` forward and gradients
against JAX's ``"pallas"`` form (its Pallas attention in interpret mode)
at the fp32 kernel pin 2e-4: both take the tanh gelu, so the gap is the
order of the sums.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh as JaxMesh

import torch_pipeline_worker
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.models.vit import ViTBlock
from peekvit_tpu.parallel import make_mesh as jax_make_mesh
from peekvit_tpu.parallel import pipeline as jpp
from peekvit_tpu.parallel import residual as jres
from peekvit_tpu.parallel import shard_batch
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils import losses as jax_losses
from peekvit_torch import Trainer, build_model
from peekvit_torch.models.adapters import params_from_jax, tree_leaves
from peekvit_torch.parallel import DATA_AXIS, STAGE_AXIS, Mesh, pipeline, residual
from peekvit_torch.parallel import stack_stage_params
from peekvit_torch.training import optim

WORLD = 4
JOIN_TIMEOUT = 240.0  # seconds for every rank to finish; a hung collective fails the test
LR = 0.05
SGD = ("SGD", dict(lr=LR))
MOMENTUM = ("SGD", dict(lr=LR, momentum=0.9))
# tests/test_parallel.py:_pp_model and _res_model
VIT = dict(image_size=16, patch_size=8, num_layers=4, num_heads=2, hidden_dim=32, mlp_dim=64,
           num_classes=10)
RES = dict(VIT, residual_layers=["attention+mlp"] * 4, gate_type="sigmoid", gate_bias=0.0,
           add_budget_token="learnable")
RANK = dict(VIT, rankvit_layers=[1])
SPARSITY = {"sparsity": {"_target_": "peekvit.utils.losses.SparsityLoss", "weight": 0.2,
                         "sparsity_type": "l1"}}
JAX_SPARSITY = {"sparsity": dict(SPARSITY["sparsity"],
                                 _target_="peekvit_tpu.utils.losses.SparsityLoss")}
BUDGET = 0.6
# name -> (registry name, args, seed)
MODELS = {"vit": ("vit", VIT, 11), "res": ("residualvit", RES, 17), "rank": ("rankvit", RANK, 13)}
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
GELU_TOL = dict(rtol=5e-3, atol=5e-3)
KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
STAGE = (1, WORLD, STAGE_AXIS)
DPPP = (2, 2, STAGE_AXIS)
SP = (1, WORLD, "model")
DPSP = (2, 2, "model")


def _tree(family, args, seed):
    """A seeded JAX param tree (numpy) with a random head and class tokens
    (a zero-initialised head makes every gradient but the head's 0)."""
    jm = jax_build_model(family, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    return tree


def _jax_model(key, tree):
    family, args, _ = MODELS[key]
    jm = jax_build_model(family, args, seed=0)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return jm


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


def _by_path(tree) -> dict:
    return {_path(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _data():
    """tests/test_parallel.py:_data(8)."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(8, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 10, 8).astype(np.int32))


def _jax_mesh(shape, names):
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _case(kind, name, weights, **kw):
    family, args, _ = MODELS[weights]
    return dict(kind=kind, name=name, weights=weights, family=family, args=args, **kw)


def _train(name, weights, mesh=None, optimizer=SGD, steps=2, budget=..., **trainer):
    """A train case: the gated ResidualViT with the sparsity regularizer,
    at ``BUDGET`` unless ``budget`` says otherwise (None: drawn)."""
    if weights == "res":
        trainer.setdefault("loss_compose", SPARSITY)
    if budget is ...:
        budget = BUDGET if weights == "res" else None
    case = _case("train", name, weights, mesh=mesh, optimizer=optimizer,
                 steps=list(range(steps)), budget=budget)
    if "refused_budget" in trainer:
        case["refused_budget"] = trainer.pop("refused_budget")
    return dict(case, trainer=dict(fused=False, **trainer))


def _cases() -> list:
    pp4 = dict(pipeline_stages=WORLD)
    return [
        dict(kind="pipeline", name="blocks", mesh=STAGE, heads=4, microbatches=4),
        _case("forward", "fwd_xla", "vit", mesh=STAGE, microbatches=4, kernels="xla"),
        _case("forward", "fwd_pallas", "vit", mesh=STAGE, microbatches=4, kernels="pallas"),
        _train("pp", "vit", steps=3, pipeline_microbatches=4, **pp4),
        _train("pp_pallas", "vit", steps=3, pipeline_microbatches=8, parallel_kernels="pallas",
               **pp4),
        _train("dppp", "vit", DPPP, MOMENTUM, pipeline_stages=2, pipeline_microbatches=2),
        _train("dppp_zero", "vit", DPPP, MOMENTUM, pipeline_stages=2, pipeline_microbatches=2,
               zero_sharded_optimizer=True),
        _train("rank", "rank", steps=1, refused_budget=0.5, pipeline_microbatches=8, **pp4),
        _case("gated", "g_pp", "res", mesh=STAGE, form="pipeline", microbatches=4,
              budget=BUDGET),
        _case("gated", "g_sp", "res", mesh=SP, form="sp", budget=0.4),
        _case("gated", "g_dppp", "res", mesh=DPPP, form="pipeline", microbatches=2,
              data_axis=DATA_AXIS, budget=BUDGET),
        _case("gated", "g_dpsp", "res", mesh=DPSP, form="sp", data_axis=DATA_AXIS,
              budget=BUDGET),
        _train("res_pp", "res", pipeline_microbatches=4, **pp4),
        _train("res_sp", "res", sequence_parallel_devices=WORLD),
        _train("res_dppp", "res", DPPP, pipeline_stages=2, pipeline_microbatches=2),
        _train("res_free", "res", steps=1, budget=None, pipeline_microbatches=8, **pp4),
    ]


def _join(ctx, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"pipeline ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _jax_trainer_run(key, tree, x, y, steps, mesh=None, optimizer=SGD, budget=None, **kw):
    """JAX's Trainer (``fused=False``): the losses, the metric names and
    the parameters by path."""
    compose = jax_losses.LossCompose(JAX_SPARSITY) if key == "res" else None
    t = JaxTrainer(model=_jax_model(key, tree),
                   optimizer=getattr(jax_optim, optimizer[0])(**optimizer[1]), fused=False,
                   loss_compose=compose, mesh=mesh, **kw)
    xd, yd = ((shard_batch(jnp.asarray(x), mesh), shard_batch(jnp.asarray(y), mesh))
              if mesh is not None else (jnp.asarray(x), jnp.asarray(y)))
    metrics = [t.train_step(xd, yd, budget=budget, step_idx=i) for i in range(steps)]
    return ([float(m["total_loss"]) for m in metrics], sorted(metrics[0]),
            _by_path(t.model.params))


def _jax_references(trees, blocks, tokens, x, y) -> dict:
    """Every JAX reference of the spawn's cases."""
    want = {}
    stage4 = _jax_mesh((WORLD,), ("stage",))
    dppp = _jax_mesh((2, 2), ("data", "stage"))
    block = ViTBlock(num_heads=4, hidden_dim=32, mlp_dim=64)
    per_stage = [jax.tree.map(jnp.asarray, blocks[i]) for i in range(WORLD)]
    want["blocks"] = np.asarray(jax.jit(lambda ps, t: jpp.pipeline_forward(
        lambda p, a: block.apply({"params": p}, a), jpp.stack_stage_params(ps), t, mesh=stage4,
        num_microbatches=4))(per_stage, jnp.asarray(tokens)))
    seq = jnp.asarray(tokens)
    for p in per_stage:
        seq = block.apply({"params": p}, seq)
    want["blocks_sequential"] = np.asarray(seq)

    params = jax.tree.map(jnp.asarray, trees["vit"])
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def ce(logits):
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, yj[:, None], 1))

    for kernels in ("xla", "pallas"):
        def fwd(p, kernels=kernels):
            return jpp.pipelined_vit_forward(p, xj, mesh=stage4, num_microbatches=4,
                                             num_heads=2, patch_size=8, kernels=kernels,
                                             interpret=True)
        logits, vjp = jax.vjp(jax.jit(fwd), params)
        g = jax.grad(lambda lg: ce(lg))(logits)
        want[f"fwd_{kernels}"] = (np.asarray(logits), _by_path(vjp(g)[0]))

    want["pp"] = _jax_trainer_run("vit", trees["vit"], x, y, 3, pipeline_stages=WORLD,
                                  pipeline_microbatches=4)
    want["dppp"] = _jax_trainer_run("vit", trees["vit"], x, y, 2, mesh=dppp, optimizer=MOMENTUM,
                                    pipeline_stages=2, pipeline_microbatches=2)

    rp = jax.tree.map(jnp.asarray, trees["res"])
    gate = dict(num_heads=2, patch_size=8, gate_temp=1.0, gate_bias=0.0,
                budget_token="learnable")
    for name, fwd, b, kw in (
            ("g_pp", jres.pipelined_residualvit_forward, BUDGET,
             dict(mesh=stage4, num_microbatches=4)),
            ("g_sp", jres.sequence_parallel_residualvit_forward, 0.4,
             dict(mesh=jax_make_mesh(n_data=1, n_model=WORLD))),
            ("g_dppp", jres.pipelined_residualvit_forward, BUDGET,
             dict(mesh=dppp, num_microbatches=2, data_axis="data")),
            ("g_dpsp", jres.sequence_parallel_residualvit_forward, BUDGET,
             dict(mesh=jax_make_mesh(n_data=2, n_model=2), data_axis="data"))):
        want[name] = jax.jit(lambda p, im, bv, fwd=fwd, kw=kw: fwd(p, im, bv, **gate, **kw))(
            rp, xj, jnp.full((8,), b, jnp.float32))
    # the gated steps of every mode against JAX's pipeline step (JAX's own
    # tests hold each mode to the same single-device step at these pins)
    want["res_pp"] = _jax_trainer_run("res", trees["res"], x, y, 2, pipeline_stages=WORLD,
                                      pipeline_microbatches=4, budget=BUDGET)
    return want


def _port_single(key, tree, x, y, steps, budget=None) -> tuple:
    """The port's single-device module step: losses and parameters."""
    from peekvit_torch.utils.losses import LossCompose

    family, args, _ = MODELS[key]
    model = params_from_jax(build_model(family, args, device="cpu"), tree)
    t = Trainer(model=model, optimizer=optim.SGD(lr=LR), fused=False, device="cpu",
                loss_compose=LossCompose(SPARSITY) if key == "res" else None)
    losses = [float(t.train_step(x, y, budget=budget, step_idx=i)["total_loss"])
              for i in range(steps)]
    return losses, {k: v.detach().numpy() for k, v in tree_leaves(_params_of(model))}


def _params_of(model):
    from peekvit_torch.models.adapters import module_params

    return module_params(model)


def _got(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_tree(got: dict, want: dict, tol: dict, what: str) -> None:
    assert set(got) == set(want), what
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], **tol, err_msg=f"{what}: {path}")


def _assert_train(got: dict, name: str, want, what: str, loss_tol=LOSS_TOL,
                  param_tol=PARAM_TOL) -> None:
    losses, _, params = want
    np.testing.assert_allclose([float(got[f"{name}/total_loss/{i}"]) for i in range(len(losses))],
                               losses, **loss_tol, err_msg=f"{name} losses against {what}")
    _assert_tree(_got(got, f"{name}/param/"), params, param_tol, f"{name} against {what}")


def test_pipeline_matches_jax(tmp_path):
    """One spawn of 4 gloo ranks runs every case of ``_cases``; every rank's
    outputs are bit-identical. ``pipeline_forward`` on four ViTBlock stages
    against JAX's and the blocks in order; ``pipelined_vit_forward``, both
    forms, with its gradients, against JAX's (the ``"pallas"`` form against
    JAX's Pallas form); the pipeline Trainer (3 SGD steps, M = 4: the
    bubble warning) against JAX's and the port's single-device step; the
    ``"pallas"`` step (M = 8: no warning) against JAX's ``"xla"`` step; dp
    x pp on (2, 2) with momentum against JAX's Trainer on a (data, stage)
    mesh, and ZeRO-1 on it bit-equal to it; a RankViT refusing a budget in
    JAX's words and training without one; the gated ResidualViT's
    pipeline, SP, dp x pp and dp x sp forwards and masks against JAX's, its
    pipeline, SP and dp x pp steps with the sparsity regularizer against
    JAX's Trainer, and its pipeline step with per-sample budgets (none
    given) against the port's single-device step of the same generator."""
    x, y = _data()
    np.save(tmp_path / "images.npy", x)
    np.save(tmp_path / "labels.npy", y)
    trees = {key: _tree(*MODELS[key]) for key in MODELS}
    for key, tree in trees.items():
        np.savez(tmp_path / f"{key}.npz", **{k.replace("/", "."): v for k, v in tree_leaves(tree)})
    rng = np.random.default_rng(31)
    tokens = rng.normal(size=(8, 9, 32)).astype(np.float32)
    np.save(tmp_path / "tokens.npy", tokens)
    block = ViTBlock(num_heads=4, hidden_dim=32, mlp_dim=64)
    blocks = [jax.tree.map(np.asarray, block.init(jax.random.key(100 + i),
                                                  jnp.asarray(tokens[:1]))["params"])
              for i in range(WORLD)]
    np.savez(tmp_path / "blocks.npz", **{f"{i}.{k.replace('/', '.')}": v
                                         for i, b in enumerate(blocks)
                                         for k, v in tree_leaves(b)})
    ctx = mp.start_processes(torch_pipeline_worker.run,
                             args=(WORLD, str(tmp_path), _cases()), nprocs=WORLD, join=False,
                             start_method="spawn")
    try:  # the references, computed while the ranks run
        want = _jax_references(trees, blocks, tokens, x, y)
        want["single_pp"] = _port_single("vit", trees["vit"], x, y, 3)
        want["single_res_free"] = _port_single("res", trees["res"], x, y, 1)
    finally:
        _join(ctx, JOIN_TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    for key in sorted(ranks[0]):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r}: {key}")
    got = ranks[0]

    np.testing.assert_allclose(got["blocks"], want["blocks"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["blocks"], want["blocks_sequential"], rtol=1e-5, atol=1e-5)
    for kernels, tol in (("xla", (FWD_TOL, GRAD_TOL)), ("pallas", (KERNEL_TOL, KERNEL_TOL))):
        logits, grads = want[f"fwd_{kernels}"]
        name = f"fwd_{kernels}"
        np.testing.assert_allclose(got[f"{name}/logits"], logits, **tol[0], err_msg=name)
        _assert_tree(_got(got, f"{name}/grad/"), grads, tol[1], f"{name} gradients")

    _assert_train(got, "pp", want["pp"], "JAX's pipeline Trainer")
    _assert_train(got, "pp", (*want["single_pp"][:1], None, want["single_pp"][1]),
                  "the single-device step")
    assert bool(got["pp/warned"]) and not bool(got["pp_pallas/warned"])
    assert str(got["pp/kind"]) == "pipeline" and str(got["pp/kernels"]) == "xla"
    assert str(got["pp_pallas/kernels"]) == "pallas"
    # against JAX's "xla" form (at M = 4: the microbatching moves no more
    # than the order of the sums)
    _assert_train(got, "pp_pallas", want["pp"], "JAX's 'xla' pipeline step",
                  loss_tol=dict(rtol=5e-3), param_tol=GELU_TOL)
    _assert_train(got, "dppp", want["dppp"], "JAX's dp x pp Trainer")
    exact = dict(rtol=0, atol=0)
    _assert_train(got, "dppp_zero", ([float(got[f"dppp/total_loss/{i}"]) for i in range(2)],
                                     None, _got(got, "dppp/param/")), "the step without ZeRO",
                  exact, exact)
    assert "has no RankViT ranking path" in str(got["rank/refused"])
    assert np.isfinite(float(got["rank/total_loss/0"]))

    for name in ("g_pp", "g_sp", "g_dppp", "g_dpsp"):
        logits, aux = want[name]
        np.testing.assert_allclose(got[f"{name}/logits"], np.asarray(logits), **FWD_TOL,
                                   err_msg=name)
        masks = {k: np.asarray(v) for k, v in aux["masks"].items()}
        _assert_tree(_got(got, f"{name}/mask/"), masks, FWD_TOL, f"{name} masks")
    for name in ("res_pp", "res_sp", "res_dppp"):
        _assert_train(got, name, want["res_pp"], "JAX's pipeline Trainer")
        names = sorted(k.split("/")[1] for k in got if k.startswith(f"{name}/")
                       and k.endswith("/0") and "/param/" not in k)
        assert names == want["res_pp"][1] and "sparsity" in names, (name, names)
        assert str(got[f"{name}/kernels"]) == "fp32"
    assert str(got["res_pp/kind"]) == "pipeline_residual"
    assert str(got["res_sp/kind"]) == "sp_residual"
    single = want["single_res_free"]
    _assert_train(got, "res_free", (single[0], None, single[1]), "the single-device step")


# ----------------------------------------------------------- one process


def test_bubble_fraction_and_stacking_match_jax():
    """``bubble_fraction``'s values and its ValueError (JAX's); the stacked
    stage trees leaf for leaf against JAX's, and JAX's ValueError where the
    layers do not divide."""
    for s, m in ((1, 1), (4, 4), (4, 8), (4, 16), (3, 5)):
        assert pipeline.bubble_fraction(s, m) == jpp.bubble_fraction(s, m)
    assert pipeline.bubble_fraction(4, 4) == pytest.approx(3 / 7)
    for s, m in ((0, 4), (4, 0)):
        with pytest.raises(ValueError) as got:
            pipeline.bubble_fraction(s, m)
        with pytest.raises(ValueError) as want:
            jpp.bubble_fraction(s, m)
        assert str(got.value) == str(want.value)

    rng = np.random.default_rng(3)
    trees = [{"a": rng.normal(size=(2, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(4,)).astype(np.float32)}} for _ in range(3)]
    got = stack_stage_params([jax.tree.map(torch.from_numpy, t) for t in trees])
    want = jax.jit(jpp.stack_stage_params)(trees)
    _assert_tree({k: v.numpy() for k, v in tree_leaves(got)}, _by_path(want),
                 dict(rtol=0, atol=0), "stack_stage_params")
    for key, stack, jstack in (("vit", pipeline.stack_vit_stage_params,
                                jpp.stack_vit_stage_params),
                               ("res", residual.stack_residual_stage_params,
                                jres.stack_residual_stage_params)):
        tree = _tree(*MODELS[key])
        got = stack(jax.tree.map(torch.from_numpy, tree), 2)
        want = jax.jit(lambda t, jstack=jstack: jstack(t, 2))(tree)
        _assert_tree({k: v.numpy() for k, v in tree_leaves(got)}, _by_path(want),
                     dict(rtol=0, atol=0), key)
        with pytest.raises(ValueError) as err:
            stack(jax.tree.map(torch.from_numpy, tree), 3)
        with pytest.raises(ValueError) as jerr:
            jax.jit(lambda t, jstack=jstack: jstack(t, 3))(tree)
        assert str(err.value) == str(jerr.value)


def _fake_mesh(n_data=1, n_stage=2):
    """A (data, stage) mesh view with no process group: enough for every
    check that raises before a collective."""
    return Mesh({DATA_AXIS: n_data, STAGE_AXIS: n_stage}, None, None, 0, 0, torch.device("cpu"))


GUARD_MODELS = {
    "drop": ("vit", dict(VIT, dropout=0.1)),
    "vit": ("vit", VIT),
    "res_gumbel": ("residualvit", dict(RES, gate_type="gumbel")),
    "res_const": ("residualvit", dict(RES, add_budget_token=0.5)),
    "res_input": ("residualvit", dict(RES, add_input=True)),
    "res_mixed": ("residualvit", dict(RES, residual_layers=["attention+mlp", "attention"] * 2)),
    "ee": ("eeresidualvit", RES),
    "avit": ("adavit", dict(VIT, gate_scale=10.0, gate_center=30.0)),
}


@pytest.mark.parametrize("model,kwargs,budget", [
    ("drop", dict(pipeline_stages=4), None),
    ("vit", dict(pipeline_stages=3), None),
    ("vit", dict(pipeline_stages=4, loss_compose=SPARSITY), None),
    ("res_gumbel", dict(pipeline_stages=4), BUDGET),
    ("res_const", dict(pipeline_stages=4), 0.5),
    ("res_input", dict(sequence_parallel_devices=4), BUDGET),
    ("res_mixed", dict(pipeline_stages=2), BUDGET),
    ("ee", dict(pipeline_stages=4), BUDGET),
    ("avit", dict(sequence_parallel_devices=4), None),
    ("vit", dict(pipeline_stages=4, mesh=(1, 2)), None),
])
def test_guards_match_jax(model, kwargs, budget):
    """Each guard raises JAX's exception with JAX's message, at the first
    step as in JAX: the Trainer on the same model and options (a mesh with
    a 'stage' axis of the wrong size where ``mesh`` is given)."""
    from peekvit_torch.utils.losses import LossCompose

    family, args = GUARD_MODELS[model]
    x, y = _data()
    kwargs = dict(kwargs)
    shape = kwargs.pop("mesh", None)
    compose = kwargs.pop("loss_compose", None)
    with pytest.raises(Exception) as want:
        JaxTrainer(model=jax_build_model(family, args, seed=0), optimizer=jax_optim.SGD(lr=LR),
                   fused=False, mesh=None if shape is None else _jax_mesh(shape, ("data",
                                                                                 "stage")),
                   loss_compose=jax_losses.LossCompose(JAX_SPARSITY) if compose else None,
                   **kwargs).train_step(jnp.asarray(x), jnp.asarray(y), budget=budget)
    with pytest.raises(Exception) as got:
        Trainer(model=build_model(family, args, device="cpu"), optimizer=optim.SGD(lr=LR),
                fused=False, device="cpu", mesh=None if shape is None else _fake_mesh(*shape),
                loss_compose=LossCompose(compose) if compose else None,
                **kwargs).train_step(x, y, budget=budget)
    assert type(got.value) is type(want.value), (got.value, want.value)
    assert str(got.value) == str(want.value)


def test_pipeline_guards():
    """Without a stage axis the stages lie over the default group: a world
    of another size raises in the form of SP's message; ``pipeline_
    microbatches`` alone is ignored, as in JAX; the gated forwards refuse
    a non-learnable budget token in JAX's words; FSDP, tensor parallelism
    and QAT keep JAX's refusals of a pipeline."""
    x, y = _data()
    vit = build_model("vit", VIT, device="cpu")
    base = dict(optimizer=optim.SGD(lr=LR), fused=False, device="cpu")
    with pytest.raises(ValueError, match=r"pipeline_stages=4 needs a default process group of 4 "
                                         r"ranks \(torch.distributed.init_process_group\), "
                                         "have 1"):
        Trainer(model=vit, pipeline_stages=4, **base).train_step(x, y)
    alone = Trainer(model=vit, pipeline_microbatches=4, **base)
    assert np.isfinite(float(alone.train_step(x, y)["total_loss"]))
    assert alone._train_kind == "module"
    numpy_tree = _tree(*MODELS["res"])
    tree = jax.tree.map(torch.from_numpy, numpy_tree)
    jtree = jax.tree.map(jnp.asarray, numpy_tree)
    lp, jlp = tree["encoder"]["layers_0"], jtree["encoder"]["layers_0"]
    tokens = np.random.default_rng(1).normal(size=(2, 6, 32)).astype(np.float32)
    with pytest.raises(NotImplementedError) as err:
        residual._gate_mask(lp, torch.from_numpy(tokens), 1, gate_temp=1.0, gate_bias=0.0,
                            budget_token="learnable_interpolate")
    with pytest.raises(NotImplementedError) as jerr:
        jres._gate_mask(jlp, jnp.asarray(tokens), 1, gate_temp=1.0, gate_bias=0.0,
                        budget_token="learnable_interpolate")
    assert str(err.value) == str(jerr.value)
    # the interpolating token's second leaf, so JAX reaches its refusal
    tree["learnable_budget_token_2"] = tree["learnable_budget_token_1"]
    jtree["learnable_budget_token_2"] = jtree["learnable_budget_token_1"]
    with pytest.raises(NotImplementedError) as err:
        residual.sequence_parallel_residualvit_forward(
            tree, torch.from_numpy(x), torch.full((8,), 0.5), mesh=None, num_heads=2,
            patch_size=8, budget_token="learnable_interpolate")
    with pytest.raises(NotImplementedError) as jerr:
        jax.jit(lambda p, im, bv: jres.sequence_parallel_residualvit_forward(
            p, im, bv, mesh=jax_make_mesh(n_data=1, n_model=2), num_heads=2, patch_size=8,
            budget_token="learnable_interpolate"))(jtree, jnp.asarray(x), jnp.full((8,), 0.5))
    assert str(err.value) == str(jerr.value)
    # the gate against JAX's on one layer
    got = residual._gate_mask(lp, torch.from_numpy(tokens), 1, gate_temp=1.0, gate_bias=0.0,
                              budget_token="learnable")
    want = jres._gate_mask(jlp, jnp.asarray(tokens), 1, gate_temp=1.0, gate_bias=0.0,
                           budget_token="learnable")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    tp_mesh = Mesh({DATA_AXIS: 1, "model": 2}, None, None, 0, 0, torch.device("cpu"))
    for kw, mesh, words in (
            (dict(fsdp_sharded_params=True), _fake_mesh(2, 1), "fsdp_sharded_params composes"),
            (dict(tensor_parallel=True), tp_mesh, "tensor_parallel composes with"),
            (dict(qat=True), _fake_mesh(2, 1), "the pipeline/sequence-parallel stage math")):
        with pytest.raises(NotImplementedError, match=words):
            Trainer(model=vit, pipeline_stages=2, mesh=mesh, **base, **kw)
