"""The port's data parallelism against the JAX package's, on the CPU: the
data-parallel ``InferenceEngine`` and ``Trainer`` (and ZeRO-1) over a
``(2, 1)`` mesh of spawned gloo ranks (one process per rank,
``tests/torch_dp_worker.py``; one spawn runs every case), against JAX's
shard-mapped engine and its dp Trainer on two devices of the virtual
8-device mesh (computed here while the ranks run) and against the port's
single-device engine and step on the same global batch; every rank's
outputs bit-identical. And the guards. Inputs come from numpy with a seed.

Tolerances: the engines at JAX's own dp pins, rtol = atol = 1e-5
(tests/test_parallel.py:174-234), but against JAX: the ResidualViT's
constant budget token at the port's fp32 engine tolerance 2e-4
(tests/test_torch_residualvit.py, test_inference.py:34: the LayerNorm of a
constant row scales the last bit of its mean by 1e3, here at the
non-dyadic 0.4 / 0.9), int8 at the int8 engines' 5e-2 of max|logit|
(tests/test_torch_quant_engine.py: a code may round the other way). The
fp32 module step at JAX's dp pins (loss 1e-5, parameters 2e-5, :40-59),
against JAX's dp step and the port's single-device one. The bf16 fused
steps against JAX at the repo's bf16 3e-2 (tests/test_torch_training.py);
against the port's single-device step the loss at step 0 at 1e-6
(:896-934), then at 3e-2 and the parameters at 2e-3 where JAX pins 1e-3 /
2e-4 (``FUSED_PARAM_TOL``: each rank's weight gradient is rounded to bf16
before the fp32 all-reduce). ZeRO-1 against the replicated step bit for
bit (JAX pins 2e-5 on its reduce-scatter, :983)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_worker
from test_torch_dropout import _Recorder
from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.base import Model as JaxModel
from peekvit_tpu.models.registry import resolve_model_class
from peekvit_tpu.parallel import make_mesh as jax_make_mesh
from peekvit_tpu.parallel import shard_batch
from peekvit_tpu.training import fused as jax_fused
from peekvit_tpu.training import optim as jax_optim
from peekvit_tpu.training.trainer import Trainer as JaxTrainer
from peekvit_tpu.utils import losses as jax_losses
from peekvit_torch import InferenceEngine, Trainer, build_model
from peekvit_torch.models.adapters import params_to_jax, tree_leaves
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh
from peekvit_torch.training import optim

WORLD = 2
JOIN_TIMEOUT = 240.0  # seconds for every rank to finish; a hung collective fails the test
ENGINE_TOL = dict(rtol=1e-5, atol=1e-5)
RESIDUAL_JAX_TOL = dict(rtol=2e-4, atol=2e-4)
INT8_TOL = 5e-2
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# the fused steps' parameters against the single device: each rank's
# weight gradient reaches its fp32 parameter through the bf16 cast, so it
# is rounded to bf16 per rank (2^-8 relative) before the fp32 all-reduce,
# where the single device rounds the whole sum once: lr 0.05 x |g| x 2^-8
FUSED_PARAM_TOL = dict(rtol=0, atol=2e-3)
MODULE_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MODULE_PARAM_TOL = dict(rtol=2e-5, atol=2e-5)
# tests/test_parallel.py:174-234's engines
VIT = dict(image_size=32, patch_size=8, num_layers=2, num_heads=4, hidden_dim=64, mlp_dim=128,
           num_classes=7)
RES = dict(VIT, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid",
           add_budget_token=0.5)  # a constant fill: the whole-batch mean spans the mesh
RANK = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
            num_classes=5, rankvit_layers=[1])
# tests/test_parallel.py:_model and :936-981's ResidualViT
VIT16 = dict(image_size=16, patch_size=8, num_layers=2, num_heads=2, hidden_dim=32, mlp_dim=64,
             num_classes=10)
RES16 = dict(VIT16, residual_layers=["attention+mlp"] * 2, gate_type="sigmoid")
MSE = {"mse": {"_target_": "peekvit.utils.losses.MSELoss", "budget": None, "strict": False,
               "weight": 0.01}}
# budgets that are sums of powers of two (tests/test_torch_residualvit_training.py:BVEC)
FED_BUDGETS = np.array([0.25, 0.625, 0.5, 0.75, 0.375, 0.875, 0.5, 0.25], np.float32)
# name -> (registry name, args, seed)
MODELS = {"vit": ("vit", VIT, 71), "res": ("residualvit", RES, 73), "rank": ("rankvit", RANK, 76),
          "vit16": ("vit", VIT16, 7), "res16": ("residualvit",
                                                dict(RES16, add_budget_token="learnable"), 9),
          "res16_drop": ("residualvit", dict(RES16, add_budget_token=0.5, dropout=0.1,
                                             attention_dropout=0.1), 10)}
ENGINES = {  # name -> (model, engine keywords, budgets)
    "eng_vit": ("vit", {}, [None]),
    "eng_res": ("res", {}, [0.4, 0.9]),
    "eng_rank_padded": ("rank", dict(max_budget=0.5), [0.25, 0.5]),
    "eng_vit_int8": ("vit", dict(quantized=True), [None]),
    "eng_res_compact": ("res", dict(compact=0.5), [0.5]),
}


def _tree(family, args, seed):
    """The port's seeded param tree as JAX's (numpy) with a random head and
    class tokens (a zero-initialised head gives every logit 0) and, for a
    ResidualViT, a random layer-0 gate (tests/test_parallel.py:204-213)."""
    tree = params_to_jax(build_model(family, args, seed=seed, device="cpu"))
    rng = np.random.default_rng(seed + 100)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    if family == "residualvit":
        gate = tree["encoder"]["layers_0"]["residual_gate"]["projection"]["kernel"]
        gate[:] = rng.normal(0, 0.5, gate.shape)
    return tree


def _jax_model(family, args, tree):
    return JaxModel(module=resolve_model_class(family)(**args),
                    params=jax.tree.map(jnp.asarray, tree), model_class=family, model_args=args)


def _path(p):
    return "/".join(str(getattr(k, "key", k)) for k in p)


def _train_cases() -> list:
    def case(name, model, trainer, optimizer=("SGD", dict(lr=0.05)), **kw):
        family, args, _ = MODELS[model]
        return dict(kind="train", name=name, weights=model, family=family, args=args,
                    images="images16", trainer=trainer, optimizer=optimizer, steps=[0, 1], **kw)

    adamw = ("AdamW", dict(lr=1e-2, weight_decay=0.05))
    return [
        case("fused_vit", "vit16", dict(fused=True)),
        case("fused_res", "res16", dict(fused=True, loss_compose=MSE), budgets="fed_budgets"),
        case("fused_res_sampled", "res16", dict(fused=True, loss_compose=MSE)),
        case("module_res_drop", "res16_drop", dict(fused=False, loss_compose=MSE,
                                                    clip_grad_norm=1.0), masks="masks"),
        case("zero", "vit16", dict(fused=True, zero_sharded_optimizer=True), adamw),
        case("replicated", "vit16", dict(fused=True), adamw),
        case("zero_module_accum", "res16_drop", dict(fused=False, zero_sharded_optimizer=True,
                                                     grad_accumulation=2, loss_compose=MSE),
             adamw, masks="masks"),
        case("module_accum", "res16_drop", dict(fused=False, grad_accumulation=2,
                                                loss_compose=MSE), adamw, masks="masks"),
    ]


def _cases() -> list:
    cases = []
    for name, (model, kw, budgets) in ENGINES.items():
        family, args, _ = MODELS[model]
        cases.append(dict(kind="engine", name=name, weights=model, family=family, args=args,
                          images="images32", engine=kw, budgets=budgets))
    return cases + _train_cases()


def _jax_engines(trees, x, jmesh) -> dict:
    want = {}
    for name, (model, kw, budgets) in ENGINES.items():
        family, args, _ = MODELS[model]
        engine = JaxEngine(_jax_model(family, args, trees[model]), compute_dtype=jnp.float32,
                           interpret=True, mesh=jmesh, **kw)
        for b in budgets:
            want[f"{name}/{b}"] = np.asarray(engine(x) if b is None else engine(x, budget=b))
    return want


def _jax_steps(trees, x, y, jmesh, recorder) -> dict:
    """The JAX dp Trainer's losses and parameters of the cases that have
    a JAX counterpart."""
    xd, yd = shard_batch(jnp.asarray(x), jmesh), shard_batch(jnp.asarray(y), jmesh)
    want = {}

    def run(name, model, record=False, **kw):
        family, args, _ = MODELS[model]
        t = JaxTrainer(model=_jax_model(family, args, trees[model]),
                       optimizer=jax_optim.SGD(lr=0.05), mesh=jmesh, **kw)
        with pytest.MonkeyPatch.context() as patch:
            if record:
                patch.setattr(jax.random, "bernoulli", recorder)
            want[name] = ([float(t.train_step(xd, yd, step_idx=i)["total_loss"])
                           for i in range(2)],
                          {_path(p): np.asarray(v)
                           for p, v in jax.tree_util.tree_flatten_with_path(t.model.params)[0]})

    run("fused_vit", "vit16", fused=True)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_fused, "sample_budgets",
                      lambda module, key, n: jnp.asarray(FED_BUDGETS[:n]))
        run("fused_res", "res16", fused=True, loss_compose=jax_losses.LossCompose(MSE))
    run("module_res_drop", "res16_drop", record=True, fused=False, clip_grad_norm=1.0,
        loss_compose=jax_losses.LossCompose(MSE))
    return want


def _join(ctx, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"dp ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _params(out: dict, name: str) -> dict:
    prefix = f"{name}/param/"
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_params(got: dict, want: dict, what: str, **tol) -> None:
    assert set(got) == set(want), what
    for path in sorted(want):
        np.testing.assert_allclose(got[path], want[path], **tol, err_msg=f"{what}: {path}")


def test_data_parallel_matches_jax_and_single_device(tmp_path):
    """One spawn of 2 gloo ranks runs every case. The dp engine: ViT,
    ResidualViT at add_budget_token 0.5 (the whole-batch mean over the data
    column) at 0.4 / 0.9, padded RankViT at 0.25 / 0.5, int8 ViT, and
    compact=0.5. The dp Trainer: the fused ViT step, the fused ResidualViT
    step (fed budgets against JAX; sampled from the step generator over the
    global batch against the port's single-device step), the module step on
    a ResidualViT with the MSE regularizer and dropout (JAX's masks
    replayed), ZeRO-1 against the replicated step on the fused and module
    paths (AdamW, the module one with grad_accumulation=2)."""
    rng = np.random.default_rng(5)
    data = {"images32": rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            "images16": rng.normal(size=(8, 16, 16, 3)).astype(np.float32)}
    labels = (np.arange(8) % 5).astype(np.int64)
    for key, arr in data.items():
        np.save(tmp_path / f"{key}.npy", arr)
    np.save(tmp_path / "labels.npy", labels)
    np.save(tmp_path / "fed_budgets.npy", FED_BUDGETS)
    trees = {key: _tree(family, args, seed) for key, (family, args, seed) in MODELS.items()}
    for key, tree in trees.items():
        np.savez(tmp_path / f"{key}.npz", **{k.replace("/", "."): v for k, v in tree_leaves(tree)})
    jmesh = jax_make_mesh(n_data=WORLD, n_model=1)
    # the dropout masks come from the JAX dp step's trace (the global batch's)
    recorder = _Recorder(3)
    jax_steps = _jax_steps(trees, data["images16"], labels, jmesh, recorder)
    assert recorder.masks and all(m.shape[0] == 8 for m in recorder.masks)
    np.savez(tmp_path / "masks.npz", **{f"m{i}": m for i, m in enumerate(recorder.masks)})
    cases = _cases()
    ctx = mp.start_processes(torch_dp_worker.run, args=(WORLD, str(tmp_path), cases),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:  # the references, computed while the ranks run
        want = _jax_engines(trees, jnp.asarray(data["images32"]), jmesh)
        single = {}
        for case in cases:
            images = data[case["images"]]
            if case["kind"] == "engine":
                single.update(torch_dp_worker.engine_case(str(tmp_path), case, images))
            elif not case["trainer"].get("zero_sharded_optimizer"):  # ZeRO needs a mesh
                single.update(torch_dp_worker.train_case(str(tmp_path), case, images, labels))
    finally:
        _join(ctx, JOIN_TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    for key in sorted(ranks[0]):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r}: {key}")
    got = ranks[0]

    # the engines
    for name, (_, kw, budgets) in ENGINES.items():
        for b in budgets:
            key = f"{name}/{b}"
            assert got[key].shape[0] == 8
            np.testing.assert_allclose(got[key], single[key], **ENGINE_TOL,
                                       err_msg=f"{key} against the single-device engine")
            if kw.get("quantized"):
                assert np.abs(got[key] - want[key]).max() <= INT8_TOL * np.abs(want[key]).max()
            else:
                np.testing.assert_allclose(
                    got[key], want[key], err_msg=f"{key} against JAX's dp engine",
                    **(RESIDUAL_JAX_TOL if name.startswith("eng_res") else ENGINE_TOL))

    # the steps
    kinds = {"fused_vit": "fused_vit", "fused_res": "fused_residual",
             "fused_res_sampled": "fused_residual", "module_res_drop": "module"}
    for name, kind in kinds.items():
        assert str(got[f"{name}/kind"]) == kind, name
        fused = kind.startswith("fused")
        for i in range(2):
            loss_tol = (dict(rtol=1e-6) if fused and i == 0 else BF16_TOL if fused
                        else MODULE_LOSS_TOL)
            np.testing.assert_allclose(got[f"{name}/total_loss/{i}"],
                                       single[f"{name}/total_loss/{i}"], **loss_tol,
                                       err_msg=f"{name} loss {i} against the single device")
        _assert_params(_params(got, name), _params(single, name),
                       f"{name} against the single device",
                       **(FUSED_PARAM_TOL if fused else MODULE_PARAM_TOL))
        if name in jax_steps:
            losses, params = jax_steps[name]
            np.testing.assert_allclose([got[f"{name}/total_loss/{i}"] for i in range(2)], losses,
                                       **(BF16_TOL if fused else MODULE_LOSS_TOL),
                                       err_msg=f"{name} losses against JAX's dp Trainer")
            _assert_params(_params(got, name), params, f"{name} against JAX's dp Trainer",
                           **(BF16_TOL if fused else MODULE_PARAM_TOL))
    assert "mse/1" in " ".join(k for k in got if k.startswith("module_res_drop/"))
    # ZeRO-1: the replicated step's parameters, a share of its optimizer state
    for zero, rep in (("zero", "replicated"), ("zero_module_accum", "module_accum")):
        for path, leaf in _params(got, rep).items():
            np.testing.assert_array_equal(_params(got, zero)[path], leaf, err_msg=f"{zero} {path}")
        np.testing.assert_array_equal(got[f"{zero}/total_loss/1"], got[f"{rep}/total_loss/1"])
        assert got[f"{zero}/opt_bytes"] < 0.6 * got[f"{rep}/opt_bytes"]


def _fake_mesh(n_data=2, n_model=1):
    """A mesh view with no process group: enough for every check that
    raises before a collective."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, None, None, 0, 0, torch.device("cpu"))


def test_data_parallel_guards():
    """An indivisible batch (JAX's message, engine and Trainer), the
    pipeline, tensor parallelism without a model axis, ZeRO-1 without a
    mesh; a model axis of 2 without SP and FSDP construct; a dp Trainer
    refuses what the single-device one refuses, with the same message."""
    vit = build_model("vit", VIT16, device="cpu")
    x = np.zeros((3, 16, 16, 3), np.float32)
    y = np.zeros(3, np.int64)
    with pytest.raises(ValueError, match="batch size 3 must divide the mesh's 'data' axis size "
                                         "2 for data-parallel serving"):
        InferenceEngine(vit, device="cpu", compute_dtype=torch.float32, mesh=_fake_mesh())(x)
    for fused, what in ((True, "the dp-fused train step"), (False, "the data-parallel train")):
        with pytest.raises(ValueError, match=f"batch size 3 must divide .* for {what}"):
            Trainer(vit, optim.SGD(lr=0.1), device="cpu", mesh=_fake_mesh(),
                    fused=fused).train_step(x, y)
    base = dict(optimizer=optim.SGD(lr=0.1), device="cpu")
    # the pipeline is ported (tests/test_torch_pipeline.py): a mesh without a
    # 'stage' axis leaves its stages over the default process group, as
    # JAX lays them over jax.devices() (trainer.py:438-444)
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a default process group of 2 "
                                         "ranks"):
        Trainer(model=vit, **base, mesh=_fake_mesh(), pipeline_stages=2).train_step(
            np.zeros((4, 16, 16, 3), np.float32), np.zeros(4, np.int64))
    # ported (tests/test_torch_sharded_training.py): a model axis of 2 without
    # SP (the module step replicated over it), FSDP and tensor parallelism
    # (JAX's checks and words)
    assert Trainer(model=vit, **base, mesh=_fake_mesh(1, 2), fused=False)._dp is not None
    fsdp = Trainer(model=build_model("vit", VIT16, device="cpu"), **base, mesh=_fake_mesh(),
                   fsdp_sharded_params=True)
    assert fsdp.fused is False and fsdp._shards.split_fraction() > 0.9
    with pytest.raises(ValueError, match="tensor_parallel=True requires mesh= with a 'model' "
                                         "axis of size >= 2"):
        Trainer(model=vit, **base, mesh=_fake_mesh(), tensor_parallel=True)
    with pytest.raises(ValueError, match="zero_sharded_optimizer requires mesh="):
        Trainer(model=vit, zero_sharded_optimizer=True, **base)
    moe = build_model("moevit", dict(VIT16, mlp_moes=[1, 2]), device="cpu")
    messages = []
    for mesh in (None, _fake_mesh(1, 1)):
        with pytest.raises(NotImplementedError) as err:
            Trainer(model=moe, mesh=mesh, **base).train_step(np.zeros((2, 16, 16, 3), np.float32),
                                                              np.zeros(2, np.int64), budget=0.5)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "takes no token budget" in messages[0]
