"""The port's tensor-parallel serving against the JAX package's, on the
CPU: the four Megatron partials (their plain versions) against the Pallas
``tp_blocks`` functions in interpret mode, the sliced param trees leaf
for leaf, the Megatron identity (the shards' partials summed, plus bias
and residual, equal the single-device layer), and ``InferenceEngine(mesh=
make_mesh(n_data, n_model))`` run as spawned gloo ranks (one process per
rank, ``tests/torch_tp_worker.py``) against the JAX TP engine on the
virtual 8-device mesh and against the port's single-device engine, every
rank's logits bit-identical. Inputs come from numpy with a seed.

Tolerances: fp32 2e-4 and bf16 3e-2 for the partials (sums in another
order; tests/test_pallas.py:42); 1e-4 for the engines, the JAX TP test's
own (tests/test_tp_serving.py:52): the all-reduce adds the fp32 partials
in another order than the JAX psum."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import torch_tp_worker
from peekvit_tpu.inference import InferenceEngine as JaxEngine
from peekvit_tpu.models.registry import build_model as jax_build_model
from peekvit_tpu.ops.pallas import tp_blocks as jtp
from peekvit_tpu.parallel import make_mesh as jax_make_mesh
from peekvit_tpu.parallel import tp_serving as jtps
from peekvit_torch import InferenceEngine, build_model
from peekvit_torch.inference import prepare_engine_params
from peekvit_torch.models.adapters import module_params, params_from_jax, tree_leaves
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import tp_blocks as ttp
from peekvit_torch.parallel import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from peekvit_torch.parallel import tp_serving as ttps

VIT_ARGS = dict(image_size=32, patch_size=8, num_layers=3, num_heads=4, hidden_dim=64,
                mlp_dim=128, num_classes=7)
RES_ARGS = dict(VIT_ARGS, residual_layers=["attention+mlp"] * 3, gate_type="sigmoid")
B, N, D, H, M = 2, 19, 64, 4, 128
TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ENGINE_TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_TIMEOUT = 120.0  # seconds for every rank to finish; a hung collective fails the test
# Residual budgets are sums of powers of two: a constant budget token's
# mean is then exact in any summation order (tests/test_torch_residualvit.py
# DYADIC).
CASES = [
    dict(name="vit", family="vit", args=VIT_ARGS, budgets=[None], ee=False),
    dict(name="vit_cls2_reg2", family="vit",
         args=dict(VIT_ARGS, num_class_tokens=2, num_registers=2), budgets=[None], ee=False),
    dict(name="rankvit", family="rankvit", args=dict(VIT_ARGS, rankvit_layers=[1, 2]),
         budgets=[0.5, 0.25, 1.0, None], ee=False),
    dict(name="residual_learnable", family="residualvit",
         args=dict(RES_ARGS, add_budget_token="learnable"), budgets=[0.25, 0.625, 1.0],
         ee=False),
    dict(name="residual_constant", family="residualvit",
         args=dict(RES_ARGS, add_budget_token=True), budgets=[0.25, 0.625, 1.0], ee=False),
    dict(name="ee", family="eeresidualvit", args=dict(RES_ARGS, add_budget_token="learnable"),
         budgets=[0.625], ee=True),
    # the EncDec's logits without recon_outputs (JAX counts it in the
    # ResidualViT family, tp_serving.py:469-471), at equal encoder and
    # decoder widths, where the JAX module builds
    dict(name="encdec", family="encdecresidualvit",
         args=dict(RES_ARGS, add_budget_token="learnable", decoder_num_layers=1),
         budgets=[0.625], ee=False),
]


def _tree(family, args, seed):
    """A seeded JAX param tree (numpy) with a random head, class tokens and
    gates (zero-init heads would give every logit 0), the JAX model holding
    it, and the port's model loaded from it."""
    jm = jax_build_model(family, args, seed=seed)
    rng = np.random.default_rng(seed + 100)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jm.params)
    tree["head"]["kernel"][:] = rng.normal(0, 0.3, tree["head"]["kernel"].shape)
    tree["class_tokens"][:] = rng.normal(0, 0.3, tree["class_tokens"].shape)
    for key, lp in tree["encoder"].items():
        if "residual_gate" in lp:
            kern = lp["residual_gate"]["projection"]["kernel"]
            kern[:] = rng.normal(0, 0.5, kern.shape)
        elif key.endswith("_head"):
            lp["kernel"][:] = rng.normal(0, 0.3, lp["kernel"].shape)
    jm.params = jax.tree.map(jnp.asarray, tree)
    return tree, jm, params_from_jax(build_model(family, args, device="cpu"), tree)


def _images(batch=4, seed=7):
    return np.random.default_rng(seed).normal(size=(batch, 32, 32, 3)).astype(np.float32)


def _fake_mesh(n_data=2, n_model=4):
    """A mesh view with no process group: enough for every check that
    raises before a collective."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, None, None, 0, 0, torch.device("cpu"))


# ------------------------------------------------------------ the partials


@pytest.fixture(scope="module")
def shard():
    """One model shard's inputs at n_model = 2: 2 local heads of 16, dl 32,
    M / 2 = 64; a gate-like mask with a third of the rows exactly 0."""
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.normal(size=shape) * scale + shift).astype(np.float32)

    dl, ml = D // 2, M // 2
    mask = np.maximum(rng.uniform(-0.5, 1.0, size=(B, N, 1)), 0.0).astype(np.float32)
    mask[:, 0] = 1.0
    return {"x": normal(B, N, D, scale=1.5, shift=0.3), "mask": mask,
            "lns": normal(1, D, scale=0.2, shift=1.0), "lnb": normal(1, D, scale=0.1),
            "wqkv": normal(D, 3 * dl, scale=D ** -0.5), "bqkv": normal(1, 3 * dl, scale=0.1),
            "wo": normal(dl, D, scale=dl ** -0.5), "w1": normal(D, ml, scale=D ** -0.5),
            "b1": normal(1, ml, scale=0.1), "w2": normal(ml, D, scale=ml ** -0.5)}


SITES = {  # site -> (port plain version, JAX function, arrays, static args)
    "25_attention": (ttp.tp_attention_partial_ref, jtp.tp_attention_partial,
                     ("x", "wqkv", "bqkv", "wo"), (H // 2, 1e-5)),
    "26_masked_attention": (ttp.tp_masked_attention_partial_ref,
                            jtp.tp_masked_attention_partial,
                            ("x", "mask", "lns", "lnb", "wqkv", "bqkv", "wo"), (H // 2, 1e-6)),
    "27_masked_mlp": (ttp.tp_masked_mlp_partial_ref, jtp.tp_masked_mlp_partial,
                      ("x", "mask", "lns", "lnb", "w1", "b1", "w2"), (1e-6,)),
    "28_mlp": (ttp.tp_mlp_partial_ref, jtp.tp_mlp_partial, ("x", "w1", "b1", "w2"), (1e-5,)),
}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("site", list(SITES))
def test_partial_matches_pallas(shard, site, dtype):
    """Each partial's plain version against the Pallas function in
    interpret mode: fp32 out, no bias, no residual."""
    ref, jfn, names, static = SITES[site]
    jdt, tdt = DTYPES[dtype]
    want = jfn(*[jnp.asarray(shard[k], jdt) for k in names], *static, True)
    got = ref(*[torch.from_numpy(shard[k]).to(tdt) for k in names], *static)
    assert got.dtype == torch.float32 and got.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), **TOL[dtype])


def test_partial_wrappers_take_the_plain_versions_on_the_cpu(shard):
    """On CPU tensors each wrapper is its plain version, bit for bit; the
    new GEMM epilogue is the bare fp32 product."""
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in shard.items()}
    for wrapper, ref, names, static in (
            (ttp.tp_attention_partial, ttp.tp_attention_partial_ref,
             ("x", "wqkv", "bqkv", "wo"), (H // 2,)),
            (ttp.tp_masked_attention_partial, ttp.tp_masked_attention_partial_ref,
             ("x", "mask", "lns", "lnb", "wqkv", "bqkv", "wo"), (H // 2,)),
            (ttp.tp_masked_mlp_partial, ttp.tp_masked_mlp_partial_ref,
             ("x", "mask", "lns", "lnb", "w1", "b1", "w2"), ()),
            (ttp.tp_mlp_partial, ttp.tp_mlp_partial_ref, ("x", "w1", "b1", "w2"), ())):
        args = [t[k] for k in names]
        assert torch.equal(wrapper(*args, *static), ref(*args, *static))
    a, w = t["x"].reshape(B * N, D), t["w1"]
    got = tfa.gemm_partial_f32(a, w)
    assert got.dtype == torch.float32 and torch.equal(got, a.float() @ w.float())


# ------------------------------------------------------------ the param trees


def _assert_same_tree(port: dict, jax_tree: dict):
    want = dict(tree_leaves(jax.tree.map(np.asarray, jax_tree)))
    got = {k: v.numpy() for k, v in tree_leaves(port)}
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert got[key].shape == leaf.shape, key
        np.testing.assert_array_equal(got[key], leaf, err_msg=key)


@pytest.mark.parametrize("n_model", [2, 4])
def test_prepare_tp_serving_params_matches_jax(n_model):
    """Leaf for leaf, exact in fp32, the JAX tree's keys and layouts."""
    _, jm, tm = _tree("vit", VIT_ARGS, 101)
    got = ttps.prepare_tp_serving_params(module_params(tm), n_model, 4, torch.float32)
    _assert_same_tree(got, jtps.prepare_tp_serving_params(jm.params, n_model, 4, jnp.float32))


@pytest.mark.parametrize("budget_token", ["learnable", True])
def test_prepare_tp_residual_serving_params_matches_jax(budget_token):
    """Leaf for leaf, exact in fp32, the early-exit leaves included."""
    _, jm, tm = _tree("eeresidualvit", dict(RES_ARGS, add_budget_token=budget_token), 133)
    got = ttps.prepare_tp_residual_serving_params(module_params(tm), 4, 4, torch.float32,
                                                  early_exits=True)
    _assert_same_tree(got, jtps.prepare_tp_residual_serving_params(
        jm.params, 4, 4, jnp.float32, early_exits=True))


@pytest.mark.parametrize("family", ["vit", "residualvit"])
def test_param_slices_cover_whole_model(family):
    """Re-assembling the shards' slices gives back the single-device
    weights (folded for the ViT, unfolded for the ResidualViT) exactly."""
    n_model, dl = 4, D // 4
    args = VIT_ARGS if family == "vit" else dict(RES_ARGS, add_budget_token="learnable")
    _, _, tm = _tree(family, args, 7)
    params = module_params(tm)
    if family == "vit":
        prep = prepare_engine_params(params, torch.float32, fold_ln=True)
        tp = ttps.prepare_tp_serving_params(params, n_model, 4, torch.float32)["tp"]
    else:
        prep = prepare_engine_params(params, torch.float32)
        tp = ttps.prepare_tp_residual_serving_params(params, n_model, 4, torch.float32)["tp"]
    for li in range(3):
        lp = prep["encoder"][f"layers_{li}"]
        qkv = lp["_folded_qkv"] if family == "vit" else {
            "kernel": lp["self_attention"]["in_proj_kernel"],
            "bias": lp["self_attention"]["in_proj_bias"]}
        fc1 = lp["_folded_fc1"] if family == "vit" else {
            "kernel": lp["mlp"]["fc1_kernel"], "bias": lp["mlp"]["fc1_bias"]}
        for name, full in (("wqkv", qkv["kernel"]), ("bqkv", qkv["bias"])):
            got = torch.cat([torch.cat([tp[name][s, li][:, c * dl:(c + 1) * dl]
                                        for s in range(n_model)], dim=1) for c in range(3)], dim=1)
            assert torch.equal(got, full), name
        for name, full, dim in (("wo", lp["self_attention"]["out_proj_kernel"], 0),
                                ("w1", fc1["kernel"], 1), ("b1", fc1["bias"], 1),
                                ("w2", lp["mlp"]["fc2_kernel"], 0)):
            assert torch.equal(torch.cat(list(tp[name][:, li]), dim=dim), full), name


# ------------------------------------------------------------ the Megatron identity


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_megatron_identity(kind, n_model):
    """The sum over shards of each partial, plus bias (once) and residual,
    equals the port's single-device layer (``fused_layer_block_folded`` /
    ``masked_layer_block``, plain versions, fp32): sums in another order,
    1e-5."""
    rng = np.random.default_rng(n_model)
    x = torch.from_numpy(rng.normal(size=(B, N, D)).astype(np.float32) * 1.5 + 0.3)
    heads_local = H // n_model
    if kind == "plain":
        _, _, tm = _tree("vit", VIT_ARGS, 11)
        params = module_params(tm)
        tp = ttps.prepare_tp_serving_params(params, n_model, H, torch.float32)
        lp = prepare_engine_params(params, torch.float32, fold_ln=True)["encoder"]["layers_0"]
        want = tfa.fused_layer_block_folded_ref(
            x, lp["_folded_qkv"]["kernel"], lp["_folded_qkv"]["bias"],
            lp["self_attention"]["out_proj_kernel"], lp["self_attention"]["out_proj_bias"],
            lp["_folded_fc1"]["kernel"], lp["_folded_fc1"]["bias"], lp["mlp"]["fc2_kernel"],
            lp["mlp"]["fc2_bias"], H)
        w, sh = tp["tp"], tp["shared"]
        pa = sum(ttp.tp_attention_partial_ref(x, w["wqkv"][s, 0], w["bqkv"][s, 0],
                                              w["wo"][s, 0], heads_local)
                 for s in range(n_model))
        y = x + pa + sh["bo"][0]
        pm = sum(ttp.tp_mlp_partial_ref(y, w["w1"][s, 0], w["b1"][s, 0], w["w2"][s, 0])
                 for s in range(n_model))
        got = y + pm + sh["b2"][0]
    else:
        _, _, tm = _tree("residualvit", dict(RES_ARGS, add_budget_token="learnable"), 12)
        params = module_params(tm)
        tp = ttps.prepare_tp_residual_serving_params(params, n_model, H, torch.float32)
        lp = prepare_engine_params(params, torch.float32)["encoder"]["layers_0"]
        mask = torch.from_numpy(
            np.maximum(rng.uniform(-0.5, 1.0, size=(B, N, 1)), 0.0).astype(np.float32))
        at, mlp = lp["self_attention"], lp["mlp"]
        want = tfa.masked_layer_block_ref(
            x, mask, lp["ln_1"]["scale"], lp["ln_1"]["bias"], at["in_proj_kernel"],
            at["in_proj_bias"], at["out_proj_kernel"], at["out_proj_bias"], lp["ln_2"]["scale"],
            lp["ln_2"]["bias"], mlp["fc1_kernel"], mlp["fc1_bias"], mlp["fc2_kernel"],
            mlp["fc2_bias"], H)
        w, sh = tp["tp"], tp["shared"]
        pa = sum(ttp.tp_masked_attention_partial_ref(
            x, mask, sh["ln1s"][0], sh["ln1b"][0], w["wqkv"][s, 0], w["bqkv"][s, 0],
            w["wo"][s, 0], heads_local) for s in range(n_model))
        y = (pa + sh["bo"][0]) * mask + x
        pm = sum(ttp.tp_masked_mlp_partial_ref(y, mask, sh["ln2s"][0], sh["ln2b"][0],
                                               w["w1"][s, 0], w["b1"][s, 0], w["w2"][s, 0])
                 for s in range(n_model))
        got = pm + sh["b2"][0] + y
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ the engines, as gloo ranks


def _join(ctx, timeout: float) -> None:
    """Join every rank; a rank's exception fails the test, and ranks still
    running at the deadline are killed and fail it too."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"TP ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4)])
def test_tp_engine_matches_jax_and_single_device(tmp_path, mesh_shape):
    """Every case of CASES served by ``n_data * n_model`` spawned gloo
    ranks (one spawn for the mesh): each rank's outputs equal every other
    rank's bit for bit, and match the JAX TP engine on the virtual mesh and
    the port's single-device CPU engine at fp32 1e-4 (RankViT at every
    budget and with none, both budget-token modes, the EE exit tuple, the
    EncDec's logits)."""
    n_data, n_model = mesh_shape
    world = n_data * n_model
    images = _images()
    np.save(tmp_path / "images.npy", images)
    models = {}
    for i, case in enumerate(CASES):
        tree, jm, tm = _tree(case["family"], case["args"], 200 + i)
        np.savez(tmp_path / f"{case['name']}.npz",
                 **{k.replace("/", "."): v for k, v in tree_leaves(tree)})
        models[case["name"]] = (jm, tm)
    ctx = mp.start_processes(torch_tp_worker.serve, args=(world, n_model, str(tmp_path), CASES),
                             nprocs=world, join=False, start_method="spawn")
    try:
        want = {}  # the references, computed while the ranks run
        jmesh = jax_make_mesh(n_data=n_data, n_model=n_model)
        for case in CASES:
            jm, tm = models[case["name"]]
            jtp_engine = JaxEngine(jm, compute_dtype=jnp.float32, interpret=True, mesh=jmesh,
                                   ee_outputs=case["ee"])
            single = InferenceEngine(tm, compute_dtype=torch.float32, device="cpu",
                                     ee_outputs=case["ee"])
            for budget in case["budgets"]:
                outs = {"jax_tp": jtp_engine(jnp.asarray(images), budget=budget),
                        "port_single": single(images, budget=budget)}
                for ref, out in outs.items():
                    out = out if isinstance(out, tuple) else (out,)
                    for k, t in enumerate(out):
                        want[(ref, f"{case['name']}/{budget}/{k}")] = np.asarray(t, np.float32)
    finally:
        _join(ctx, JOIN_TIMEOUT)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    assert "world size" in str(ranks[0].pop("guard/world_size"))
    for r in ranks[1:]:
        r.pop("guard/world_size")
    keys = set(ranks[0])
    assert keys == {key for _, key in want} and "ee/0.625/3" in keys  # 3 exits + final
    for key in sorted(keys):
        got = ranks[0][key]
        for r in range(1, world):
            np.testing.assert_array_equal(ranks[r][key], got, err_msg=f"rank {r}: {key}")
        assert got.shape == (images.shape[0], VIT_ARGS["num_classes"]), key
        for ref in ("jax_tp", "port_single"):
            np.testing.assert_allclose(got, want[(ref, key)], **ENGINE_TOL,
                                       err_msg=f"{key} against {ref}")


# ------------------------------------------------------------ the guards


def test_tp_engine_guards():
    mesh = _fake_mesh(2, 4)
    _, _, vit = _tree("vit", VIT_ARGS, 97)
    engine = InferenceEngine(vit, compute_dtype=torch.float32, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="divide the mesh"):
        engine(_images(3))
    for bad in (dict(VIT_ARGS, num_heads=2), dict(VIT_ARGS, mlp_dim=126)):
        model = build_model("vit", bad, device="cpu")
        with pytest.raises(ValueError, match="num_heads" if bad["num_heads"] == 2 else "mlp_dim"):
            InferenceEngine(model, compute_dtype=torch.float32, device="cpu", mesh=mesh)
    avit = build_model("adavit", VIT_ARGS, device="cpu")
    rank = build_model("rankvit", dict(VIT_ARGS, rankvit_layers=[1]), device="cpu")
    res = build_model("residualvit", dict(RES_ARGS, add_budget_token="learnable"), device="cpu")
    no_token = build_model("residualvit", dict(RES_ARGS, add_budget_token=False), device="cpu")
    refused = [(avit, {}), (vit, {"quantized": True}), (rank, {"max_budget": 0.75}),
               (res, {"compact": 0.75}), (no_token, {}), (vit, {"recon_outputs": True})]
    for model, kw in refused:
        with pytest.raises(NotImplementedError):
            InferenceEngine(model, compute_dtype=torch.float32, device="cpu", mesh=mesh, **kw)
    # a model axis of 1 is the data-parallel engine, ported since
    # (tests/test_torch_data_parallel.py): it builds, and refuses a batch
    # its data axis does not divide with JAX's message, before any collective
    dp = InferenceEngine(vit, compute_dtype=torch.float32, device="cpu", mesh=_fake_mesh(8, 1))
    with pytest.raises(ValueError, match="must divide the mesh's 'data' axis size 8"):
        dp(_images(3))
    with pytest.raises(ValueError, match="device"):
        InferenceEngine(vit, compute_dtype=torch.float32, device="cpu",
                        mesh=Mesh({DATA_AXIS: 1, MODEL_AXIS: 4}, None, None, 0, 0,
                                  torch.device("cuda", 0)))


def test_make_mesh_needs_a_process_group(monkeypatch):
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(n_model=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(build_model("vit", VIT_ARGS, device="cpu"), compute_dtype=torch.float32,
                        mesh=_fake_mesh(1, 4))
