"""Serving bundles for the port's inference engines (counterpart of
peekvit_tpu/serving.py, with its names).

A bundle packages, into one directory:

1. ``params.npz``: the engine's PREPARED parameter tree as the engine
   computed it at build (bf16-cast, (1, k) vectors, LN affines folded,
   one-call weight stacks, int8 weights and scales; see
   ``inference.prepare_engine_params``), bf16 leaves as raw bytes (numpy
   has no bfloat16), their dtype and shape in the metadata;
2. ``meta.json``: the JAX bundle's fields (format version, ``platform``
   as the device type, batch geometry, budget mode, parameter specs) and
   the program: ``framework: "torch"``, ``forward`` (the name of one of
   the engine forwards in :data:`FORWARDS`) and ``forward_kwargs`` (its
   static keywords as JSON).

A JAX bundle holds a traced StableHLO program. The port's kernels are
bound through ``ctypes`` (``ops/cuda/_build.py``), which ``torch.export``
cannot trace through, so a port bundle NAMES its program instead: the
forward the live engine calls, resolved once at save by
``InferenceEngine._resolve`` (the same method the engine's ``__call__``
uses, so a bundle cannot drift from its engine). Loading builds nothing:
no module, no ``prepare_engine_params``, no quantization, calibration or
folding. It reads the files, places the leaves on the device and calls
the named forward.

Dead leaves (JAX ``_export_pruned``): the prepared tree keeps per-layer
originals, ``_folded_*`` copies and ``_stacked_layers`` so that every
engine path works, but one forward reads one set. The saver runs the
resolved forward on the sample batch over the tree wrapped so that every
leaf read is recorded (:class:`_Reads`); the other leaves are stored in
``meta`` only (``"dead": true``) and come back as shape-and-dtype tensors
on the ``meta`` device that raise when anything reads them. Their keys
stay, since the forwards count layers from the keys.

A bundle saved on one device type refuses to load on another (the
forwards run the CUDA kernels on the card and their plain versions on the
CPU), as JAX refuses another platform. :func:`load_serving_bundle`
defaults to the card.

Budget modes, as in JAX: ``"traced"`` (a ResidualViT, max 1.0; a
compact-auto ResidualViT at its export budget, serving budgets up to it
with that budget's capacities; a padded RankViT, its ``max_budget``): the
budget is an operand of every call; ``"static"`` (an exact-drop RankViT,
or a RankPCT with ranking on): one bundle per budget; ``"none"``: every
other engine. :func:`save_bucketed_bundle` stores several batch sizes
over one ``params.npz`` and serves any batch up to the largest by
zero-row padding, except a ``batch_coupled`` bundle (a ResidualViT whose
budget token is not ``'learnable'``), which serves exact bucket sizes
only.

CLI::

    python -m peekvit_torch.serving BUNDLE INPUT.npy [--budget B]
        [--out OUT.npy] [--bench N] [--device cuda|cpu]
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from peekvit_torch import inference as _inf
from peekvit_torch.models.registry import resolve_device

# JAX's format version; a port bundle is told apart by ``framework``
FORMAT_VERSION = 3
FRAMEWORK = "torch"
_PARAMS_FILE = "params.npz"
_META_FILE = "meta.json"
_JAX_ENGINE_FILE = "engine.stablehlo"

# every forward InferenceEngine._resolve returns, by name
FORWARDS = {f.__name__: f for f in (
    _inf.vit_forward_fused, _inf.vit_forward_quant, _inf.rankvit_forward_fused,
    _inf.rankvit_forward_quant, _inf.rankvit_forward_padded, _inf.rankvit_forward_padded_quant,
    _inf.residualvit_forward_fused, _inf.residualvit_forward_quant, _inf.moevit_forward_fused,
    _inf.moevit_forward_quant, _inf.adavit_forward_fused, _inf.maevit_forward_fused,
    _inf.pct_forward_fused, _inf.rankpct_forward_fused)}


def _flatten(tree, prefix=""):
    """Nested-dict tree -> {'a/b/c': leaf}. Engine param trees are pure
    string-keyed dicts (prepare_engine_params builds them that way)."""
    out = {}
    for k, v in tree.items():
        if not isinstance(k, str):
            raise TypeError(f"non-string param key {k!r} is not servable")
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"bundle names dtype {name!r}, not a torch dtype")
    return dtype


class _Reads(dict):
    """A params dict that adds the key path of every leaf read out of it
    to ``reads``; a nested dict comes back wrapped the same way. Counting
    or testing keys reads nothing. ``__iter__`` is overridden so that
    ``dict(d)`` and ``{**d}`` copy through ``__getitem__`` (and record)."""

    def __init__(self, tree: dict, prefix: str, reads: set):
        super().__init__(tree)
        self._prefix, self._reads = prefix, reads

    def _wrap(self, k, v):
        key = f"{self._prefix}/{k}" if self._prefix else k
        if isinstance(v, dict):
            return _Reads(v, key, self._reads)
        self._reads.add(key)
        return v

    def __getitem__(self, k):
        return self._wrap(k, super().__getitem__(k))

    def get(self, k, default=None):
        return self[k] if k in self else default

    def __iter__(self):
        return super().__iter__()

    def items(self):
        return [(k, self._wrap(k, v)) for k, v in super().items()]

    def values(self):
        return [v for _, v in self.items()]

    def copy(self):
        return dict(self.items())


class _DeadLeaf(torch.Tensor):
    """A leaf the bundle's forward never reads: its shape and dtype on the
    ``meta`` device, no bytes. Anything but its metadata raises (a meta
    tensor alone would let a CPU matmul read garbage)."""

    _METADATA = frozenset({torch.Tensor.shape.__get__, torch.Tensor.dtype.__get__,
                           torch.Tensor.device.__get__, torch.Tensor.ndim.__get__,
                           torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel,
                           torch.Tensor.__repr__})

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_subclass(cls, torch.empty(shape, dtype=dtype, device="meta"))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls._METADATA:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **(kwargs or {}))
        raise RuntimeError(
            f"{getattr(func, '__name__', func)} read a dead leaf of a serving bundle: its "
            "forward did not read this leaf when the bundle was saved, so its bytes were not "
            "stored")


def _run(forward, params, images, kwargs, operand):
    with torch.inference_mode():
        if operand is None:
            return forward(params, images, **kwargs)
        return forward(params, images, operand, **kwargs)


def _as_images(images, device) -> torch.Tensor:
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    return images.to(device, torch.float32)


def _check_exportable(engine):
    if engine._mesh is not None:
        raise NotImplementedError(
            "serving bundles are single-device artifacts; export the "
            "engine without mesh= and shard at the serving layer")
    if engine._noise is not None:
        raise NotImplementedError(
            "noise-sweep engines are an evaluation tool; build the "
            "engine from a model without noise_args to export it")


def _engine_call_for_export(engine, budget, meta):
    """``engine``'s (forward, keywords, budget operand) for the bundle,
    filling ``meta``'s budget fields (JAX serving.py:101-151). Shared by
    the single and bucketed exporters."""
    if engine._residual:
        if engine._compact_auto:
            # the capacities are static per budget: the bundle serves
            # budgets up to the export budget with its capacities (the
            # budget itself stays an operand)
            if budget is None:
                raise ValueError(
                    "a compact-auto residual engine sizes its capacity "
                    "per budget; pass budget= to export a bundle whose "
                    "capacity fits that budget (or build the engine with "
                    "compact=<capacity fraction> for one traced-budget "
                    "bundle)")
            meta["budget_mode"] = "traced"
            meta["max_budget"] = float(budget)
            return engine._resolve(float(budget))
        meta["budget_mode"] = "traced"
        meta["max_budget"] = 1.0
        return engine._resolve(1.0 if budget is None else float(budget))
    if engine._rank and engine._max_budget is not None:
        meta["budget_mode"] = "traced"
        meta["max_budget"] = float(engine._max_budget)
        return engine._resolve(engine._max_budget if budget is None else float(budget))
    if engine._rank or (engine._pct and any(engine._ranking or ())):
        if budget is None:
            raise ValueError(
                "an exact-drop ranking engine compiles one geometry "
                "per budget; pass budget= to export one bundle per "
                "served budget (RankViT engines can instead be built "
                "with max_budget= for a single traced-budget bundle)")
        meta["budget_mode"] = "static"
        meta["budget"] = float(budget)
        return engine._resolve(float(budget))
    return engine._resolve(None)


def _encode(v):
    """A forward keyword as JSON: a dtype by its name, tuples as lists."""
    if isinstance(v, torch.dtype):
        return _dtype_name(v)
    if isinstance(v, (tuple, list)):
        return [_encode(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"forward keyword {v!r} ({type(v).__name__}) is not servable")


def _decode(v):
    return tuple(_decode(x) for x in v) if isinstance(v, list) else v


def _program_meta(forward, kwargs) -> dict:
    if FORWARDS.get(forward.__name__) is not forward:
        raise NotImplementedError(f"{forward.__name__} is not a servable engine forward")
    kw = {k: v for k, v in kwargs.items() if not (k == "noise" and v is None)}
    return {"framework": FRAMEWORK, "forward": forward.__name__,
            "forward_kwargs": {k: _encode(v) for k, v in kw.items()}}


def _live_keys(engine, forward, kwargs, operand, images) -> set:
    """The keys of the leaves ``forward`` reads on ``images``."""
    reads: set = set()
    _run(forward, _Reads(engine.params, "", reads), images, kwargs, operand)
    return reads


def _stored(t: torch.Tensor) -> tuple:
    """(the tensor whose bytes are stored, layout): an int8 kernel is the
    (in, out) view of an (out, in) copy (``quant_blocks.kernel_layout``),
    stored and reloaded in that memory order."""
    if t.dim() >= 2 and not t.is_contiguous() and t.transpose(-1, -2).is_contiguous():
        return t.transpose(-1, -2), "transposed"
    return t.contiguous(), None


def _param_specs(flat, live):
    """meta['params'] entries: dtype and shape, ``dead`` where the forward
    never reads the leaf, the memory ``layout`` where it is not row-major."""
    specs = {}
    for k, v in flat.items():
        spec = {"dtype": _dtype_name(v.dtype), "shape": list(v.shape)}
        layout = _stored(v)[1]
        if k not in live:
            spec["dead"] = True
        elif layout:
            spec["layout"] = layout
        specs[k] = spec
    return specs


def _write_params_npz(npz_path, flat, live_keys):
    """The live leaves only, fetched to the host (bf16 as raw bytes)."""
    raw = {}
    for k in sorted(live_keys):
        t = _stored(flat[k])[0].detach().cpu().contiguous()
        raw[k] = (t.reshape(-1).view(torch.uint8).numpy() if t.dtype == torch.bfloat16
                  else t.numpy())
    np.savez(npz_path, **raw)


def _base_meta(engine, x):
    meta = {
        "format_version": FORMAT_VERSION,
        "platform": engine.device.type,
        "image_shape": list(x.shape),
        "image_dtype": _dtype_name(x.dtype),
        "budget_mode": "none",
    }
    if engine._batch_coupled:
        # non-learnable budget-token residual models: the gates take a
        # whole-batch budget-token mean, so one image's outputs depend on
        # its batchmates; serving layers must not zero-pad batches
        meta["batch_coupled"] = True
    return meta


def _write_meta(path, meta):
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)


def save_serving_bundle(engine, path: str, sample_images,
                        budget: Optional[float] = None) -> str:
    """Save ``engine`` (an ``inference.InferenceEngine``) called on
    ``sample_images``-shaped batches into a bundle directory at ``path``.

    ``budget`` is REQUIRED for an exact-drop RankViT engine (each budget
    is its own geometry: one bundle per budget) and for a compact-auto
    ResidualViT, and OPTIONAL for the padded (``max_budget=``) RankViT and
    the ResidualViT engines, whose budget stays an operand of every call.
    """
    _check_exportable(engine)
    x = _as_images(sample_images, engine.device)
    meta = _base_meta(engine, x)
    forward, kwargs, operand = _engine_call_for_export(engine, budget, meta)
    flat = _flatten(engine.params)
    live = _live_keys(engine, forward, kwargs, operand, x)
    meta.update(_program_meta(forward, kwargs))
    meta["params"] = _param_specs(flat, live)

    os.makedirs(path, exist_ok=True)
    _write_params_npz(os.path.join(path, _PARAMS_FILE), flat, live)
    _write_meta(path, meta)
    return path


def _map_out(fn, out):
    """``fn`` over an engine output: one tensor or a tuple of them."""
    return tuple(fn(v) for v in out) if isinstance(out, (tuple, list)) else fn(out)


class ServingEngine:
    """A loaded bundle: ``engine(images[, budget=])`` like the live
    ``InferenceEngine``, from the files alone."""

    def __init__(self, forward, kwargs, params, meta, device):
        self._forward, self._kwargs = forward, kwargs
        self.params = params
        self.meta = meta
        self.device = device

    @property
    def batch_sizes(self) -> tuple:
        """Batch geometries this artifact serves (one for a plain bundle)."""
        return (self.meta["image_shape"][0],)

    def __call__(self, images, budget: Optional[float] = None):
        want = tuple(self.meta["image_shape"])
        if tuple(images.shape) != want:
            raise ValueError(
                f"bundle was exported for image batches of shape {want}, "
                f"got {tuple(images.shape)}; export one bundle per "
                "served batch size (engine shapes are static)")
        mode = self.meta["budget_mode"]
        operand = None
        if mode == "none":
            if budget is not None:
                raise ValueError("bundle has no budget knob")
        elif mode == "static":
            if budget is not None and float(budget) != self.meta["budget"]:
                raise ValueError(
                    f"bundle was exported at static budget "
                    f"{self.meta['budget']}; got {budget}")
        else:
            operand = 1.0 if budget is None else float(budget)
            if operand > self.meta["max_budget"] + 1e-9:
                raise ValueError(
                    f"budget {operand} exceeds the bundle's max_budget "
                    f"{self.meta['max_budget']}")
        return _run(self._forward, self.params, _as_images(images, self.device), self._kwargs,
                    operand)


def _tile_batch(x, n: int):
    """First ``n`` rows of ``x``, tiling it if ``n`` exceeds its batch."""
    reps = -(-n // x.shape[0])
    return x.repeat((reps,) + (1,) * (x.dim() - 1))[:n]


def save_bucketed_bundle(engine, path: str, sample_images,
                         batch_sizes, budget: Optional[float] = None) -> str:
    """Save one sub-bundle per batch-size BUCKET under ``path`` (engine
    shapes are static), sharing ONE ``params.npz`` (the prepared tree does
    not depend on the batch; the stored set is the union of each bucket's
    live leaves). Each ``b{n}/`` sub-directory holds that bucket's meta;
    the top-level ``meta.json`` names the buckets. :func:`load_serving_bundle`
    on ``path`` returns a :class:`BucketedServingEngine` that serves ANY
    batch size up to the largest bucket: inputs pad with zero rows to the
    smallest bucket that fits and outputs slice back. Inference math is
    per-image for every engine family EXCEPT residual models with a
    non-``learnable`` budget token (whole-batch budget-token mean in the
    gate threshold): those save fine but refuse padded calls, and only
    exact bucket sizes serve (include bucket 1 to serve request at a
    time).
    """
    _check_exportable(engine)
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
    x = _as_images(sample_images, engine.device)
    os.makedirs(path, exist_ok=True)
    flat = _flatten(engine.params)

    # run every bucket first: the live set may differ per geometry, so the
    # shared npz stores the union
    union_live, per_bucket = set(), {}
    for n in buckets:
        xb = _tile_batch(x, n)
        meta = _base_meta(engine, xb)
        forward, kwargs, operand = _engine_call_for_export(engine, budget, meta)
        live = _live_keys(engine, forward, kwargs, operand, xb)
        meta.update(_program_meta(forward, kwargs))
        meta["params"] = _param_specs(flat, live)
        meta["params_file"] = f"../{_PARAMS_FILE}"
        per_bucket[n] = meta
        union_live |= live

    _write_params_npz(os.path.join(path, _PARAMS_FILE), flat, union_live)
    for n, meta in per_bucket.items():
        sub = os.path.join(path, f"b{n}")
        os.makedirs(sub, exist_ok=True)
        _write_meta(sub, meta)

    sub_meta0 = per_bucket[buckets[0]]
    meta = {"format_version": FORMAT_VERSION, "framework": FRAMEWORK, "buckets": buckets,
            "platform": sub_meta0["platform"],
            "image_shape": [buckets[-1]] + sub_meta0["image_shape"][1:],
            "image_dtype": sub_meta0["image_dtype"],
            "budget_mode": sub_meta0["budget_mode"]}
    for k in ("budget", "max_budget", "batch_coupled"):
        if k in sub_meta0:
            meta[k] = sub_meta0[k]
    _write_meta(path, meta)
    return path


class BucketedServingEngine:
    """Several batch-geometry buckets of one saved engine behind a single
    flexible-batch ``__call__``: any batch up to the largest bucket runs on
    the smallest bucket that fits (zero-row padding, outputs sliced back
    to the true batch)."""

    def __init__(self, engines: dict, meta):
        self._engines = dict(sorted(engines.items()))
        self.meta = meta
        self.device = next(iter(self._engines.values())).device

    @property
    def batch_sizes(self) -> tuple:
        return tuple(self._engines)

    def __call__(self, images, budget: Optional[float] = None):
        x = _as_images(images, self.device)
        want = tuple(self.meta["image_shape"][1:])
        if tuple(x.shape[1:]) != want:
            raise ValueError(
                f"bundle serves items of shape {want}, got batches of "
                f"{tuple(x.shape[1:])}")
        n = x.shape[0]
        fit = [b for b in self._engines if b >= n]
        if not fit:
            raise ValueError(
                f"batch {n} exceeds the largest exported bucket "
                f"{max(self._engines)}; split the batch or re-export "
                "with a larger bucket")
        bucket = fit[0]
        if bucket != n:
            if self.meta.get("batch_coupled"):
                raise ValueError(
                    f"batch {n} needs zero-padding to bucket {bucket}, but "
                    "this model's gate thresholds use a whole-batch "
                    "budget-token mean (pad rows would perturb real "
                    f"outputs); send exact bucket sizes "
                    f"{self.batch_sizes}, or export with bucket 1")
            x = torch.cat([x, x.new_zeros((bucket - n,) + tuple(x.shape[1:]))])
        out = self._engines[bucket](x, budget=budget)
        return _map_out(lambda v: v[:n], out) if bucket != n else out


def _refuse_foreign(path: str, meta: dict) -> None:
    if meta.get("framework") != FRAMEWORK or os.path.exists(
            os.path.join(path, _JAX_ENGINE_FILE)):
        raise ValueError(
            f"{path} is not a bundle of the PyTorch port (a JAX bundle holds "
            f"{_JAX_ENGINE_FILE}, a StableHLO program): the port loads meta.json with "
            f"framework {FRAMEWORK!r} and a named engine forward, as "
            "peekvit_torch.serving.save_serving_bundle writes it; re-export "
            "the engine from the port")


def _leaf(arr: np.ndarray, spec: dict, device) -> torch.Tensor:
    shape = tuple(spec["shape"])
    if spec.get("layout") == "transposed":
        shape = shape[:-2] + (shape[-1], shape[-2])
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if spec["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    t = t.reshape(shape).to(device)
    return t.transpose(-1, -2) if spec.get("layout") == "transposed" else t


def load_serving_bundle(path: str, device="cuda", _cache: Optional[dict] = None):
    """Load a bundle saved by :func:`save_serving_bundle` (returns a
    :class:`ServingEngine`) or :func:`save_bucketed_bundle` (returns a
    :class:`BucketedServingEngine`) onto ``device`` (the card by default;
    it raises without one). Builds nothing: no model, no preparation."""
    dev = resolve_device(device)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    _refuse_foreign(path, meta)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"bundle format {meta.get('format_version')} is not {FORMAT_VERSION} "
            "(this library)")
    if meta["platform"] != dev.type:
        raise ValueError(
            f"bundle was saved for device type {meta['platform']!r}; this "
            f"load asks for {dev.type!r} (the forwards run the CUDA kernels on "
            "the card and their plain versions on the CPU: re-export on the "
            "serving device type)")
    if "buckets" in meta:
        # one device copy of each shared leaf across all buckets
        cache: dict = {}
        engines = {n: load_serving_bundle(os.path.join(path, f"b{n}"), device=dev,
                                          _cache=cache)
                   for n in meta["buckets"]}
        return BucketedServingEngine(engines, meta)
    forward = FORWARDS.get(meta["forward"])
    if forward is None:
        raise ValueError(f"bundle names forward {meta['forward']!r}, not one of "
                         f"{sorted(FORWARDS)}")
    kwargs = {k: _decode(v) for k, v in meta["forward_kwargs"].items()}
    if "compute_dtype" in kwargs:
        kwargs["compute_dtype"] = _dtype(kwargs["compute_dtype"])
    # bucketed sub-bundles share their parent's params file
    npz = np.load(os.path.join(path, meta.get("params_file", _PARAMS_FILE)))
    flat = {}
    for key, spec in meta["params"].items():
        if spec.get("dead"):
            flat[key] = _DeadLeaf(tuple(spec["shape"]), _dtype(spec["dtype"]))
        elif _cache is not None and key in _cache:
            flat[key] = _cache[key]
        else:
            flat[key] = _leaf(npz[key], spec, dev)
            if _cache is not None:
                _cache[key] = flat[key]
    return ServingEngine(forward, kwargs, _unflatten(flat), meta, dev)


def _main(argv=None):
    """Minimal serving-host CLI::

        python -m peekvit_torch.serving BUNDLE INPUT.npy \\
            [--budget B] [--out OUT.npy] [--bench N] [--device cuda|cpu]

    Loads the bundle, runs the .npy batch (which must match the saved
    batch geometry, or fit a bucket), optionally saves the outputs (.npy,
    or .npz with ``out_0..`` keys for tuple-output bundles) and times N
    steady-state calls. No model zoo, config system or preparation code
    runs.
    """
    import argparse
    import time

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("bundle")
    p.add_argument("input", help=".npy batch matching meta.image_shape")
    p.add_argument("--budget", type=float, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--bench", type=int, default=0,
                   help="wall-clock N calls after warmup")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; nothing moves to the CPU unasked")
    args = p.parse_args(argv)

    srv = load_serving_bundle(args.bundle, device=args.device)

    def sync(out):
        if srv.device.type == "cuda":
            torch.cuda.synchronize(srv.device)
        return out

    x = torch.from_numpy(np.load(args.input))
    out = sync(srv(x, budget=args.budget))
    leaves = list(out) if isinstance(out, (tuple, list)) else [out]
    info = {"bundle": args.bundle,
            "outputs": [list(v.shape) for v in leaves],
            "budget_mode": srv.meta["budget_mode"]}
    if args.bench:
        t0 = time.perf_counter()
        for _ in range(args.bench):
            sync(srv(x, budget=args.budget))
        dt = (time.perf_counter() - t0) / args.bench
        info["ms_per_batch"] = dt * 1000
        info["items_per_s"] = x.shape[0] / dt
    if args.out:
        if len(leaves) == 1:
            np.save(args.out, leaves[0].cpu().numpy())
        else:
            np.savez(args.out, **{f"out_{i}": v.cpu().numpy() for i, v in enumerate(leaves)})
        info["saved"] = args.out
    print(json.dumps(info))
    return info


if __name__ == "__main__":
    _main()
