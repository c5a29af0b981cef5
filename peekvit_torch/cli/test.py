"""Eval entry point of the port: budget x noise sweeps with accuracy,
effective FLOPs, throughput and sparsity (counterpart of
validate/test.py).

    python -m peekvit_torch.cli.test load_from=PATH [overrides] [--device cpu]

``load_from`` is a checkpoint, an experiment directory (its last
checkpoint), a list of them, or null (the current experiment directory).
The model is rebuilt from the checkpoint's metadata unless the config
names one; a config's model with ``torch_pretrained_weights`` /
``timm_pretrained_weights`` (a local ``.pth``) is served as built where
no checkpoint exists. A ``noise`` group on a model built without one
retrofits the NoiseBlock.

The sweep runs on the ``InferenceEngine`` of the model's family
(``test.quantized``, ``engine_max_budget``, ``calib_images``,
``compact``, ``compact_slack``, ``routed``). Only a
``NotImplementedError`` raised while the engine is constructed sends it
to the module's own fp32 forward; the run prints ``eval path: ...``
either way. Throughput is reported with the input pipeline (wall
images/s) and on the device alone (``utils/timing.py``).

Not ported yet, and refused: ``test.export_bundle``,
``test.tensor_parallel_devices > 1`` and ``distributed`` (ROADMAP.md port
queue A item 9). The recap and cumulative plots (item 8 part 3) are
skipped, with one printed line.
"""

from __future__ import annotations

import os
import sys
import time

from peekvit_torch.cli import PARALLEL_ITEM, PLOT_ITEM, parse_args, refuse_distributed
from peekvit_torch.utils.config import instantiate, load_config, to_plain

# the families the JAX sweep serves on its engine (validate/test.py:79-85)
ENGINE_FAMILIES = ("VisionTransformer", "RankVisionTransformer", "ResidualVisionTransformer",
                   "VisionTransformerMoE", "AdaptiveVisionTransformer",
                   "EEResidualVisionTransformer", "ResidualVisionTransformerWithDecoder",
                   "PointCloudTransformer", "RankPointCloudTransformer",
                   "MAEVisionTransformer")


def refuse_not_ported(cfg) -> None:
    refuse_distributed(cfg)
    tcfg = cfg.test
    if tcfg.get("export_bundle"):
        raise NotImplementedError(f"test.export_bundle is not ported yet: {PARALLEL_ITEM}")
    if int(tcfg.get("tensor_parallel_devices", 0) or 0) > 1:
        raise NotImplementedError(
            f"test.tensor_parallel_devices > 1 is not ported yet: {PARALLEL_ITEM}")


def _engine_options(tcfg):
    """(compact, routed) as the JAX sweep reads them."""
    compact = tcfg.get("compact")
    if compact is not None and not isinstance(compact, bool):
        try:  # a per-layer capacity schedule
            compact = tuple(float(c) for c in compact)
        except TypeError:
            compact = float(compact)
    routed = tcfg.get("routed")
    if routed is not None and not isinstance(routed, bool):
        routed = float(routed)
    return compact, routed


def make_engine(model, cfg, val_loader, device):
    """The family's InferenceEngine, or None (the module path) where the
    constructor raises NotImplementedError or the config turns it off.
    Prints the path taken."""
    import torch

    from peekvit_torch.inference import InferenceEngine

    tcfg = cfg.test
    if not (tcfg.get("use_fused_engine", True) and type(model).__name__ in ENGINE_FAMILIES):
        print("eval path: module", flush=True)
        return None
    calib = None
    n_calib = int(tcfg.get("calib_images", 0) or 0)
    if tcfg.get("quantized") and n_calib > 0:
        # SmoothQuant (and static caps) calibrated on the head of the val set
        xs = []
        for bx, _ in val_loader:
            xs.append(torch.as_tensor(bx))
            if sum(x.shape[0] for x in xs) >= n_calib:
                break
        calib = torch.cat(xs)[:n_calib]
    compact, routed = _engine_options(tcfg)
    try:
        engine = InferenceEngine(
            model, device=device, quantized=tcfg.get("quantized", False),
            max_budget=tcfg.get("engine_max_budget"), calib_images=calib,
            calib_percentile=float(tcfg.get("calib_percentile", 99.9)),
            calib_static_caps=bool(tcfg.get("calib_static_caps", False)),
            compact=compact or None, compact_slack=float(tcfg.get("compact_slack", 0.0)),
            routed=routed or None)
    except NotImplementedError as e:  # a mode the engine does not serve
        print(f"eval path: module (fused engine unavailable: {e})", flush=True)
        return None
    print("eval path: fused InferenceEngine"
          + (" (int8 w8a8)" if tcfg.get("quantized") else "")
          + (" (token compaction)" if compact else "")
          + (" (routed MoE)" if routed else "")
          + (f" [calibrated on {n_calib}"
             + (", static caps]" if tcfg.get("calib_static_caps") else "]")
             if calib is not None else ""), flush=True)
    return engine


def validate(model, cfg, dataset, experiment_dir, logger, device="cuda") -> dict:
    """One experiment's sweep; the summary has the JAX sweep's keys."""
    import torch

    from peekvit_torch.data.loader import DataLoader, prefetch_to_device
    from peekvit_torch.models.registry import accepts_budget, resolve_device
    from peekvit_torch.training.trainer import _main_logits
    from peekvit_torch.utils.flops_count import compute_flops, eval_forward, \
        sparsity_per_module
    from peekvit_torch.utils.timing import device_seconds_per_iter

    dev = resolve_device(device)
    tcfg = cfg.test
    workers = tcfg.get("num_workers", 8)
    val_loader = DataLoader(dataset.val_dataset, tcfg.test_batch_size, num_workers=workers)
    takes_budget = accepts_budget(model)
    budgets = (tcfg.get("budgets") or [1.0]) if takes_budget else [None]
    noises = (tcfg.get("noises") if cfg.get("noise") else None) or [None]
    if cfg.get("enable_ranking") and hasattr(model, "ranking_enabled"):
        model.enable_ranking(True)
    engine = make_engine(model, cfg, val_loader, dev)
    out_fmt = getattr(model, "output_format", None)

    def forward(x, b, nv):
        if engine is not None:
            return engine(x, budget=b, noise_value=nv) if takes_budget \
                else engine(x, noise_value=nv)
        return _main_logits(eval_forward(model, x, b, nv)[0], out_fmt)

    results_per_budget, flops_per_budget, sparsities_per_budget = {}, {}, {}
    timings, device_timings = {}, {}
    flops_batch = None
    if tcfg.get("flops_batch_size"):  # a separate batch size for FLOPs and timing
        fl = DataLoader(dataset.val_dataset, tcfg.flops_batch_size, num_workers=workers)
        flops_batch = torch.as_tensor(next(iter(fl))[0]).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for b in budgets:
        results_per_budget[b] = {}
        for nv in noises:
            # warm up before the timed loop, so images/s is the steady state
            warm = next(iter(prefetch_to_device(iter(val_loader), size=1, device=dev)))
            forward(warm[0], b, nv)
            sync()
            total = 0
            correct = torch.zeros((), dtype=torch.int64, device=dev)
            t0 = time.time()
            for x, y in prefetch_to_device(iter(val_loader), size=2, device=dev):
                if flops_batch is None:
                    flops_batch = x
                correct += (forward(x, b, nv).argmax(-1) == y).sum()
                total += int(y.shape[0])
            acc = int(correct) / max(total, 1)
            elapsed = time.time() - t0
            results_per_budget[b][nv] = acc
            logger.log({f"test/budget_{b}/noise_{nv}": acc})
            print(f"budget={b} noise={nv}: acc={acc:.4f} ({total / elapsed:.1f} img/s wall)",
                  flush=True)
            if nv == noises[0]:
                timings[b] = total / elapsed

        # device-only throughput: the forward alone on one resident batch,
        # at the sweep's first noise value
        def timed():
            return forward(flops_batch, b, noises[0])

        if tcfg.get("profile") and not device_timings:
            trace_dir = os.path.join(experiment_dir, "profile")
            os.makedirs(trace_dir, exist_ok=True)
            print(f"profiling device loop -> {trace_dir}", flush=True)
            activities = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with torch.profiler.profile(activities=activities) as prof:
                sec = device_seconds_per_iter(timed, dev, reps=5)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        else:
            sec = device_seconds_per_iter(timed, dev, reps=5)
        device_timings[b] = int(flops_batch.shape[0]) / sec

        if not tcfg.get("skip_flops_count", False):
            flops_per_budget[b], _ = compute_flops(model, flops_batch, budget=b)
            sparsities_per_budget[b] = sparsity_per_module(model, flops_batch, budget=b)

    summary = {"results_per_budget": results_per_budget, "flops": flops_per_budget,
               "timings_wall": timings, "timings_device": device_timings,
               "sparsities_per_budget": sparsities_per_budget}
    logger.log(summary)
    return summary


def _pretrained(cfg) -> bool:
    model = cfg.get("model") or {}
    return bool(model.get("torch_pretrained_weights") or model.get("timm_pretrained_weights"))


def run_test(cfg, device="cuda") -> dict:
    from peekvit_torch.cli.train import build_from_config
    from peekvit_torch.models.registry import build_model, resolve_device
    from peekvit_torch.utils.checkpoint import (
        get_checkpoint_path,
        load_state,
        make_experiment_directory,
    )

    dev = resolve_device(device)
    refuse_not_ported(cfg)
    dataset = instantiate(cfg.dataset)
    load_from = cfg.get("load_from")
    current_dir = os.path.join(cfg.experiments_dir, cfg.experiment_name)
    if load_from is None:
        experiment_dirs = [current_dir]
    elif isinstance(load_from, str):
        experiment_dirs = [load_from]
    else:
        experiment_dirs = list(load_from)

    all_results = {}
    for experiment_dir in experiment_dirs:
        ckpt = (experiment_dir
                if os.path.exists(os.path.join(experiment_dir, "metadata.json"))
                else get_checkpoint_path(experiment_dir))
        if ckpt is None and not (cfg.get("model") and _pretrained(cfg)):
            raise FileNotFoundError(f"No checkpoint under {experiment_dir}")
        out_dir = experiment_dir if os.path.isdir(experiment_dir) else current_dir
        make_experiment_directory(out_dir)
        logger = instantiate(cfg.logger, logging_dir=out_dir)

        model = build_from_config(cfg, dev) if cfg.get("model") else None
        if ckpt is not None:
            model = load_state(ckpt, model, strict=True, device=dev)
        else:
            print(f"no checkpoint under {experiment_dir}: serving the model config's "
                  "pretrained weights", flush=True)
        if cfg.get("noise") and model.noise_args is None:
            # retrofit the NoiseBlock at eval time, the weights kept
            noisy = build_model(model.model_class, model.model_args,
                                noise_args=to_plain(cfg.noise), device=dev)
            noisy.load_state_dict(model.state_dict())
            model = noisy

        summary = validate(model, cfg, dataset, experiment_dir, logger, device=dev)
        all_results[experiment_dir] = summary
        if any(b is not None for b in summary["results_per_budget"]):
            print(f"recap plots skipped: {PLOT_ITEM}", flush=True)
        logger.close()

    if cfg.test.get("cumulative_plot") and len(all_results) > 1:
        cum_dir = cfg.test.get("cumulative_plot_dir") or current_dir
        os.makedirs(cum_dir, exist_ok=True)
        print(f"cumulative plots skipped: {PLOT_ITEM}", flush=True)
        with open(os.path.join(cum_dir, "cumulative_log.txt"), "a") as f:
            for d, summary in all_results.items():
                f.write(f"{d}: {summary}\n")
    return all_results


def main(argv=None):
    args = parse_args(argv, __doc__, "test_config")
    from peekvit_torch.models.registry import resolve_device

    resolve_device(args.device)
    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    return run_test(cfg, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
