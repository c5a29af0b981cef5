"""Train entry point of the port (counterpart of train/train.py).

    python -m peekvit_torch.cli.train [group=option ...] [key.sub=value ...] [--device cpu]
    python -m peekvit_torch.cli.train -m model=vit_tiny,rankvit   # sequential multirun

The configuration is composed from ``configs/train_config.yaml`` (or
``--config-name``) by ``utils/config.py``. The run: the experiment
directory with its ``config.yaml`` and logger; the dataset and its
loaders; ``build_model`` (``training.remove_layers``, the seed, the
device); ``load_from`` (a checkpoint or an experiment directory);
``training.auto_resume`` (a ``partial`` checkpoint replays its epoch);
``training.reinit_class_tokens``; the losses, optimizer and scheduler by
``instantiate``; the ``Trainer``; then epochs 0..num_epochs with
validation at ``training.val_budgets``, periodic asynchronous
checkpoints and the SIGTERM path (``utils/preemption.py``).
``training.profile_epoch`` traces that epoch with ``torch.profiler`` into
``{experiment_dir}/profile``; ``training.debug_nans`` turns on
``torch.autograd.set_detect_anomaly``.

Not ported yet, and refused: ``training.qat`` (ROADMAP.md port queue A
item 8 part 2), ``training.plot_masks_every > 0`` (item 8 part 3),
``distributed`` (item 9).
"""

from __future__ import annotations

import itertools
import json
import os
import sys

from peekvit_torch.cli import PLOT_ITEM, QAT_ITEM, parse_args, refuse_distributed
from peekvit_torch.utils.config import instantiate, load_config, save_config, to_plain


def expand_multirun(overrides):
    """hydra ``--multirun``: comma-valued overrides become a cartesian
    sweep, one override list per run."""
    keys, options = [], []
    for ov in overrides:
        key, _, val = ov.partition("=")
        keys.append(key)
        options.append(val.split(",") if "," in val else [val])
    for combo in itertools.product(*options):
        yield [f"{k}={v}" for k, v in zip(keys, combo)]


def refuse_not_ported(cfg) -> None:
    """The options of the JAX entry point that the port does not run yet."""
    refuse_distributed(cfg)
    tr = cfg.training
    if tr.get("qat"):
        raise NotImplementedError(f"training.qat={tr.qat!r} is not ported yet: {QAT_ITEM}")
    if (tr.get("plot_masks_every", -1) or -1) > 0:
        raise NotImplementedError(f"training.plot_masks_every > 0 is not ported yet: {PLOT_ITEM}")


def setup_experiment(cfg):
    """(experiment dir, checkpoints dir, logger): the directory layout,
    its config.yaml and the configured logger."""
    from peekvit_torch.utils.checkpoint import make_experiment_directory

    experiment_dir = os.path.join(cfg.experiments_dir, cfg.experiment_name)
    checkpoints_dir, _ = make_experiment_directory(experiment_dir)
    save_config(cfg, os.path.join(experiment_dir, "config.yaml"))
    logger = (instantiate(cfg.logger, logging_dir=experiment_dir)
              if "logging_dir" not in (cfg.logger or {}) else instantiate(cfg.logger))
    print(f"Experiment dir: {experiment_dir}", flush=True)
    return experiment_dir, checkpoints_dir, logger


def make_loaders(dataset, cfg):
    from peekvit_torch.data.loader import DataLoader

    tr = cfg.training
    workers = tr.get("num_workers", 8)
    return (DataLoader(dataset.train_dataset, tr.train_batch_size, shuffle=True,
                       num_workers=workers, drop_last=True, seed=cfg.seed),
            DataLoader(dataset.val_dataset, tr.eval_batch_size, num_workers=workers))


def build_from_config(cfg, device, remove_layers=None):
    """``build_model`` from the config's model node and noise group."""
    from peekvit_torch.models.registry import build_model

    model_cfg = to_plain(cfg.model)
    model_class = model_cfg.pop("_target_").rsplit(".", 1)[-1]
    noise_args = to_plain(cfg.noise) if cfg.get("noise") else None
    return build_model(model_class, model_cfg, noise_args=noise_args,
                       remove_layers=remove_layers, seed=cfg.seed, device=device)


def load_from(cfg, model):
    """``load_from``: a checkpoint, or an experiment directory's last one,
    loaded non-strict."""
    from peekvit_torch.utils.checkpoint import get_checkpoint_path, load_state

    path = cfg.load_from
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, "metadata.json")):
        path = get_checkpoint_path(path)
    print(f"Loading from {path}", flush=True)
    return load_state(path, model, strict=False)


def train(cfg, device="cuda") -> dict:
    import torch

    from peekvit_torch.models import topology
    from peekvit_torch.models.registry import accepts_budget, resolve_device
    from peekvit_torch.training.trainer import Trainer
    from peekvit_torch.utils.checkpoint import (
        get_checkpoint_path,
        load_optimizer_state,
        load_state,
        save_state,
        wait_for_checkpoints,
    )
    from peekvit_torch.utils.losses import LossCompose
    from peekvit_torch.utils.preemption import PreemptionGuard

    dev = resolve_device(device)
    refuse_not_ported(cfg)
    tr = cfg.training
    anomaly = torch.is_anomaly_enabled()
    if tr.get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)

    experiment_dir, checkpoints_dir, logger = setup_experiment(cfg)
    dataset = instantiate(cfg.dataset)
    train_loader, val_loader = make_loaders(dataset, cfg)
    model = build_from_config(cfg, dev, remove_layers=tr.get("remove_layers") or None)
    if cfg.get("load_from"):
        model = load_from(cfg, model)

    # preemption recovery: this experiment's own last committed checkpoint;
    # a partial one restarts its epoch, a periodic one the next
    start_epoch, resume = 0, None
    if tr.get("auto_resume") and not cfg.get("load_from"):
        resume = get_checkpoint_path(experiment_dir)
        if resume:
            with open(os.path.join(resume, "metadata.json")) as f:
                meta = json.load(f)
            print(f"auto_resume: {resume} (epoch {meta['epoch']}"
                  + (", partial" if meta.get("partial") else "") + ")", flush=True)
            model = load_state(resume, model, strict=True)
            start_epoch = int(meta["epoch"]) + (0 if meta.get("partial") else 1)

    if tr.get("reinit_class_tokens"):
        model = topology.reinit_class_tokens(model, seed=cfg.seed)

    trainer = Trainer(
        model=model,
        optimizer=instantiate(cfg.optimizer),
        scheduler=instantiate(cfg.get("scheduler")),
        main_criterion=instantiate(cfg.loss.classification_loss),
        loss_compose=LossCompose(to_plain(cfg.loss.get("additional_losses") or {})),
        clip_grad_norm=tr.get("clip_grad_norm"),
        train_backbone=tr.get("train_backbone", True),
        seed=cfg.seed,
        fused=tr.get("fused", "auto"),
        pipeline_stages=int(tr.get("pipeline_stages") or 0),
        pipeline_microbatches=int(tr.get("pipeline_microbatches") or 0),
        sequence_parallel_devices=int(tr.get("sequence_parallel_devices") or 0),
        parallel_kernels=tr.get("parallel_kernels", "auto"),
        grad_accumulation=int(tr.get("grad_accumulation") or 1),
        remat=bool(tr.get("remat")),
        device=dev,
    )
    if resume and os.path.isfile(os.path.join(resume, "opt_state.pt")):
        trainer.torch_optimizer.load_state_dict(load_optimizer_state(resume))
        print("auto_resume: optimizer state restored", flush=True)

    train_budget = tr.get("train_budget")
    val_budgets = (tr.get("val_budgets") or [1.0]) if accepts_budget(model) else [None]
    results = {"experiment_dir": experiment_dir, "val_accuracy": {},
               "start_epoch": start_epoch}
    profile_epoch = tr.get("profile_epoch", -1)

    # SIGTERM: stop after the step in flight, write one synchronous
    # checkpoint (params and optimizer, partial when mid-epoch), return
    guard = PreemptionGuard()
    if tr.get("preemption_checkpointing", True):
        guard.install()

    def preemption_save(epoch: int, partial: bool) -> None:
        wait_for_checkpoints()  # do not race a periodic save in flight
        path = save_state(checkpoints_dir, model, trainer.torch_optimizer.state_dict(), epoch,
                          skip_optimizer=False, async_save=False,
                          extra_metadata={"partial": partial})
        print(f"  preemption checkpoint -> {path}" + (" (partial epoch)" if partial else ""),
              flush=True)
        results["preempted"] = True

    def run_epoch(epoch):
        return trainer.train_epoch(train_loader, epoch, logger=logger, budget=train_budget,
                                   should_stop=guard)

    try:
        for epoch in range(start_epoch, tr.num_epochs + 1):
            if epoch == profile_epoch:
                metrics = profiled(lambda: run_epoch(epoch), experiment_dir, epoch, dev)
            else:
                metrics = run_epoch(epoch)
            print(f"epoch {epoch}: total_loss={metrics.get('total_loss', float('nan')):.4f}",
                  flush=True)
            if metrics.get("interrupted"):
                preemption_save(epoch, partial=True)
                break
            if tr.eval_every > 0 and epoch % tr.eval_every == 0:
                for b in val_budgets:
                    acc, loss = trainer.validate(val_loader, budget=b)
                    tag = f"budget_{b}/val" if b is not None else "val"
                    logger.log({f"{tag}/accuracy": acc, f"{tag}/loss": loss})
                    print(f"  {tag}: acc={acc:.4f} loss={loss:.4f}", flush=True)
                    results["val_accuracy"][(epoch, b)] = acc
            if tr.checkpoint_every > 0 and epoch % tr.checkpoint_every == 0:
                # asynchronous by default: the write overlaps the next epoch
                path = save_state(checkpoints_dir, model, trainer.torch_optimizer.state_dict(),
                                  epoch, async_save=tr.get("async_checkpoints", True))
                print(f"  checkpoint -> {path}", flush=True)
            if guard.triggered:
                # the signal came between epochs: this epoch is complete
                preemption_save(epoch, partial=False)
                break
    finally:
        guard.uninstall()  # a multirun's next run installs its own
        torch.autograd.set_detect_anomaly(anomaly)
        wait_for_checkpoints()
        logger.close()
    return results


def profiled(fn, experiment_dir: str, epoch: int, device):
    """fn() under torch.profiler; the trace goes to
    {experiment_dir}/profile/trace.json."""
    import torch

    trace_dir = os.path.join(experiment_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    print(f"profiling epoch {epoch} -> {trace_dir}", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def main(argv=None):
    args = parse_args(argv, __doc__, "train_config", multirun=True)
    from peekvit_torch.models.registry import resolve_device

    resolve_device(args.device)  # before anything is built or loaded
    runs = expand_multirun(args.overrides) if args.multirun else [args.overrides]
    out = []
    for overrides in runs:
        cfg = load_config(args.config_dir, args.config_name, overrides)
        if args.multirun:
            print(f"=== multirun: {overrides} ===", flush=True)
        out.append(train(cfg, device=args.device))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
