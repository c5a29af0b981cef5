"""Reconstruction training entry point of the port (counterpart of
train/train_img_reconstruction.py).

    python -m peekvit_torch.cli.train_img_reconstruction model=residualvitwithdecoder [overrides]

The skeleton of ``cli.train``, for a model with a decoder (output
``(logits, reconstruction, mask)`` or ``(logits, reconstruction)``): the
Trainer adds the masked-pixel loss ``mean((x - recon)² · mask)`` at
weight 1.0. ``training.plot_masks_every > 0`` draws the input,
reconstruction and mask of ``training.num_images_to_plot`` validation
images at the first validation budget into
``{experiment_dir}/images/epoch_{e}/recon/``
(``utils/visualize.plot_reconstructed_images``).
"""

from __future__ import annotations

import os
import sys

from peekvit_torch.cli import parse_args
from peekvit_torch.cli.train import build_from_config, load_from, make_loaders, \
    refuse_not_ported, setup_experiment
from peekvit_torch.utils.config import instantiate, load_config, to_plain


def train_reconstruction(cfg, reconstruction_weight: float = 1.0, device="cuda") -> dict:
    from peekvit_torch.models.registry import accepts_budget, resolve_device
    from peekvit_torch.training.trainer import Trainer
    from peekvit_torch.utils.checkpoint import save_state, wait_for_checkpoints
    from peekvit_torch.utils.losses import LossCompose
    from peekvit_torch.utils.preemption import PreemptionGuard

    dev = resolve_device(device)
    refuse_not_ported(cfg)
    experiment_dir, checkpoints_dir, logger = setup_experiment(cfg)
    dataset = instantiate(cfg.dataset)
    tr = cfg.training
    train_loader, val_loader = make_loaders(dataset, cfg)
    model = build_from_config(cfg, dev)
    if getattr(model, "output_format", None) not in ("logits_recon_mask", "logits_recon"):
        raise ValueError("reconstruction training needs a decoder model "
                         "(e.g. model=residualvitwithdecoder)")
    if cfg.get("load_from"):
        model = load_from(cfg, model)

    trainer = Trainer(
        model=model,
        optimizer=instantiate(cfg.optimizer),
        scheduler=instantiate(cfg.get("scheduler")),
        main_criterion=instantiate(cfg.loss.classification_loss),
        loss_compose=LossCompose(to_plain(cfg.loss.get("additional_losses") or {})),
        clip_grad_norm=tr.get("clip_grad_norm"),
        train_backbone=tr.get("train_backbone", True),
        reconstruction_weight=reconstruction_weight,
        seed=cfg.seed,
        device=dev,
    )
    val_budgets = (tr.get("val_budgets") or [1.0]) if accepts_budget(model) else [None]
    results = {"experiment_dir": experiment_dir, "val_accuracy": {}}

    # the SIGTERM contract of cli.train: stop after the step in flight,
    # one synchronous checkpoint (params and optimizer, tagged partial)
    guard = PreemptionGuard()
    if tr.get("preemption_checkpointing", True):
        guard.install()
    try:
        for epoch in range(tr.num_epochs + 1):
            metrics = trainer.train_epoch(train_loader, epoch, logger=logger,
                                          budget=tr.get("train_budget"), should_stop=guard)
            print(f"epoch {epoch}: total={metrics.get('total_loss', float('nan')):.4f} "
                  f"recon={metrics.get('reconstruction_loss', float('nan')):.4f}", flush=True)
            if metrics.get("interrupted") or guard.triggered:
                wait_for_checkpoints()
                path = save_state(checkpoints_dir, model, trainer.torch_optimizer.state_dict(),
                                  epoch, skip_optimizer=False, async_save=False,
                                  extra_metadata={"partial": bool(metrics.get("interrupted"))})
                print(f"  preemption checkpoint -> {path}", flush=True)
                results["preempted"] = True
                break
            if tr.eval_every > 0 and epoch % tr.eval_every == 0:
                for b in val_budgets:
                    acc, loss = trainer.validate(val_loader, budget=b)
                    tag = f"budget_{b}/val" if b is not None else "val"
                    logger.log({f"{tag}/accuracy": acc, f"{tag}/loss": loss})
                    results["val_accuracy"][(epoch, b)] = acc
            if tr.checkpoint_every > 0 and epoch % tr.checkpoint_every == 0:
                save_state(checkpoints_dir, model, trainer.torch_optimizer.state_dict(), epoch,
                           async_save=tr.get("async_checkpoints", True))
            if tr.get("plot_masks_every", -1) > 0 and epoch % tr.plot_masks_every == 0:
                from peekvit_torch.utils.visualize import plot_reconstructed_images

                subset = [dataset.val_dataset[i] for i in range(tr.get("num_images_to_plot", 10))]
                plot_reconstructed_images(
                    model, subset, denormalize=getattr(dataset, "denormalize_transform", None),
                    budget=next((b for b in val_budgets if b is not None), None),
                    save_dir=os.path.join(experiment_dir, "images", f"epoch_{epoch}", "recon"))
    finally:
        guard.uninstall()
        wait_for_checkpoints()
        logger.close()
    return results


def main(argv=None):
    args = parse_args(argv, __doc__, "train_config")
    from peekvit_torch.models.registry import resolve_device

    resolve_device(args.device)
    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    return train_reconstruction(cfg, device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
