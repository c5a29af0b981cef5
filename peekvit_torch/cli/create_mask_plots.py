"""Token-mask plots of a trained model (counterpart of
validate/create_mask_plots.py).

    python -m peekvit_torch.cli.create_mask_plots load_from=EXPERIMENT_DIR
        [overrides] [--device cpu]

Loads the checkpoint (``load_from``: a checkpoint, or an experiment
directory's last one) and, for every budget in ``test.budgets`` (one
``None`` for a model that takes no budget), draws the per-layer
incremental token masks of the first ``test.num_images`` validation
images into ``{experiment_dir}/images/epoch_{e}/budget_{b}/`` with
``utils/visualize.plot_masked_images`` (``test.hard_mask``,
``test.skip_layers_for_masks``, ``test.overlay_mask_on_image``,
``test.masked_region_color``).
"""

from __future__ import annotations

import os
import sys

from peekvit_torch.cli import parse_args
from peekvit_torch.utils.config import instantiate, load_config


def load_experiment(cfg, device):
    """(experiment dir, checkpoint path, model): ``load_from`` or the
    current experiment directory, its checkpoint, the model rebuilt from
    it on ``device``."""
    from peekvit_torch.utils.checkpoint import get_checkpoint_path, load_state

    experiment_dir = cfg.get("load_from") or os.path.join(cfg.experiments_dir,
                                                          cfg.experiment_name)
    ckpt = (experiment_dir if os.path.exists(os.path.join(experiment_dir, "metadata.json"))
            else get_checkpoint_path(experiment_dir))
    if ckpt is None:
        raise FileNotFoundError(f"No checkpoint under {experiment_dir}")
    return experiment_dir, ckpt, load_state(ckpt, device=device)


def main(argv=None):
    args = parse_args(argv, __doc__, "test_config")
    from peekvit_torch.models.registry import accepts_budget, resolve_device
    from peekvit_torch.utils.visualize import plot_masked_images

    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    experiment_dir, ckpt, model = load_experiment(cfg, device)
    epoch = os.path.basename(ckpt).replace("epoch_", "").lstrip("0") or "0"
    dataset = instantiate(cfg.dataset)
    tcfg = cfg.test
    subset = [dataset.val_dataset[i] for i in range(tcfg.get("num_images", 20))]
    budgets = (tcfg.get("budgets") or [1.0]) if accepts_budget(model) else [None]
    out = []
    for b in budgets:
        save_dir = os.path.join(experiment_dir, "images", f"epoch_{epoch}", f"budget_{b}")
        out += plot_masked_images(
            model, subset, denormalize=getattr(dataset, "denormalize_transform", None),
            hard=tcfg.get("hard_mask", True), skip_layers=tcfg.get("skip_layers_for_masks", []),
            overlay=tcfg.get("overlay_mask_on_image", False),
            masked_region_color=tcfg.get("masked_region_color", "lightsteelblue"),
            budget=b, save_dir=save_dir)
        print(f"budget {b}: wrote {save_dir}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
