"""Class-token plots of a trained model (counterpart of
validate/create_cls_token_plots.py).

    python -m peekvit_torch.cli.create_cls_token_plots load_from=EXPERIMENT_DIR
        [overrides] [--device cpu]

Loads the checkpoint as ``cli.create_mask_plots`` does and, for the first
``test.num_images`` validation images, at the first of ``test.budgets``
for a model that takes a budget, writes ``cls_tokens_{i}.png``,
``cls_distances_{i}.png`` and ``token_norms_{i}.png`` into
``{experiment_dir}/images/cls_tokens/`` (``utils/visualize.py``).
"""

from __future__ import annotations

import os
import sys

from peekvit_torch.cli import parse_args
from peekvit_torch.cli.create_mask_plots import load_experiment
from peekvit_torch.utils.config import instantiate, load_config


def main(argv=None):
    args = parse_args(argv, __doc__, "test_config")
    from peekvit_torch.models.registry import accepts_budget, resolve_device
    from peekvit_torch.utils import visualize as viz

    device = resolve_device(args.device)
    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    experiment_dir, _, model = load_experiment(cfg, device)
    dataset = instantiate(cfg.dataset)
    budget = (cfg.test.get("budgets") or [None])[0] if accepts_budget(model) else None
    out_dir = os.path.join(experiment_dir, "images", "cls_tokens")
    paths = []
    for i in range(min(cfg.test.get("num_images", 20), len(dataset.val_dataset))):
        img = dataset.val_dataset[i][0]
        for fn, stem in ((viz.plot_class_tokens, "cls_tokens"),
                         (viz.plot_class_tokens_distances, "cls_distances"),
                         (viz.plot_token_norms, "token_norms")):
            paths.append(fn(model, img, budget=budget,
                            save_path=os.path.join(out_dir, f"{stem}_{i}.png")))
    print(f"wrote {len(paths)} plots to {out_dir}", flush=True)
    return paths


if __name__ == "__main__":
    main(sys.argv[1:])
