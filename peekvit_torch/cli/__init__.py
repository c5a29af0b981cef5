"""Command-line entry points of the port, driven by the repo's configs/:

    python -m peekvit_torch.cli.train [overrides] [--device cuda|cpu]
    python -m peekvit_torch.cli.train_img_reconstruction [overrides] [--device ...]
    python -m peekvit_torch.cli.test load_from=PATH [overrides] [--device ...]
    python -m peekvit_torch.cli.create_mask_plots load_from=PATH [overrides] [--device ...]
    python -m peekvit_torch.cli.create_cls_token_plots load_from=PATH [overrides] [--device ...]

(counterparts of train/train.py, train/train_img_reconstruction.py,
validate/test.py, validate/create_mask_plots.py and
validate/create_cls_token_plots.py). ``--device`` defaults to the card."""

import argparse
import os

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")

# the ROADMAP.md item of what the entry points do not run yet
PARALLEL_ITEM = "ROADMAP.md port queue A item 9 (parallel training and serving)"


def parse_args(argv, doc: str, config_name: str, multirun: bool = False):
    """The JAX entry points' arguments (positional overrides,
    ``--config-dir``, ``--config-name``, ``-m`` where they take it) and
    ``--device``."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--config-dir", default=CONFIG_DIR)
    p.add_argument("--config-name", default=config_name)
    if multirun:
        p.add_argument("-m", "--multirun", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu; nothing moves to the CPU unasked")
    p.add_argument("overrides", nargs="*")
    return p.parse_intermixed_args(argv)


def refuse_distributed(cfg) -> None:
    if cfg.get("distributed"):
        raise NotImplementedError(f"distributed=true is not ported yet: {PARALLEL_ITEM}")
