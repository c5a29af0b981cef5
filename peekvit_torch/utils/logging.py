"""Metric loggers behind one ``log(dict)`` interface (counterpart of
peekvit_tpu/utils/logging.py; chosen by configs/logger/*.yaml).

The metric keys are the JAX package's: ``train/total_loss``,
``train/classification_loss``, ``train/lr``, ``budget_{b}/val/accuracy``,
``test/budget_{b}/noise_{n}`` and so on.
"""

from __future__ import annotations

import os
import pprint
import time
from typing import Optional


class SimpleLogger:
    """Appends every dict to ``{dir}/log.txt``, one a line; pretty-prints
    to stdout at most once per ``stdout_every`` seconds."""

    def __init__(self, logging_dir: Optional[str] = None,
                 stdout_every: float = 10.0, **_):
        self.logging_dir = logging_dir
        self.stdout_every = stdout_every
        self._last_stdout = 0.0
        self._file = None
        if logging_dir:
            os.makedirs(logging_dir, exist_ok=True)
            self._file = open(os.path.join(logging_dir, "log.txt"), "a")

    def set_dir(self, logging_dir: str) -> None:
        if self._file:
            self._file.close()
        os.makedirs(logging_dir, exist_ok=True)
        self.logging_dir = logging_dir
        self._file = open(os.path.join(logging_dir, "log.txt"), "a")

    def log(self, metrics: dict) -> None:
        metrics = {k: _to_py(v) for k, v in metrics.items()}
        if self._file:
            self._file.write(f"{metrics}\n")
            self._file.flush()
        now = time.time()
        if now - self._last_stdout >= self.stdout_every:
            pprint.pprint(metrics)
            self._last_stdout = now

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None


class WandbLogger:
    """wandb-backed logger; ``wandb`` is imported when the logger is built.
    Where it cannot be imported or started, it falls back to a
    SimpleLogger in ``logging_dir`` and says so."""

    def __init__(self, wandb_entity: Optional[str] = None,
                 wandb_project: str = "peekvit_tpu",
                 wandb_run: Optional[str] = None,
                 logging_dir: Optional[str] = None, **_):
        self._fallback = None
        self._run = None
        try:
            import wandb

            self._run = wandb.init(entity=wandb_entity, project=wandb_project,
                                   name=wandb_run)
        except Exception as e:  # not installed, or no network
            print(f"[WandbLogger] falling back to SimpleLogger: {e}")
            self._fallback = SimpleLogger(logging_dir)

    def set_dir(self, logging_dir: str) -> None:
        if self._fallback:
            self._fallback.set_dir(logging_dir)

    def log(self, metrics: dict) -> None:
        if self._run is not None:
            self._run.log({k: _to_py(v) for k, v in metrics.items()})
        else:
            self._fallback.log(metrics)

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()
        elif self._fallback:
            self._fallback.close()


def _to_py(v):
    """A 0-d tensor or numpy scalar as a Python number."""
    return v.item() if hasattr(v, "item") and getattr(v, "ndim", None) == 0 else v
