"""Preemption-safe training: catch SIGTERM, checkpoint, exit clean
(counterpart of peekvit_tpu/utils/preemption.py).

The train entries install a :class:`PreemptionGuard`: the signal only
sets a flag, the batch loop polls it between steps (``Trainer.train_epoch
(should_stop=...)``), and the entry then writes one synchronous
checkpoint, parameters and optimizer state, tagged ``partial`` in its
metadata. With ``training.auto_resume``:

- a run stopped in epoch N resumes at epoch N (the partial epoch
  replays; the optimizer state is a warm restart);
- a run stopped between epochs resumes at the next epoch;
- nothing resumes from a torn file: a checkpoint is visible only once
  its ``params.pt`` is committed (utils/checkpoint.py).

The handler chains the handler that was installed before it.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class PreemptionGuard:
    """Flag-only signal handler, safe to poll from the training loop.

    As a context manager it restores the previous handlers::

        with PreemptionGuard() as guard:
            trainer.train_epoch(loader, e, should_stop=guard)

    The instance is callable (it returns ``triggered``), so it can be
    passed as ``should_stop=``. CPython runs signal handlers on the main
    thread only and refuses to install one from another: ``install``
    installs nothing there, and ``triggered`` stays False unless
    :meth:`trigger` is called.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev = {}
        self._event = threading.Event()
        self.installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def __call__(self) -> bool:
        return self.triggered

    def trigger(self) -> None:
        """Set the flag without a signal (a cooperative stop)."""
        self._event.set()

    def _handle(self, signum, frame):
        self._event.set()
        prev = self._prev.get(signum)
        if callable(prev):  # chain the launcher's or the harness's handler
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            signal.signal(s, self._handle)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
