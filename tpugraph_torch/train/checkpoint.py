"""Checkpoint and resume (counterpart of ``tpugraph/train/checkpoint.py``),
written with ``torch.save``.

The trainer is deterministic given (config, epoch): uniform negatives come
from an epoch-derived generator, and the state a resume cannot rebuild is
saved: the model, the optimizer and its LR schedule, the interval's
negatives, boot proposals and ``fit_mtl``'s draws (relation corruptions,
attribute batch, OT subsample; a resume mid-interval reuses them), the
loss and the epoch.  So a resumed run reproduces the uninterrupted one.

Files under the checkpoint directory: ``ckpt-<epoch>.pt``, each written to
a temporary name and renamed, the newest ``KEEP`` kept; and beside them
``params.pt`` (``convert.PARAMS_FILE``), the parameters of the newest
save that the evaluation embeddings read (the encoder's, and the AE
channel's when it is on: ``convert.embed_params``), which
``train/driver.py::evaluate`` reads.

``install_preemption_handler`` latches SIGTERM, the signal a scheduler
sends before it reclaims a machine, into ``preempted``; the training loop
force-saves at the next epoch boundary and exits cleanly.
"""

from __future__ import annotations

import os
import re
import signal

import torch

from tpugraph_torch.convert import save_params

KEEP = 3  # newest checkpoints kept
_NAME = re.compile(r"ckpt-(\d+)\.pt")


class Checkpointer:
    """Epoch-scoped saves; with no directory or ``every`` ≤ 0 every call is
    a no-op."""

    def __init__(self, directory: str | None, every: int = 0):
        self.enabled = bool(directory) and every > 0
        self.dir = os.path.abspath(directory) if directory else None
        self.preempted = False
        self._prev_handler = None

    def install_preemption_handler(self) -> None:
        if not self.enabled:
            return

        def _latch(signum, frame):
            self.preempted = True

        try:
            self._prev_handler = signal.signal(signal.SIGTERM, _latch)
        except ValueError:
            pass  # not the main thread: the periodic saves still protect the run

    def restore_handler(self) -> None:
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except ValueError:
                pass
            self._prev_handler = None

    def _epochs(self) -> list[int]:
        if not self.enabled or not os.path.isdir(self.dir):
            return []
        return sorted(int(m.group(1)) for f in os.listdir(self.dir)
                      if (m := _NAME.fullmatch(f)))

    def latest_step(self) -> int | None:
        """Epoch of the newest checkpoint on disk, or None (also when disabled)."""
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def save(self, epoch: int, state: dict, params: dict[str, torch.Tensor]) -> None:
        """Write ``state`` as epoch ``epoch`` (unless that epoch is already
        the newest) and ``params`` as ``params.pt``; drop all but the newest
        ``KEEP`` checkpoints."""
        if not self.enabled or self.latest_step() == epoch:
            return
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"ckpt-{epoch}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"epoch": epoch, **state}, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
        save_params(self.dir, params)
        for old in self._epochs()[:-KEEP]:
            os.remove(os.path.join(self.dir, f"ckpt-{old}.pt"))

    def latest_has_key(self, key: str) -> bool | None:
        """Whether the newest checkpoint holds ``key`` (None when there is
        none); the file is mapped, not read."""
        step = self.latest_step()
        if step is None:
            return None
        return key in torch.load(os.path.join(self.dir, f"ckpt-{step}.pt"), map_location="cpu",
                                 weights_only=True, mmap=True)

    def restore_latest(self, device: torch.device | str = "cpu") -> tuple[int, dict] | None:
        """(epoch, state) of the newest checkpoint, tensors on ``device``;
        None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self.dir, f"ckpt-{step}.pt"), map_location=device,
                           weights_only=True)
        return state.pop("epoch"), state
