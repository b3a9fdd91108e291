"""Checkpoint / resume for long-running pipelines (port of
``ransac_tpu.utils.checkpointing``).

A dict of arrays (an SfM map, a BA problem) is saved as one ``.npz`` a
step, written to a temporary name and renamed into place, so a
preempted run resumes from its last complete snapshot.  The JAX package
saves through orbax, with ``.npz`` as its fallback; orbax is not on the
card's machine, and ``.npz`` needs no pickle to read back.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

_STEP = re.compile(r"step_(\d+)\.npz$")


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class CheckpointManager:
    """Numbered ``step_<n>.npz`` snapshots in ``directory``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.npz")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _STEP.fullmatch(f)))

    def save(self, step: int, state: dict) -> None:
        tmp = os.path.join(self.directory, f".step_{step}.tmp.npz")
        np.savez(tmp, **{k: _host(v) for k, v in state.items()})
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The state saved at ``step`` (default the latest) as numpy arrays,
        or None when nothing was saved."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        with np.load(self._path(step)) as data:
            return {k: data[k] for k in data.files}
