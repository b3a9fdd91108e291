"""Device mesh of the port, in its one-process form (port of
``ransac_tpu.parallel.mesh``).

The JAX package names its parallelism through a ``jax.sharding.Mesh``
with a ``data`` axis (candidate cameras, keyframes, observations) and a
``model`` axis (hypothesis, map or camera blocks).  The port's multi-device
form, over ``torch.distributed``, is not written yet (ROADMAP queue 1,
item 5): here a mesh describes one device, shape ``{"data": 1, "model":
1}``, and asking for more raises rather than quietly running on one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

#: What a request for more than one device is told.
MULTI_DEVICE = ("the port's mesh is one device until parallel/ is ported onto "
                "torch.distributed (ROADMAP queue 1, item 5)")


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh over ``devices`` (one, for now)."""
    devices: tuple
    shape: dict = field(default_factory=lambda: {"data": 1, "model": 1})

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def _device_count(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.device_count() if device.index is None else 1
    return 1


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, device="cuda") -> Mesh:
    """A (data, model) mesh of ``n_devices`` devices of ``device``'s kind
    (None: all of them, as the JAX function takes ``jax.devices()``).  The
    one-process form takes exactly one device: any other count, or a
    ``data`` / ``model`` split over more than one, raises ``ValueError``."""
    device = torch.device(device)
    n = _device_count(device) if n_devices is None else int(n_devices)
    want = n if data is None or model is None else int(data) * int(model)
    if n != 1 or want != 1:
        raise ValueError(f"make_mesh(n_devices={n_devices}, data={data}, model={model}) "
                         f"asks for {max(n, want)} devices: {MULTI_DEVICE}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return Mesh(devices=(device,))
