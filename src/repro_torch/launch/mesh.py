"""Mesh definitions: JAX's production layouts, and the cards at hand.

The counterpart of ``repro.launch.mesh``.  A ``Mesh`` here is a named grid
of devices used for accounting: the dry-run (``launch.dryrun``) reads
per-device shapes off it through ``models.sharding.local_shape``.  The
port runs in one process, so nothing is placed on a mesh.  Importing this
module touches no device; ``make_local_mesh`` reads the card count when it
is called.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices (JAX's ``mesh.devices.size``)."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production layouts as accounting meshes: 16x16 = 256 devices
    a pod, ``("data", "model")``; ``multi_pod`` adds the 2-pod axis (512,
    ``("pod", "data", "model")``).  No cards stand behind them: the
    dry-run divides a traced cell over them and reads per-device shapes
    off their specs."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(n_devices: int | None = None, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over ``n_devices``, by default the cards
    ``torch.cuda.device_count()`` finds (raises when there is none and no
    ``n_devices`` is given)."""
    if n_devices is None:
        import torch

        n_devices = torch.cuda.device_count()
        if n_devices == 0:
            raise RuntimeError("no CUDA card: pass n_devices for a mesh without one")
    return Mesh(("data", "model"), (n_devices // model, model))
