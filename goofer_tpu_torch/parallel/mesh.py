"""Device meshes.

Port of goofer_tpu/parallel/mesh.py.  goofer_tpu's mesh is a
``jax.sharding.Mesh``: one controller issues every device's work, and
the note batch rides the 'dp' axis while the mel-knot decode's
contraction axis rides 'tp'.  Here the mesh is a plain (dp, tp) array of
``torch.device`` with the same axis names and sizes, and the single
controller is this process: devices.py's ``run_on_slots`` issues each
slot's share (rows cut by ``shard_bounds``), one worker per distinct
device, for parallel/batch.py, the phrase renderer and the batched
extraction.  ``torch.distributed``'s ``DeviceMesh`` needs a process
group with one process per device, which no caller here has.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, tp) array of ``torch.device`` named by ``axis_names``.  A
    device may appear in several slots (the tests' CPU meshes, a smoke
    run's repeated card)."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name to size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def slots(self) -> list:
        """Every slot's device, row-major: dp row by dp row, each row's tp
        members in order."""
        return list(self.devices.flat)


def make_mesh(n_devices: int | None = None, axis_names=("dp", "tp"),
              tp: int = 1, devices=None) -> Mesh:
    """A ('dp', 'tp') mesh with dp = n // tp over the first ``n_devices``
    (default: all) of ``devices``.  ``devices`` None takes the machine's
    CUDA cards and raises where there is none, or fewer than asked: a
    mesh of the CPU, or one that names a device several times, exists
    only where the caller lists its devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices= to build a mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise RuntimeError(f"make_mesh: {n} devices asked for, "
                           f"{len(devices)} available")
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n // tp, tp), tuple(axis_names))
