"""Device mesh helpers.

The reference is a single-process single-GPU library (SURVEY.md §2); this
layer is the scaling story: device meshes with named axes for batch
fan-out ("batch") and spatial row-sharding ("y").  Every device reaches
every other at the same rate, so the mesh follows the algorithm alone."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

BATCH_AXIS = "batch"
SPATIAL_AXIS = "y"


def make_mesh(batch: int | None = None, spatial: int = 1,
              devices=None) -> Mesh:
    """(batch × spatial) mesh over the available devices.

    batch=None uses all remaining devices on the batch axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if batch is None:
        if n % spatial != 0:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        batch = n // spatial
    if batch * spatial > n:
        raise ValueError(f"mesh {batch}x{spatial} needs {batch * spatial} "
                         f"devices, have {n}")
    grid = np.array(devices[: batch * spatial]).reshape(batch, spatial)
    return Mesh(grid, (BATCH_AXIS, SPATIAL_AXIS))


def single_device_mesh() -> Mesh:
    return make_mesh(batch=1, spatial=1)
