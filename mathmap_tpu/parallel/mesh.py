"""Device-mesh construction for multi-chip rendering.

Reference parallelism: the render engine splits the output image into
horizontal row slices, one thread each (`mathmap_slice_t`, SURVEY.md §2.2 DP
row [unverified — mount empty, SURVEY.md §0]). The equivalent here: shard
the pixel grid (and the animation frame batch) over a `jax.sharding.Mesh`;
XLA inserts the collectives (NCCL between GPUs). The mesh shape follows the
algorithm, not a topology: the cards of one host reach each other at the
same rate (NVLink, all to all). Axis names:

    "f" — frame batch (pure data parallelism over animation frames)
    "y" — grid rows   (the row-slice analog; sequence-parallel shaped)
    "x" — grid cols   (optional, for very wide canvases)
"""

from __future__ import annotations

import numpy as np

FRAME_AXIS = "f"
ROW_AXIS = "y"
COL_AXIS = "x"


def make_mesh(frames: int = 1, rows: int | None = None, cols: int = 1, devices=None):
    """Build a (frames, rows, cols) mesh. `rows=None` uses all remaining
    devices on the row axis."""
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if rows is None:
        if n % (frames * cols):
            raise ValueError(f"{n} devices not divisible by frames*cols={frames * cols}")
        rows = n // (frames * cols)
    if frames * rows * cols != n:
        raise ValueError(f"mesh {frames}x{rows}x{cols} != {n} devices")
    arr = np.array(devices).reshape(frames, rows, cols)
    return Mesh(arr, (FRAME_AXIS, ROW_AXIS, COL_AXIS))


def axis_size(mesh, name: str) -> int:
    return mesh.shape.get(name, 1)
