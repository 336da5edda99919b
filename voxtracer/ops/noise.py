"""Per-frame random-number planes.

The reference streams blue noise from a 128x128x512 f32 buffer; each
``rand()`` advances one whole 128x128 slice while the in-slice offset
stays pinned to ``(x % 128, y % 128)`` (``voxels.comp:65-71, 268-275``).
Because the slice index depends only on (frame, call-number) and the
offset only on the pixel, a frame's entire randomness is expressible as
``count`` dense planes — ``plane[k][y, x] =
buffer[(frame + 1 + k) % 512, y % 128, x % 128]``: pure dynamic-slice +
tile broadcasts, no gathers anywhere in the RNG.  The GPU trace kernel
reads the same values straight from the buffer.

``count`` defaults to the engine's fixed consumption schedule
(8 slots x 3 bounces, see ``voxtracer.oracle.renderer``).
"""

from __future__ import annotations

import numpy as np

SLICE = 128
SLICE_COUNT = 512
PLANES_PER_FRAME = 24  # RANDS_PER_BOUNCE * MAX_BOUNCES


def white_noise_buffer(
    seed: int = 0, count: int = SLICE_COUNT, size: int = SLICE
) -> np.ndarray:
    """Uniform-random stand-in for the blue-noise asset; same shape/dtype."""
    rng = np.random.default_rng(seed)
    return rng.random((count, size, size), dtype=np.float32)


def noise_planes(
    buffer,  # (SLICE_COUNT, SLICE, SLICE) float32, np or jnp
    frame: int,
    height: int,
    width: int,
    count: int = PLANES_PER_FRAME,
    xp=np,
):
    """Materialize the frame's rand() planes -> (count, height, width)."""
    n_slices, sh, sw = buffer.shape
    reps_y = -(-height // sh)
    reps_x = -(-width // sw)
    planes = []
    for k in range(count):
        s = (frame + 1 + k) % n_slices
        tile = xp.tile(buffer[s], (reps_y, reps_x))[:height, :width]
        planes.append(tile)
    return xp.stack(planes)
