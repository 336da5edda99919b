"""Dense voxel grid + occupancy mip pyramid: the trace kernels' scene.

The reference traverses a pointer-chasing sparse octree on the GPU
(``shaders/voxels.comp:134-247``).  Both trace paths here march a
dense int32 value grid over the scene's bounding box instead (0 =
empty, negative = packed leaf value — same encoding,
``src/context.rs:734``), which visits exactly the cells the octree
walk visits, so hits agree.  A pyramid of boolean occupancy mips (level
``l`` cell = ``2**l`` base cells) is kept beside it for hierarchical
empty-space skipping.

World mapping (must match the octree ABI): ``create_octree`` writes
``root_size = 2**depth`` and the traversal descends one level per
positive child until it finds a negative leaf (``voxels.comp:175-189``,
``src/context.rs:710-773``).  Working through both, an integer voxel at
position ``p`` occupies the world cube ``[p*0.5, p*0.5 + 0.5)`` — the
leaf cells of the octree sit one level *below* the integer lattice, so a
voxel is half a world unit across.  The grid stores that mapping as
``world = (index + origin) * CELL_SIZE``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .voxels import VoxelList, pack_leaves

CELL_SIZE = 0.5  # world size of one voxel

# Scenes with more distinct leaf values than this (the random-colored
# procedural bowl) have their colors quantized at build time, so the
# oracle and both trace paths all see the identical quantized scene.
MAX_EXACT_LEAVES = 992


def _ceil_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class GridScene:
    """Device-friendly scene: dense values plus occupancy mips.

    Attributes:
      values: int32 [X, Y, Z]; 0 = empty, negative = packed leaf.
      origin: int32 [3] — voxel-lattice coordinate of grid index (0,0,0).
      shape:  padded grid dims (multiples of ``pad``).
      mips:   occupancy bools, mips[0] is full resolution, each following
              level halves every axis (shape padded up).
    """

    values: np.ndarray
    origin: np.ndarray
    mips: List[np.ndarray]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.values.shape

    def world_min(self) -> np.ndarray:
        return self.origin.astype(np.float32) * CELL_SIZE

    def world_max(self) -> np.ndarray:
        return (self.origin + np.array(self.values.shape)).astype(
            np.float32
        ) * CELL_SIZE

    @staticmethod
    def from_voxels(
        voxels: VoxelList, pad: int = 8, num_mips: int = 6
    ) -> "GridScene":
        if len(voxels) == 0:
            values = np.zeros((pad, pad, pad), dtype=np.int32)
            origin = np.zeros(3, dtype=np.int32)
        else:
            pos = voxels.pos.astype(np.int64)
            lo = pos.min(axis=0)
            hi = pos.max(axis=0)
            dims = [
                _ceil_multiple(int(h - l) + 1, pad) for l, h in zip(lo, hi)
            ]
            leaves = _quantize_leaves(pack_leaves(voxels.mrgb))
            origin = lo.astype(np.int32)
            # Later duplicates win, like repeated octree insertion
            # overwriting the same leaf slot.  The native (C++) fill is
            # used when built; the numpy path is bit-identical.
            from .. import native

            values = native.fill_grid(voxels.pos, leaves, origin, dims)
            if values is None:
                values = np.zeros(dims, dtype=np.int32)
                idx = pos - lo
                values[idx[:, 0], idx[:, 1], idx[:, 2]] = leaves

        mips = _build_mips(values != 0, num_mips)
        return GridScene(values=values, origin=origin, mips=mips)


def _quantize_leaves(leaves: np.ndarray) -> np.ndarray:
    """Map leaf values into at most MAX_EXACT_LEAVES distinct values.

    Lossless whenever the scene already has fewer distinct leaves
    (every .vox scene: <= 512).  Beyond that (the random-colored
    procedural bowl), colors snap to the centers of an 8x8x7 RGB cube
    per material byte — a bounded, unbiased quantization (a hash-bucket
    scheme would bias each bucket toward its representative's hue).
    """
    uniq = np.unique(leaves)
    if len(uniq) < MAX_EXACT_LEAVES:
        return leaves
    v = leaves.astype(np.int64)
    mat = (v >> 24) & 0x7F
    r = (v >> 16) & 0xFF
    g = (v >> 8) & 0xFF
    b = v & 0xFF
    # 8 x 8 x 7 level centers per material (<= 2 material bytes in
    # practice: diffuse / emissive), 896 < MAX_EXACT_LEAVES
    rq = (r >> 5) * 32 + 16
    gq = (g >> 5) * 32 + 16
    bq = (2 * np.minimum(b * 7 // 256, 6) + 1) * 256 // 14
    out = (1 << 31) | (mat << 24) | (rq << 16) | (gq << 8) | bq
    return (out - (1 << 32)).astype(np.int32)


def _build_mips(occ0: np.ndarray, num_mips: int) -> List[np.ndarray]:
    mips = [occ0]
    cur = occ0
    for _ in range(1, num_mips):
        if max(cur.shape) <= 1:
            break
        dims = [_ceil_multiple(s, 2) for s in cur.shape]
        if dims != list(cur.shape):
            padded = np.zeros(dims, dtype=bool)
            padded[: cur.shape[0], : cur.shape[1], : cur.shape[2]] = cur
            cur = padded
        cur = (
            cur.reshape(
                dims[0] // 2, 2, dims[1] // 2, 2, dims[2] // 2, 2
            ).any(axis=(1, 3, 5))
        )
        mips.append(cur)
    return mips
