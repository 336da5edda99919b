"""Native (C++) scene-build kernels must be bit-identical to numpy."""

import unittest.mock as mock

import numpy as np
import pytest

from voxtracer import native
from voxtracer.scene import GridScene, VoxelList, default_scene
from voxtracer.scene.grid import _quantize_leaves
from voxtracer.scene.voxels import pack_leaves


@pytest.fixture(scope="module")
def lib():
    lib = native.get()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def test_fill_grid_matches_numpy(lib):
    vl = default_scene(radius=14, seed=4)
    leaves = _quantize_leaves(pack_leaves(vl.mrgb))
    pos = vl.pos.astype(np.int64)
    lo = pos.min(axis=0)
    dims = tuple(int(-(-(int(h - l) + 1) // 8) * 8) for l, h in zip(lo, pos.max(axis=0)))
    ref = np.zeros(dims, np.int32)
    idx = pos - lo
    ref[idx[:, 0], idx[:, 1], idx[:, 2]] = leaves
    got = native.fill_grid(vl.pos, leaves, lo, dims)
    np.testing.assert_array_equal(got, ref)


def test_fill_grid_later_duplicates_win(lib):
    """Repeated positions keep the LAST leaf, like repeated octree
    insertion; the native fill and the numpy fill agree."""
    pos = np.array([[0, 0, 0], [1, 2, 3], [0, 0, 0], [1, 2, 3]], np.int16)
    leaves = np.array([-5, -6, -7, -8], np.int32)
    dims = (8, 8, 8)
    got = native.fill_grid(pos, leaves, np.zeros(3, np.int32), dims)
    assert got[0, 0, 0] == -7 and got[1, 2, 3] == -8
    assert (got != 0).sum() == 2
    with mock.patch.object(native, "fill_grid", return_value=None):
        ref = GridScene.from_voxels(
            VoxelList(pos=pos, mrgb=np.zeros((4, 4), np.uint8))
        ).values
    nat = GridScene.from_voxels(
        VoxelList(pos=pos, mrgb=np.zeros((4, 4), np.uint8))
    ).values
    np.testing.assert_array_equal(nat, ref)


def test_quantized_scene_fits_distinct_leaf_budget():
    """More distinct colors than the exact budget are quantized into it."""
    from voxtracer.scene import grid

    rng = np.random.default_rng(0)
    mrgb = np.concatenate(
        [np.zeros((4000, 1), np.uint8),
         rng.integers(0, 256, (4000, 3)).astype(np.uint8)], axis=1
    )
    q = _quantize_leaves(pack_leaves(mrgb))
    assert len(np.unique(q)) < grid.MAX_EXACT_LEAVES
    assert (q < 0).all()
    small = pack_leaves(mrgb[:100])
    np.testing.assert_array_equal(_quantize_leaves(small), small)


def test_decode_xyzi(lib):
    raw = np.array([[1, 2, 3, 9], [250, 0, 7, 255]], np.uint8)
    pos, ci = native.decode_xyzi(raw)
    np.testing.assert_array_equal(pos, [[1, 3, 2], [250, 7, 0]])
    np.testing.assert_array_equal(ci, [9, 255])
