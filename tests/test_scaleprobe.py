"""The scale probe's synthetic shell must be a well-formed scene:
quantized leaves, correct origin, and renderable end-to-end (its
invariants are pinned here at a small size)."""

import numpy as np
import pytest

from voxtracer.app.scaleprobe import synthetic_shell
from voxtracer.engine.camera import Camera
from voxtracer.engine.pipeline import Renderer


def test_synthetic_shell_invariants():
    s = synthetic_shell(48)
    assert s.values.shape == (48, 48, 48)
    assert tuple(s.origin) == (-23, -23, -23)
    occ = s.values != 0
    # a shell: occupied, but far from solid (the fixed 6-voxel wall is
    # relatively thick at this small test size)
    assert 0.01 < occ.mean() < 0.4
    leaves = s.values[occ]
    # every leaf has bit31 set (packed-leaf convention) and the colors
    # fit the quantizer's distinct-leaf budget
    assert (leaves < 0).all()
    from voxtracer.scene import grid

    assert len(np.unique(leaves)) < grid.MAX_EXACT_LEAVES
    # deterministic: same seed, same scene
    s2 = synthetic_shell(48)
    np.testing.assert_array_equal(s.values, s2.values)


@pytest.mark.slow
def test_synthetic_shell_renders():
    s = synthetic_shell(48)
    cam = Camera(
        position=np.array([48 * 0.75, 48 * 0.55, -48 * 0.7]),
        direction=np.array([-0.6, -0.45, 1.0]),
    )
    r = Renderer(scene=s, height=32, width=64, lean=True,
                 trace_impl="xla")
    out = r.render(cam)
    depth = np.asarray(out["depth"])
    # the shell fills part of the view: some hits, some misses
    assert np.isfinite(depth).all()
    assert (depth > 0).any()
