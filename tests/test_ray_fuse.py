"""Per-ray step-fuse semantics of the Triton trace kernel.

The reference gives every ray its own 2048-iteration safety fuse
(``voxels.comp:166-169``): a runaway ray becomes an opaque black leaf at
its current cell.  The kernel marches a whole pixel tile in one loop
that runs until every lane is done, so the fuse has to count each ray's
own steps: a runaway ray must not cut its tile-mates short, and a fused
ray must report the cell it reached, exactly as the XLA twin does.

The corridor scene forces long marches: two occupied walls with an
empty corridor between, so central rays march cell by cell down its
length while steep rays hit a wall within a few steps, in the same
tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxtracer.engine.camera import Camera
from voxtracer.engine.params import RenderParams
from voxtracer.ops import noise as noise_op
from voxtracer.ops import trace_triton, trace_xla
from voxtracer.scene import GridScene, VoxelList

LEAF_BIT = int(trace_xla.LEAF_BIT)


def _corridor_scene(length=128, width=16):
    """Two occupied walls (y=0, y=5) with an empty corridor between,
    ending in a far wall."""
    xs, zs = np.meshgrid(
        np.arange(width, dtype=np.int16),
        np.arange(length, dtype=np.int16),
        indexing="ij",
    )
    pos = [
        np.stack(
            [xs.ravel(), np.full(xs.size, y, np.int16), zs.ravel()], axis=1
        )
        for y in (0, 5)
    ]
    fx, fy = np.meshgrid(
        np.arange(width, dtype=np.int16),
        np.arange(6, dtype=np.int16),
        indexing="ij",
    )
    pos.append(
        np.stack(
            [fx.ravel(), fy.ravel(), np.full(fx.size, length - 1, np.int16)],
            axis=1,
        )
    )
    pos = np.concatenate(pos, axis=0)
    mrgb = np.zeros((len(pos), 4), np.uint8)
    mrgb[:, 1:] = (150, 150, 150)
    return GridScene.from_voxels(VoxelList(pos=pos, mrgb=mrgb))


def _render(scene, h, w, impl, max_iterations):
    cam = Camera(
        position=np.array([4.0, 1.5, 1.0]),
        direction=np.array([0.0, 0.0, 1.0]),
    )
    params = RenderParams()
    right, up, forward = cam.axis_scaled(w, h)
    cam_arr = np.stack([cam.position, right, up, forward]).astype(np.float32)
    buf = noise_op.white_noise_buffer(seed=3, count=32)
    grid = jnp.asarray(scene.values.reshape(-1))
    if impl == "triton":
        out = trace_triton.render_sample(
            grid, scene.values.shape, tuple(int(v) for v in scene.origin),
            jnp.asarray(cam_arr), params, jnp.asarray(buf), jnp.int32(1),
            h, w, interpret=True, max_iterations=max_iterations,
        )
    else:
        fn = jax.jit(
            trace_xla.render_sample,
            static_argnames=("dims", "height", "width", "max_iterations"),
        )
        out = fn(
            grid, scene.values.shape,
            jnp.asarray(scene.origin.astype(np.int32)),
            *(jnp.asarray(v) for v in cam_arr), params,
            jnp.asarray(noise_op.noise_planes(buf, 1, h, w)),
            height=h, width=w, max_iterations=max_iterations,
        )
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("cap", [8, 40])
def test_fuse_matches_xla_per_ray(cap):
    """Under a low cap the kernel fuses exactly the rays the XLA twin
    fuses, at the same cells, and its steep rays still resolve."""
    scene = _corridor_scene()
    h, w = 12, 20
    base = _render(scene, h, w, "triton", trace_xla.MAX_ITERATIONS)
    assert not (base["node"] == LEAF_BIT).any(), (
        "scene must resolve fully at the default per-ray cap"
    )
    got = _render(scene, h, w, "triton", cap)
    ref = _render(scene, h, w, "xla", cap)
    np.testing.assert_array_equal(got["node"], ref["node"])
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-5,
                               atol=1e-5)

    # a cap may only replace a result with an EARLIER opaque-black fuse,
    # never with a miss or a different hit
    fused = got["node"] == LEAF_BIT
    same = got["node"] == base["node"]
    assert (fused | same).all()
    assert fused[got["depth"] >= 0].any(), "cap must bite somewhere"
    assert (same & ~fused).sum() > 20, "steep rays must still resolve"
    hit = fused & (base["depth"] >= 0)
    assert (got["depth"][hit] <= base["depth"][hit] + 1e-4).all()
