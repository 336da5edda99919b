"""Multi-device sharding: row-tiled rendering must equal single-device
output (SURVEY.md §4 "multi-node without a cluster")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxtracer.engine import pipeline
from voxtracer.engine.camera import Camera
from voxtracer.engine.params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
)
from voxtracer.ops import noise as noise_op
from voxtracer.parallel import make_mesh, sharded_render_frame
from voxtracer.parallel.mesh import scene_device_args
from voxtracer.scene import GridScene, default_scene


def _setup(height, width):
    scene = GridScene.from_voxels(default_scene(radius=10, seed=2))
    meta, arrays = scene_device_args(scene)
    cam = Camera(
        position=np.array([0.0, 2.0, -8.0]),
        direction=np.array([0.0, -0.3, 1.0]),
    )
    right, up, forward = cam.axis_scaled(width, height)
    cam_arr = jnp.asarray(
        np.stack([cam.position, right, up, forward]).astype(np.float32)
    )
    args = (
        arrays,
        cam_arr,
        RenderParams(),
        TemporalParams(),
        DenoiseParams(),
        jnp.asarray(noise_op.white_noise_buffer(seed=1, count=32)),
        jnp.int32(1),
    )
    return scene, meta, args


@pytest.mark.parametrize(
    "radius", [0, pytest.param(2, marks=pytest.mark.slow)]
)
def test_sharded_matches_single_device(radius):
    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should provide 8 virtual CPU devices"
    height, width = 32, 32
    scene, meta, args = _setup(height, width)

    single = pipeline.render_frame(
        pipeline.init_state(height, width),
        *args,
        scene_meta=meta,
        height=height,
        width=width,
        radius=radius,
        reproject=True,
    )

    mesh = make_mesh()
    fn, shard_state = sharded_render_frame(
        mesh,
        scene_meta=meta,
        height=height,
        width=width,
        radius=radius,
        reproject=True,
    )
    sharded = fn(shard_state(pipeline.init_state(height, width)), *args)

    for key in ("image", "linear", "depth", "node"):
        np.testing.assert_array_equal(
            np.asarray(single[1][key]),
            np.asarray(sharded[1][key]),
            err_msg=f"outputs[{key}] differs across sharding",
        )
    for key in ("accum_color", "accum_blend", "old_depth"):
        np.testing.assert_allclose(
            np.asarray(single[0][key]),
            np.asarray(sharded[0][key]),
            atol=1e-6,
            err_msg=f"state[{key}] differs across sharding",
        )


@pytest.mark.parametrize("radius", [0, 2])
def test_sharded_triton_matches_single_device(radius):
    """The Triton trace runs per row slab under shard_map (4 devices,
    interpreter on CPU) with the stencils sharded by annotation; two
    frames with camera motion, so frame 2's reprojection and denoise
    read rows held by other devices.  Must equal the single-device
    render."""
    devices = jax.devices()[:4]
    height, width = 16, 32
    scene, meta, args = _setup(height, width)
    arrays = args[0]
    cam_a = Camera(
        position=np.array([0.0, 2.0, -8.0]),
        direction=np.array([0.0, -0.3, 1.0]),
    )
    cam_b = Camera(
        position=np.array([0.15, 2.2, -8.1]),
        direction=np.array([0.02, -0.32, 1.0]),
    )

    def cam_arr(c):
        r, u, f = c.axis_scaled(width, height)
        return jnp.asarray(
            np.stack([c.position, r, u, f]).astype(np.float32)
        )

    state = pipeline.init_state(height, width)
    for i, c in enumerate((cam_a, cam_b)):
        state, single = pipeline.render_frame(
            state, arrays, cam_arr(c), *args[2:5], args[5],
            jnp.int32(i + 1), scene_meta=meta, height=height,
            width=width, radius=radius, reproject=i > 0,
            trace_impl="triton",
        )
    fns = {
        r: sharded_render_frame(
            make_mesh(devices), scene_meta=meta, height=height,
            width=width, radius=radius, reproject=r, trace_impl="triton",
        )
        for r in (False, True)
    }
    state = fns[False][1](pipeline.init_state(height, width))
    for i, c in enumerate((cam_a, cam_b)):
        state, sharded = fns[i > 0][0](
            state, arrays, cam_arr(c), *args[2:5], args[5],
            jnp.int32(i + 1),
        )
    for key in ("image", "depth", "node"):
        np.testing.assert_array_equal(
            np.asarray(single[key]),
            np.asarray(sharded[key]),
            err_msg=f"outputs[{key}] differs across triton sharding",
        )
    np.testing.assert_allclose(
        np.asarray(single["linear"]), np.asarray(sharded["linear"]),
        atol=1e-6,
    )
