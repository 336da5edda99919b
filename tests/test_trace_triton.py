"""The Triton trace kernel (run through the Pallas interpreter) against
the XLA trace and the NumPy oracle.

The kernel must reproduce the XLA twin's G-buffer: primary-hit geometry
exactly, shading to float tolerance.  Image sizes are deliberately not
multiples of the kernel's pixel tile, so the masked edge tiles (padding
and crop) are exercised in every case.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import vox_dir
from voxtracer.app import camera_paths
from voxtracer.engine.camera import Camera
from voxtracer.engine.params import RenderParams
from voxtracer.io import vox as voxio
from voxtracer.ops import noise as noise_op
from voxtracer.ops import trace_triton, trace_xla
from voxtracer.oracle import renderer as oracle
from voxtracer.scene import GridScene, VoxelList, voxels_from_vox


def _single_voxel():
    vl = VoxelList(
        pos=np.array([[0, 0, 0]], dtype=np.int16),
        mrgb=np.array([[0, 200, 100, 50]], dtype=np.uint8),
    )
    return (
        GridScene.from_voxels(vl),
        Camera(position=np.array([0.3, 0.2, -1.5])),
    )


def _asset(name, pos=None, direction=None):
    scene = GridScene.from_voxels(
        voxels_from_vox(voxio.load(os.path.join(vox_dir(), name + ".vox")))
    )
    if pos is None:
        return scene, camera_paths.static(scene)(0.0)
    return scene, Camera(position=np.array(pos), direction=np.array(direction))


SCENES = {
    "single_voxel": _single_voxel,
    "3x3x3": lambda: _asset("3x3x3"),
    "8x8x8": lambda: _asset("8x8x8", (2.0, 3.0, -4.0), (0.2, 0.1, 1.0)),
    "chr_knight": lambda: _asset(
        "chr_knight", (10.0, 8.0, -10.0), (0.0, -0.2, 1.0)
    ),
}


def _cam_arr(cam, h, w):
    right, up, forward = cam.axis_scaled(w, h)
    return np.stack([cam.position, right, up, forward]).astype(np.float32)


def _render_xla(scene, cam_arr, params, buf, frame, h, w, **kw):
    planes = noise_op.noise_planes(buf, frame, h, w)
    fn = jax.jit(
        trace_xla.render_sample,
        static_argnames=("dims", "height", "width", "max_bounces",
                         "max_iterations"),
    )
    out = fn(
        jnp.asarray(scene.values.reshape(-1)), scene.values.shape,
        jnp.asarray(scene.origin.astype(np.int32)),
        *(jnp.asarray(v) for v in cam_arr), params, jnp.asarray(planes),
        height=h, width=w, **kw,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _render_triton(scene, cam_arr, params, buf, frame, h, w, **kw):
    out = trace_triton.render_sample(
        jnp.asarray(scene.values.reshape(-1)), scene.values.shape,
        tuple(int(v) for v in scene.origin), jnp.asarray(cam_arr), params,
        jnp.asarray(buf), jnp.int32(frame), h, w, interpret=True, **kw,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_gbuf_match(ref, got, max_color_px=0):
    """Same hits (node, depth, normal, albedo) and shading within float
    noise; ``max_color_px`` pins the pixels allowed past 1e-3 (a
    secondary ray flipping on a grazing float difference)."""
    for k in ("color", "normal", "depth", "albedo", "node"):
        assert ref[k].shape == got[k].shape, k
    np.testing.assert_array_equal(got["node"], ref["node"])
    np.testing.assert_allclose(got["depth"], ref["depth"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["normal"], ref["normal"])
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=1e-6)
    err = np.abs(got["color"] - ref["color"]).max(axis=-1)
    assert int((err > 1e-3).sum()) <= max_color_px, err.max()


@pytest.mark.parametrize("specularity", [0.0, 0.4])
@pytest.mark.parametrize("scene_name", sorted(SCENES))
def test_triton_matches_xla(scene_name, specularity):
    scene, cam = SCENES[scene_name]()
    h, w = 13, 21
    params = RenderParams(specularity=specularity)
    buf = noise_op.white_noise_buffer(seed=7, count=32)
    cam_arr = _cam_arr(cam, h, w)
    ref = _render_xla(scene, cam_arr, params, buf, 3, h, w)
    got = _render_triton(scene, cam_arr, params, buf, 3, h, w)
    _assert_gbuf_match(ref, got)


@pytest.mark.parametrize("bounces", [1, 2])
def test_triton_matches_xla_bounce_counts(bounces):
    scene, cam = SCENES["8x8x8"]()
    h, w = 18, 20
    params = RenderParams()
    buf = noise_op.white_noise_buffer(seed=5, count=32)
    cam_arr = _cam_arr(cam, h, w)
    ref = _render_xla(scene, cam_arr, params, buf, 1, h, w,
                      max_bounces=bounces)
    got = _render_triton(scene, cam_arr, params, buf, 1, h, w,
                         max_bounces=bounces)
    _assert_gbuf_match(ref, got)


@pytest.mark.parametrize("scene_name,size", [
    ("single_voxel", 16), ("8x8x8", 32),
])
def test_triton_matches_oracle(scene_name, size):
    """The on-card gate of BASELINE config 1, here through the
    interpreter: node agreement >= 0.999, depth within 1e-5 on agreeing
    hits, color |err| < 1e-3 on >= 99.5% of agreeing pixels."""
    scene, cam = SCENES[scene_name]()
    params = RenderParams()
    buf = noise_op.white_noise_buffer(seed=7, count=32)
    right, up, forward = cam.axis_scaled(size, size)
    o = oracle.render_sample(
        scene.values, scene.origin.astype(np.int64),
        np.asarray(cam.position, np.float64), right, up, forward,
        params, noise_op.noise_planes(buf, 1, size, size), size, size,
    )
    x = _render_triton(scene, _cam_arr(cam, size, size), params, buf, 1,
                       size, size)
    agree = o["node"] == x["node"]
    assert agree.mean() >= 0.999, agree.mean()
    hit = (o["depth"] >= 0) & agree
    np.testing.assert_allclose(x["depth"][hit], o["depth"][hit],
                               rtol=1e-5, atol=1e-5)
    err = np.abs(x["color"] - o["color"]).max(axis=-1)
    assert (err[agree] < 1e-3).mean() >= 0.995


def test_row_offset_renders_the_matching_slab():
    """A slab traced with ``row0`` (how each device traces its rows
    under shard_map) equals those rows of the whole image: ray
    generation and noise follow the global row."""
    scene, cam = SCENES["3x3x3"]()
    h, w = 24, 20
    params = RenderParams()
    buf = noise_op.white_noise_buffer(seed=2, count=32)
    cam_arr = _cam_arr(cam, h, w)
    full = _render_triton(scene, cam_arr, params, buf, 2, h, w)
    slab = trace_triton.render_sample(
        jnp.asarray(scene.values.reshape(-1)), scene.values.shape,
        tuple(int(v) for v in scene.origin), jnp.asarray(cam_arr), params,
        jnp.asarray(buf), jnp.int32(2), 10, w, row0=9, interpret=True,
    )
    for k, v in slab.items():
        np.testing.assert_array_equal(np.asarray(v), full[k][9:19], k)
