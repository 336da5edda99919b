"""Temporal accumulation semantics (temporal.comp behaviour)."""

import jax.numpy as jnp
import numpy as np
import pytest

from voxtracer.engine.camera import Camera
from voxtracer.engine.params import TemporalParams
from voxtracer.ops.temporal import temporal_blend


def _cam_arrays(cam, w, h):
    r, u, f = cam.axis_scaled(w, h)
    return tuple(
        jnp.asarray(v, jnp.float32) for v in (cam.position, r, u, f)
    )


def _run(sampled, depth, old_color, old_blend, old_depth, cam, old_cam,
         params=None, valid=True, reproject=False, normal=None):
    h, w = depth.shape
    if normal is None:
        normal = np.tile(np.array([0, 0, -1], np.float32), (h, w, 1))
    out, nb = temporal_blend(
        jnp.asarray(sampled),
        jnp.asarray(normal),
        jnp.asarray(depth),
        jnp.asarray(old_color),
        jnp.asarray(old_blend),
        jnp.asarray(old_depth),
        cam,
        old_cam,
        params or TemporalParams(),
        jnp.asarray(valid),
        reproject=reproject,
    )
    return np.asarray(out), np.asarray(nb)


def test_first_frame_passthrough():
    """Invalid history -> output is the new sample, blending resets."""
    h = w = 8
    cam = _cam_arrays(Camera(), w, h)
    sampled = np.random.default_rng(0).random((h, w, 3)).astype(np.float32)
    depth = np.full((h, w), 5.0, np.float32)
    out, nb = _run(
        sampled, depth,
        np.zeros((h, w, 3), np.float32), np.ones((h, w), np.float32),
        depth, cam, cam, valid=False,
    )
    np.testing.assert_allclose(out, sampled)
    # next = clamp((1-0.5)*1, 0.02, 1) = 0.5
    np.testing.assert_allclose(nb, 0.5)


def test_static_accumulation_converges():
    """Repeated static frames blend toward the mean and the blending
    factor converges to 1 - maximum_blending (temporal.comp:121-124)."""
    h = w = 8
    cam = _cam_arrays(Camera(), w, h)
    params = TemporalParams()
    depth = np.full((h, w), 5.0, np.float32)
    color = np.full((h, w, 3), 0.25, np.float32)

    accum = np.zeros((h, w, 3), np.float32)
    blend = np.ones((h, w), np.float32)
    for frame in range(40):
        accum, blend = _run(
            color, depth, accum, blend, depth, cam, cam,
            params=params, valid=frame > 0,
        )
    np.testing.assert_allclose(accum, 0.25, atol=1e-5)
    np.testing.assert_allclose(blend, 1 - params.maximum_blending, atol=1e-6)


def test_miss_pixels_never_blend():
    h = w = 4
    cam = _cam_arrays(Camera(), w, h)
    sampled = np.full((h, w, 3), 0.7, np.float32)
    depth = np.full((h, w), -1.0, np.float32)  # all miss
    old = np.full((h, w, 3), 0.1, np.float32)
    out, _ = _run(
        sampled, depth, old, np.full((h, w), 0.02, np.float32), depth,
        cam, cam, valid=True,
    )
    np.testing.assert_allclose(out, 0.7)


def test_depth_change_invalidates_history():
    """A large depth jump fails the world-distance test, so the history
    sample is rejected (blending = 1)."""
    h = w = 4
    cam = _cam_arrays(Camera(), w, h)
    sampled = np.full((h, w, 3), 0.9, np.float32)
    depth = np.full((h, w), 5.0, np.float32)
    old_depth = np.full((h, w), 50.0, np.float32)  # far away before
    old = np.zeros((h, w, 3), np.float32)
    out, _ = _run(
        sampled, depth, old, np.full((h, w), 0.02, np.float32), old_depth,
        cam, cam, valid=True,
    )
    np.testing.assert_allclose(out, 0.9)


def test_reproject_identity_matches_static():
    """With identical cameras the full reprojection path reduces to the
    static fast path (up to bilinear float noise)."""
    h = w = 16
    cam = _cam_arrays(Camera(), w, h)
    rng = np.random.default_rng(1)
    sampled = rng.random((h, w, 3)).astype(np.float32)
    depth = (rng.random((h, w)).astype(np.float32) * 5 + 2)
    old = rng.random((h, w, 3)).astype(np.float32)
    ob = np.full((h, w), 0.3, np.float32)

    out_s, nb_s = _run(sampled, depth, old, ob, depth, cam, cam, valid=True,
                       reproject=False)
    out_r, nb_r = _run(sampled, depth, old, ob, depth, cam, cam, valid=True,
                       reproject=True)
    np.testing.assert_allclose(out_r, out_s, atol=2e-4)
    np.testing.assert_allclose(nb_r, nb_s, atol=2e-4)


def test_translation_reprojection_fetches_shifted_history():
    """Camera strafes right by one pixel's worth at depth d: the
    reprojected history lookup lands one pixel to the right."""
    h = w = 16
    cam_new = Camera(position=np.array([0.0, 0.0, 0.0]))
    # one pixel at depth z corresponds to world offset z / (h/2 / tan(fov/2))
    import math

    z = 10.0
    px_world = z / ((h / 2) / math.tan(cam_new.fov / 2))
    cam_old = Camera(position=np.array([-px_world, 0.0, 0.0]))

    new = _cam_arrays(cam_new, w, h)
    old = _cam_arrays(cam_old, w, h)

    # history has a distinctive column
    old_color = np.zeros((h, w, 3), np.float32)
    old_color[:, 6, :] = 1.0
    old_blend = np.full((h, w), 0.5, np.float32)
    depth = np.full((h, w), 0.0, np.float32)

    # depth of each pixel must place the hit at world z = 10 plane:
    # depth = z / cos(angle); compute per-pixel via the ray dirs
    r, u, f = cam_new.axis_scaled(w, h)
    px = np.arange(w)[None, :, None]
    py = np.arange(h)[:, None, None]
    ray = px * r + (-py) * u + f
    ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    depth = (z / ray[..., 2]).astype(np.float32)

    sampled = np.zeros((h, w, 3), np.float32)
    out, _ = _run(
        sampled, depth, old_color, old_blend, depth + 100.0, new, old,
        valid=True, reproject=True,
    )
    # old depth wrong -> rejected everywhere: sanity that rejection works
    np.testing.assert_allclose(out, 0.0)

    # correct old depth: old camera at -px_world sees the z=10 plane at
    # nearly the same depths; the column lights up shifted left by 1
    old_depth = depth  # close enough for the distance test at cutoff*depth
    out, _ = _run(
        sampled, depth, old_color, old_blend, old_depth, new, old,
        valid=True, reproject=True,
    )
    lit_cols = np.where(np.asarray(out)[8, :, 0] > 0.2)[0]
    assert len(lit_cols) >= 1
    assert abs(int(lit_cols.mean()) - 5) <= 1, f"lit cols {lit_cols}"


def _bilinear_np(img, x, y):
    """float64 clamp-to-edge bilinear sample at pixel-center coords."""
    h, w = img.shape[:2]
    xf, yf = x - 0.5, y - 0.5
    x0, y0 = np.floor(xf), np.floor(yf)
    tx, ty = (xf - x0)[..., None], (yf - y0)[..., None]

    def at(xi, yi):
        xi = np.clip(xi.astype(np.int64), 0, w - 1)
        yi = np.clip(yi.astype(np.int64), 0, h - 1)
        return img[yi, xi].astype(np.float64)

    top = at(x0, y0) * (1 - tx) + at(x0 + 1, y0) * tx
    bot = at(x0, y0 + 1) * (1 - tx) + at(x0 + 1, y0 + 1) * tx
    return top * (1 - ty) + bot * ty


@pytest.mark.parametrize(
    "dx,dy", [(2.3, -1.7), (40.6, -25.2), (200.5, 90.25), (-500.0, 3.5)]
)
def test_any_offset_resample_matches_numpy(dx, dy):
    """The 4-tap history resample is correct at any offset, however
    large (temporal.comp:92-114 accepts any in-frame offset); taps past
    the frame clamp to the edge."""
    import jax.numpy as jnp

    from voxtracer.ops.temporal import _bilinear

    h, w = 48, 160
    rng = np.random.default_rng(3)
    hist = rng.random((h, w, 5), dtype=np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    px_f = xx + 0.5 + dx + 0.01 * yy
    py_f = yy + 0.5 + dy + 0.005 * xx
    got = np.asarray(
        _bilinear(jnp.asarray(hist), jnp.asarray(px_f), jnp.asarray(py_f))
    )
    ref = _bilinear_np(hist, px_f.astype(np.float64), py_f.astype(np.float64))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_large_translation_keeps_history():
    """A 30-pixel strafe in one frame still finds its history: the lit
    history column reappears 30 pixels over instead of restarting
    accumulation."""
    import math

    h, w = 32, 96
    z = 10.0
    cam_new = Camera(position=np.array([0.0, 0.0, 0.0]))
    px_world = z / ((h / 2) / math.tan(cam_new.fov / 2))
    cam_old = Camera(position=np.array([-30.0 * px_world, 0.0, 0.0]))
    new = _cam_arrays(cam_new, w, h)
    old = _cam_arrays(cam_old, w, h)

    r, u, f = cam_new.axis_scaled(w, h)
    px = np.arange(w)[None, :, None]
    py = np.arange(h)[:, None, None]
    ray = px * r + (-py) * u + f
    ray = ray / np.linalg.norm(ray, axis=-1, keepdims=True)
    depth = (z / ray[..., 2]).astype(np.float32)

    old_color = np.zeros((h, w, 3), np.float32)
    old_color[:, 70, :] = 1.0
    old_blend = np.full((h, w), 0.5, np.float32)
    out, _ = _run(
        np.zeros((h, w, 3), np.float32), depth, old_color, old_blend,
        depth, new, old, valid=True, reproject=True,
    )
    lit_cols = np.where(np.asarray(out)[h // 2, :, 0] > 0.2)[0]
    assert len(lit_cols) >= 1
    assert abs(int(round(lit_cols.mean())) - 40) <= 1, f"lit {lit_cols}"


def test_still_planar_matches_channels_last_twin():
    """temporal_blend_still_planar (the frame's still-camera blend on
    the planar history) computes the same math as temporal_blend with
    reproject=False — same elementwise chain, planar broadcast axes."""
    import jax.numpy as jnp

    from voxtracer.engine.camera import Camera
    from voxtracer.engine.params import TemporalParams
    from voxtracer.ops import temporal as temporal_op

    h, w = 48, 96
    rng = np.random.default_rng(11)
    color = rng.random((h, w, 3), np.float32)
    n = rng.standard_normal((h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = (rng.random((h, w), np.float32) * 10 + 1).astype(np.float32)
    depth[0, :8] = -1.0  # miss pixels pass the sample through
    old_color = rng.random((h, w, 3), np.float32)
    old_blend = np.full((h, w), 0.5, np.float32)
    old_depth = depth + rng.normal(0, 1e-4, (h, w)).astype(np.float32)

    cam_o = Camera(position=np.array([0.0, 1.0, -8.0]))
    r_, u_, f_ = cam_o.axis_scaled(w, h)
    cam = tuple(
        jnp.asarray(v, jnp.float32) for v in (cam_o.position, r_, u_, f_)
    )
    params = TemporalParams()

    ref, ref_nb = temporal_op.temporal_blend(
        jnp.asarray(color), jnp.asarray(n), jnp.asarray(depth),
        jnp.asarray(old_color), jnp.asarray(old_blend),
        jnp.asarray(old_depth), cam, cam, params, jnp.asarray(True),
        reproject=False,
    )
    got, got_nb = temporal_op.temporal_blend_still_planar(
        jnp.moveaxis(jnp.asarray(color), -1, 0),
        jnp.moveaxis(jnp.asarray(n), -1, 0),
        jnp.asarray(depth),
        jnp.moveaxis(jnp.asarray(old_color), -1, 0),
        jnp.asarray(old_blend), jnp.asarray(old_depth),
        cam, cam, params, jnp.asarray(True),
    )
    np.testing.assert_allclose(
        np.moveaxis(np.asarray(got), 0, -1), np.asarray(ref),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(got_nb), np.asarray(ref_nb), rtol=1e-6, atol=1e-7
    )
