"""Cross-bilateral denoiser semantics (denoise.comp behaviour)."""

import jax.numpy as jnp
import numpy as np
import pytest

from voxtracer.engine.camera import Camera
from voxtracer.engine.params import DenoiseParams
from voxtracer.ops.denoise import denoise


def _cam_arrays(cam, w, h):
    r, u, f = cam.axis_scaled(w, h)
    return tuple(
        jnp.asarray(v, jnp.float32) for v in (cam.position, r, u, f)
    )


def _run(colors, radius, params=None, normal=None, depth=None, albedo=None,
         material=None):
    h, w = colors.shape[:2]
    cam = _cam_arrays(Camera(), w, h)
    if normal is None:
        normal = np.tile(np.array([0, 0, -1], np.float32), (h, w, 1))
    if depth is None:
        depth = np.full((h, w), 5.0, np.float32)
    if albedo is None:
        albedo = np.ones((h, w, 3), np.float32)
    if material is None:
        material = np.zeros((h, w), np.int32)
    return np.asarray(
        denoise(
            jnp.asarray(colors),
            jnp.asarray(normal),
            jnp.asarray(depth),
            jnp.asarray(albedo),
            jnp.asarray(material),
            cam,
            params or DenoiseParams(),
            radius=radius,
        )
    )


def test_radius0_is_albedo_modulation_only():
    rng = np.random.default_rng(0)
    h = w = 8
    colors = rng.random((h, w, 3)).astype(np.float32)
    albedo = rng.random((h, w, 3)).astype(np.float32)
    out = _run(colors, 0, albedo=albedo)
    np.testing.assert_allclose(out, albedo * colors, rtol=1e-6)
    # albedo_factor 0 -> raw color
    out = _run(colors, 0, params=DenoiseParams(albedo_factor=0.0),
               albedo=albedo)
    np.testing.assert_allclose(out, colors, rtol=1e-6)


def test_uniform_image_is_fixed_point():
    h = w = 8
    colors = np.full((h, w, 3), 0.4, np.float32)
    out = _run(colors, 3)
    np.testing.assert_allclose(out, 0.4, atol=1e-6)


def test_smoothing_reduces_noise_variance():
    rng = np.random.default_rng(1)
    h = w = 16
    colors = (0.5 + 0.2 * rng.standard_normal((h, w, 3))).astype(np.float32)
    out = _run(colors, 4, params=DenoiseParams(sigma_range=100.0))
    inner = (slice(4, -4), slice(4, -4))
    assert out[inner].std() < 0.3 * colors[inner].std()
    # energy approximately preserved
    assert abs(out[inner].mean() - colors[inner].mean()) < 0.02


def test_normal_edge_stops_blending():
    """Two halves with opposing normals must not bleed into each other."""
    h = w = 16
    colors = np.zeros((h, w, 3), np.float32)
    colors[:, : w // 2] = 1.0
    normal = np.tile(np.array([0, 0, -1], np.float32), (h, w, 1))
    normal[:, w // 2 :] = [1, 0, 0]
    out = _run(colors, 3, normal=normal)
    np.testing.assert_allclose(out[:, : w // 2 - 1], 1.0, atol=1e-3)
    np.testing.assert_allclose(out[:, w // 2 + 1 :], 0.0, atol=1e-3)


def test_material_edge_stops_blending():
    h = w = 16
    colors = np.zeros((h, w, 3), np.float32)
    colors[:, : w // 2] = 1.0
    material = np.zeros((h, w), np.int32)
    material[:, w // 2 :] = 1 << 24  # differing top-8 material bits
    out = _run(colors, 3, material=material)
    np.testing.assert_allclose(out[:, : w // 2 - 1], 1.0, atol=1e-2)
    np.testing.assert_allclose(out[:, w // 2 + 1 :], 0.0, atol=1e-2)


def test_border_taps_excluded():
    """Pixels at the frame edge only average in-bounds taps (the
    reference skips out-of-range window cells, denoise.comp:57)."""
    h = w = 8
    colors = np.full((h, w, 3), 0.8, np.float32)
    out = _run(colors, 4, params=DenoiseParams(sigma_range=100.0))
    # with zero-padding leakage the corners would darken; they must not
    np.testing.assert_allclose(out[0, 0], 0.8, atol=1e-5)
    np.testing.assert_allclose(out[-1, -1], 0.8, atol=1e-5)


@pytest.mark.parametrize("radius", [0, 2, 4, 8])
def test_denoise_matches_float64_numpy(radius):
    """The XLA stencil equals the oracle's float64 NumPy denoise over
    the GUI's radius range, on a noisy G-buffer (mixed normals, depths,
    materials and misses) with frame-edge taps."""
    from voxtracer import parity

    gate = parity.denoise_gate(21, 37, radius, seed=radius)
    assert gate["ok"], gate
