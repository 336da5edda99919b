"""Cross-bilateral spatial denoiser.

Semantics of ``shaders/denoise.comp``: one pass over a
``(2r+1) x (2r+1)`` window; each tap's weight is a Gaussian over pixel
distance times an edge-stopping term built from color difference,
normal difference, log-depth difference scaled by the view/normal
angle, and a material-id mismatch penalty (``denoise.comp:64-80``);
the filtered color is then remodulated by albedo
(``out = mix(out, albedo * out, albedo_factor)``, ``denoise.comp:90``).

The radius is a static structural parameter, so the window is unrolled
into shifted dense slices: a stencil of elementwise ops that XLA fuses
into one loop, rather than a per-pixel loop with bounds checks.
Out-of-frame taps are excluded by validity masks, matching the
reference's bounds test.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .trace_xla import _normalize


def _pad2d(arr: jnp.ndarray, r: int) -> jnp.ndarray:
    """Zero-pad the two leading (spatial) dims by r on every side.

    Padding once and slicing per tap keeps the stencil loop fusable;
    padding inside the tap loop forced 2*(2r+1)^2 full-image copies
    through HBM."""
    pad = [(r, r), (r, r)] + [(0, 0)] * (arr.ndim - 2)
    return jnp.pad(arr, pad)


def _tap(padded: jnp.ndarray, r: int, dy: int, dx: int, h: int, w: int):
    """padded[r+dy : r+dy+h, r+dx : r+dx+w] — result[y,x] = arr[y+dy, x+dx]."""
    return padded[r + dy : r + dy + h, r + dx : r + dx + w]


def denoise(
    colors: jnp.ndarray,  # (H, W, 3) temporally blended color
    normal: jnp.ndarray,  # (H, W, 3)
    depth: jnp.ndarray,  # (H, W)
    albedo: jnp.ndarray,  # (H, W, 3)
    material: jnp.ndarray,  # (H, W) int32 (top 8 bits compared)
    cam: tuple,  # origin, right, up, forward (pixel-scaled)
    params,  # DenoiseParams (traced sigmas / albedo factor)
    radius: int,  # static
) -> jnp.ndarray:
    height, width = depth.shape
    if radius == 0:
        out = colors
    else:
        origin, right, up, forward = cam
        px = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 1)
        py = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 0)
        ray = _normalize(px * right - py * up + forward)
        depth_bias = jnp.maximum(
            0.0, jnp.sum(normal * -ray, axis=-1)
        )

        sigma_d2 = 2.0 * params.sigma_distance**2
        sigma_r2 = 2.0 * params.sigma_range**2

        log_depth = jnp.log(jnp.abs(depth))
        mat_id = material >> 24

        valid = jnp.ones_like(depth, dtype=bool)
        norm_sum = jnp.zeros_like(depth)
        color_sum = jnp.zeros_like(colors)
        p_color = _pad2d(colors, radius)
        p_normal = _pad2d(normal, radius)
        p_logd = _pad2d(log_depth, radius)
        p_mat = _pad2d(mat_id, radius)
        p_valid = _pad2d(valid, radius)
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                w_color = _tap(p_color, radius, dy, dx, height, width)
                w_normal = _tap(p_normal, radius, dy, dx, height, width)
                w_logd = _tap(p_logd, radius, dy, dx, height, width)
                w_mat = _tap(p_mat, radius, dy, dx, height, width)
                w_valid = _tap(p_valid, radius, dy, dx, height, width)

                cd = colors - w_color
                nd = normal - w_normal
                dd = log_depth - w_logd
                md = (mat_id != w_mat).astype(jnp.float32)

                factor_range = (
                    jnp.sum(cd * cd, axis=-1)
                    + 1e4 * jnp.sum(nd * nd, axis=-1)
                    + 1e4 * (depth_bias * dd) ** 2
                    + 1e4 * md
                ) / sigma_r2
                factor_dist = (dx * dx + dy * dy) / sigma_d2
                f = jnp.exp(-factor_range - factor_dist) * w_valid
                norm_sum = norm_sum + f
                color_sum = color_sum + f[..., None] * w_color
        out = color_sum / norm_sum[..., None]

    factor = params.albedo_factor
    return out * (1.0 - factor) + albedo * out * factor
