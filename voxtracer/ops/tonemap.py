"""Final frame encode: linear -> sRGB -> u8.

The reference blits the linear denoised image into a
``Bgra8UnormSrgb`` swapchain (``src/context.rs:663, 2046-2063``), so the
hardware applies the sRGB transfer on store.  Headless output
reproduces that conversion explicitly.
"""

from __future__ import annotations

import jax.numpy as jnp


def srgb_encode(linear: jnp.ndarray) -> jnp.ndarray:
    c = jnp.clip(linear, 0.0, 1.0)
    return jnp.where(
        c <= 0.0031308,
        12.92 * c,
        1.055 * jnp.power(c, 1.0 / 2.4) - 0.055,
    )


def to_u8(linear_rgb: jnp.ndarray) -> jnp.ndarray:
    return jnp.round(srgb_encode(linear_rgb) * 255.0).astype(jnp.uint8)
