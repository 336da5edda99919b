"""Temporal reprojection / accumulation stage.

Semantics of ``shaders/temporal.comp``: reproject each pixel's first-hit
world position into the previous frame through the inverse of the old
camera's pixel-basis matrix, validate the history sample by a
world-distance test scaled by depth and view angle, then blend
``mix(old, new, blending)`` where the per-pixel blending factor rides in
the history alpha channel and follows
``next = clamp((1 - sample_blending) * blending, 1 - maximum_blending, 1)``
(``temporal.comp:109-124``).

Two execution strategies, chosen statically by the pipeline:

* ``reproject=False`` — camera at rest (BASELINE config 2's progressive
  accumulation): the reprojection is the identity, so history lookups
  are pure elementwise passthrough.  No gathers; everything fuses.
* ``reproject=True`` — full resampling with 4-tap bilinear history
  fetches (``jnp.take`` gathers), correct for any in-frame offset
  (``temporal.comp:92-114``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .trace_xla import _normalize


def _pixel_rays(camera_right, camera_up, camera_forward, height, width,
                row0=None):
    px = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 0)
    if row0 is not None:
        py = py + row0
    return _normalize(
        px * camera_right + (-py) * camera_up + camera_forward
    )


def _inv3(m: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) 3x3 inverse, like GLSL ``inverse()``.

    A cofactor expansion is three cross products and a dot, where
    ``jnp.linalg.inv`` would lower to a general LU factorization.
    """
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    r0 = jnp.cross(b, c)
    r1 = jnp.cross(c, a)
    r2 = jnp.cross(a, b)
    det = jnp.dot(a, r0)
    return jnp.stack([r0, r1, r2], axis=0) / det


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Sample (H, W, C) at float pixel-center coordinates with
    clamp-to-edge, matching a GPU linear sampler at normalized coords."""
    h, w = img.shape[:2]
    xf = x - 0.5
    yf = y - 0.5
    x0 = jnp.floor(xf)
    y0 = jnp.floor(yf)
    tx = (xf - x0)[..., None]
    ty = (yf - y0)[..., None]

    def fetch(xi, yi):
        xi = jnp.clip(xi.astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(yi.astype(jnp.int32), 0, h - 1)
        flat = img.reshape(h * w, -1)
        return jnp.take(flat, yi * w + xi, axis=0)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def temporal_blend_still_planar(
    sampled_color: jnp.ndarray,  # (3, H, W) current trace output
    normal: jnp.ndarray,  # (3, H, W) current first-hit normals
    depth: jnp.ndarray,  # (H, W) current first-hit depth
    old_color: jnp.ndarray,  # (3, H, W) history color
    old_blend: jnp.ndarray,  # (H, W) history blending (alpha)
    old_depth: jnp.ndarray,  # (H, W) history depth
    cam: Tuple[jnp.ndarray, ...],  # origin, right, up, forward (scaled)
    old_cam: Tuple[jnp.ndarray, ...],
    params,  # TemporalParams
    history_valid,  # scalar bool (False on the first frame)
    row0=None,  # traced: global pixel row of row 0 (sharded slabs)
):
    """PLANAR still-frame blend: :func:`temporal_blend` with
    ``reproject=False``, on (3, H, W) plane stacks.

    The camera at rest is the accumulation steady state, and the
    carried history is planar.  The math is the same elementwise chain
    (``temporal.comp:99-124`` with the identity reprojection), fully
    fused by XLA; only the broadcast axis differs.  Returns
    ``(blended (3,H,W), next_blending (H,W))``.
    """
    height, width = depth.shape
    origin, right, up, forward = cam
    o_origin, o_right, o_up, o_forward = old_cam

    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    if row0 is not None:
        py = py + row0

    def ray_planes(r, u, f):
        x = px * r[0] - py * u[0] + f[0]
        y = px * r[1] - py * u[1] + f[1]
        z = px * r[2] - py * u[2] + f[2]
        n = jnp.sqrt(x * x + y * y + z * z)
        return x / n, y / n, z / n

    rx, ry, rz = ray_planes(right, up, forward)
    wx = origin[0] + depth * rx
    wy = origin[1] + depth * ry
    wz = origin[2] + depth * rz

    orx, ory, orz = ray_planes(o_right, o_up, o_forward)
    owx = o_origin[0] + old_depth * orx
    owy = o_origin[1] + old_depth * ory
    owz = o_origin[2] + old_depth * orz

    cdx = origin[0] - wx
    cdy = origin[1] - wy
    cdz = origin[2] - wz
    cn = jnp.sqrt(cdx * cdx + cdy * cdy + cdz * cdz)
    bias = jnp.maximum(
        0.0,
        (cdx / cn) * normal[0]
        + (cdy / cn) * normal[1]
        + (cdz / cn) * normal[2],
    )
    dx = owx - wx
    dy = owy - wy
    dz = owz - wz
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    same_position = dist < bias * params.blending_distance_cutoff * depth

    valid = same_position & (depth >= 0) & history_valid
    use_color = jnp.where(valid[None], old_color, 0.0)
    blending = jnp.where(valid, old_blend, 1.0)
    blended = jnp.where(
        (depth >= 0)[None],
        use_color * (1.0 - blending[None]) + sampled_color * blending[None],
        sampled_color,
    )
    next_blending = jnp.clip(
        (1.0 - params.sample_blending) * blending,
        1.0 - params.maximum_blending,
        1.0,
    )
    return blended, next_blending


def temporal_blend(
    sampled_color: jnp.ndarray,  # (H, W, 3) current trace output
    normal: jnp.ndarray,  # (H, W, 3) current first-hit normals
    depth: jnp.ndarray,  # (H, W) current first-hit depth
    old_color: jnp.ndarray,  # (H, W, 3) history color
    old_blend: jnp.ndarray,  # (H, W) history blending (alpha)
    old_depth: jnp.ndarray,  # (H, W) history depth
    cam: Tuple[jnp.ndarray, ...],  # origin, right, up, forward (scaled)
    old_cam: Tuple[jnp.ndarray, ...],
    params,  # TemporalParams
    history_valid,  # scalar bool (False on the first frame)
    reproject: bool = True,  # static
    row0=None,  # traced: global pixel row of row 0 (sharded slabs)
):
    """Returns (blended_color (H,W,3), next_blending (H,W))."""
    height, width = depth.shape
    origin, right, up, forward = cam
    o_origin, o_right, o_up, o_forward = old_cam

    ray = _pixel_rays(right, up, forward, height, width, row0=row0)
    world = origin + depth[..., None] * ray

    if reproject:
        # Reprojected coordinates are image pixels, so bounds and taps
        # clamp to the HISTORY dims (equal to the current dims unless
        # a caller passes a row slab with ``row0`` against the full
        # history).
        hist_h, hist_w = old_depth.shape
        # world -> old screen: solve columns([right, up, fwd]) @ s = world - o
        basis = jnp.stack([o_right, o_up, o_forward], axis=1)  # 3x3 columns
        inv = _inv3(basis)
        rel = world - o_origin
        # explicit component products, NOT einsum: a dot_general at
        # default precision may run in reduced precision (TF32 on the
        # GPU), which moves reprojection coords by a fraction of a
        # pixel; elementwise math stays exact f32
        rx, ry, rz = rel[..., 0], rel[..., 1], rel[..., 2]
        s0 = inv[0, 0] * rx + inv[0, 1] * ry + inv[0, 2] * rz
        s1 = inv[1, 0] * rx + inv[1, 1] * ry + inv[1, 2] * rz
        s2 = inv[2, 0] * rx + inv[2, 1] * ry + inv[2, 2] * rz
        sx = s0 / s2
        sy = s1 / s2
        tex_x = (sx + 0.5) / hist_w
        tex_y = (sy - 0.5) / -hist_h
        in_range = (
            (tex_x >= 0) & (tex_x <= 1) & (tex_y >= 0) & (tex_y <= 1)
        )
        px_f = tex_x * hist_w
        py_f = tex_y * hist_h
        # one 5-channel history fetch: rgb + blending + depth share the
        # same 4 bilinear taps
        hist5 = _bilinear(
            jnp.concatenate(
                [old_color, old_blend[..., None], old_depth[..., None]],
                axis=-1,
            ),
            px_f,
            py_f,
        )
        old_nd = hist5[..., 4]
        # Old ray reconstruction quantizes to the pixel lattice
        # (temporal.comp:99-103); int() truncates toward zero.
        qx = jnp.trunc(sx + 0.5)
        qy = jnp.trunc(sy - 0.5)
        old_ray = _normalize(
            qx[..., None] * o_right + qy[..., None] * o_up + o_forward
        )
        old_world = o_origin + old_nd[..., None] * old_ray
    else:
        in_range = jnp.ones_like(depth, bool)
        old_nd = old_depth
        qx = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 1)
        qy = jax.lax.broadcasted_iota(jnp.float32, (height, width, 1), 0)
        if row0 is not None:
            qy = qy + row0
        old_ray = _normalize(qx * o_right + (-qy) * o_up + o_forward)
        old_world = o_origin + old_nd[..., None] * old_ray

    camera_dir = _normalize(origin - world)
    bias = jnp.maximum(0.0, jnp.sum(camera_dir * normal, axis=-1))
    dist = jnp.linalg.norm(old_world - world, axis=-1)
    same_position = dist < bias * params.blending_distance_cutoff * depth

    if reproject:
        hist_color, hist_blend = hist5[..., :3], hist5[..., 3]
    else:
        hist_color, hist_blend = old_color, old_blend

    valid = in_range & same_position & (depth >= 0) & history_valid
    use_color = jnp.where(valid[..., None], hist_color, 0.0)
    blending = jnp.where(valid, hist_blend, 1.0)

    blended = jnp.where(
        (depth >= 0)[..., None],
        use_color * (1.0 - blending[..., None])
        + sampled_color * blending[..., None],
        sampled_color,
    )
    next_blending = jnp.clip(
        (1.0 - params.sample_blending) * blending,
        1.0 - params.maximum_blending,
        1.0,
    )
    return blended, next_blending
