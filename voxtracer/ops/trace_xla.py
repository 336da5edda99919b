"""Path-trace stage in pure XLA (jnp) — portable reference kernel.

Implements exactly the semantics of :mod:`voxtracer.oracle.renderer`
(itself the semantic twin of ``shaders/voxels.comp``) with JAX ops, so
it runs under ``jit`` on any backend.  Traversal state lives in flat
per-ray arrays advanced by a ``lax.while_loop`` lockstep DDA; voxel
fetches are ``jnp.take`` gathers.  This is the CPU path and the
reference for the GPU kernel (:mod:`voxtracer.ops.trace_triton`), which
must agree with it on hits and to float tolerance on shading.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_BOUNCES = 3
MAX_ITERATIONS = 2048
RANDS_PER_BOUNCE = 8
ALMOST_INFINITY = float(1 << 30)
CELL = 0.5
RAY_EPS = 1e-5
# numpy scalars, NOT jnp: a jnp scalar is a device array, which lowering
# would embed as a constant fetched back from the device.
LEAF_BIT = np.int32(-(1 << 31))
EMISSIVE_BIT = np.int32(1 << 30)
MISS_NODE = np.int32(0xFFFFFF)


def _normalize(v):
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def _node_color(node):
    node = node.astype(jnp.int32)
    r = (node >> 16) & 0xFF
    g = (node >> 8) & 0xFF
    b = node & 0xFF
    return jnp.stack([r, g, b], axis=-1).astype(jnp.float32) / 255.0


def sun_direction(yaw, pitch):
    return jnp.stack(
        [
            jnp.cos(yaw) * jnp.cos(pitch),
            -jnp.sin(pitch),
            jnp.sin(yaw) * jnp.cos(pitch),
        ]
    )


def trace_rays(
    flat_grid: jnp.ndarray,  # int32 [X*Y*Z]
    dims: Tuple[int, int, int],  # static
    grid_origin: jnp.ndarray,  # int32 [3]
    origins: jnp.ndarray,  # (N, 3) f32
    dirs: jnp.ndarray,  # (N, 3) f32 normalized
    max_iterations: int = MAX_ITERATIONS,
):
    """Lockstep DDA to the first occupied cell.

    Returns (hit, t, value, normal) — same contract as the oracle's
    ``trace_rays``.
    """
    n = origins.shape[0]
    # numpy (host) constant: a jnp.array here would be created eagerly on
    # the device and then fetched back during lowering.
    dims_arr = np.array(dims, np.int32)
    world_lo = grid_origin.astype(jnp.float32) * CELL
    world_hi = (grid_origin + dims_arr).astype(jnp.float32) * CELL

    o = origins
    d = dirs
    inv_d = jnp.where(d != 0.0, 1.0 / d, jnp.inf)

    lo_t = (world_lo[None, :] - o) * inv_d
    hi_t = (world_hi[None, :] - o) * inv_d
    t_entry = jnp.minimum(lo_t, hi_t).max(axis=1)
    t_exit = jnp.maximum(lo_t, hi_t).min(axis=1)
    intersects = (t_exit >= 0.0) & (t_entry < t_exit)

    t0 = jnp.maximum(0.0, t_entry)
    p = o + t0[:, None] * d
    cell_f = p / CELL - grid_origin[None, :].astype(jnp.float32)
    cell = jnp.floor(cell_f)
    cell = jnp.where((cell_f == cell) & (d < 0), cell - 1, cell).astype(
        jnp.int32
    )
    # Entry-point rounding may land an epsilon outside the box; clamp the
    # starting cell so intersecting rays always begin inside the grid.
    cell = jnp.clip(cell, 0, dims_arr[None, :] - 1)
    step = jnp.sign(d).astype(jnp.int32)

    def cond(state):
        i, alive, *_ = state
        return jnp.logical_and(i < max_iterations, alive.any())

    def body(state):
        i, alive, cell, t, hit, value, hit_t, hit_cell = state
        in_bounds = jnp.logical_and(cell >= 0, cell < dims_arr[None, :]).all(
            axis=1
        )
        alive = alive & in_bounds

        flat_idx = (
            cell[:, 0] * (dims[1] * dims[2])
            + cell[:, 1] * dims[2]
            + cell[:, 2]
        )
        val = jnp.take(flat_grid, jnp.where(alive, flat_idx, 0), axis=0)
        found = alive & (val != 0)

        hit = hit | found
        value = jnp.where(found, val, value)
        hit_t = jnp.where(found, t, hit_t)
        hit_cell = jnp.where(found[:, None], cell, hit_cell)
        alive = alive & ~found

        next_bound = (
            (grid_origin[None, :] + cell + (step > 0)).astype(jnp.float32)
            * CELL
        )
        t_axes = jnp.where(step != 0, (next_bound - o) * inv_d, jnp.inf)
        t_cross = t_axes.min(axis=1)
        axis = jnp.argmin(t_axes, axis=1)
        adv = jax.nn.one_hot(axis, 3, dtype=jnp.int32) * step
        cell = jnp.where(alive[:, None], cell + adv, cell)
        t = jnp.where(alive, t_cross, t)
        return i + 1, alive, cell, t, hit, value, hit_t, hit_cell

    # All loop-state inits derive from traced values (zeros_like) so no
    # eager device constants are embedded at lowering time.
    init = (
        np.int32(0),
        intersects,
        cell,
        t0,
        jnp.zeros_like(intersects),
        jnp.zeros_like(cell[:, 0]),
        jnp.zeros_like(t0),
        jnp.zeros_like(cell),
    )
    _, alive, cell, t, hit, value, hit_t, hit_cell = jax.lax.while_loop(
        cond, body, init
    )

    # Iteration fuse: still-marching rays become opaque black leaves
    # (voxels.comp:166-169).
    hit = hit | alive
    value = jnp.where(alive, LEAF_BIT, value)
    hit_t = jnp.where(alive, t, hit_t)
    hit_cell = jnp.where(alive[:, None], cell, hit_cell)

    p_hit = o + hit_t[:, None] * d
    center = (grid_origin[None, :] + hit_cell).astype(jnp.float32) * CELL + (
        0.5 * CELL
    )
    dist = jnp.abs(p_hit - center)
    max_dist = dist.max(axis=1, keepdims=True)
    normal = jnp.where(dist == max_dist, -jnp.sign(d), 0.0)
    normal = jnp.where(hit[:, None], normal, 0.0)
    return hit, hit_t, value, normal


def render_sample(
    flat_grid: jnp.ndarray,
    dims: Tuple[int, int, int],  # static
    grid_origin: jnp.ndarray,
    camera_origin: jnp.ndarray,  # (3,)
    camera_right: jnp.ndarray,
    camera_up: jnp.ndarray,
    camera_forward: jnp.ndarray,  # pixel-scaled
    params,  # RenderParams pytree (traced leaves)
    noise_planes: jnp.ndarray,  # (24, H, W)
    height: int,
    width: int,
    max_bounces: int = MAX_BOUNCES,
    max_iterations: int = MAX_ITERATIONS,
) -> Dict[str, jnp.ndarray]:
    """One 1-spp path-traced sample; returns the trace G-buffer."""
    n = height * width
    # broadcasted_iota instead of arange: index grids stay traced values,
    # so no eager device constants get embedded in the lowered module.
    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1).reshape(n)
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0).reshape(n)

    ray_dir = _normalize(
        px[:, None] * camera_right[None, :]
        - py[:, None] * camera_up[None, :]
        + camera_forward[None, :]
    ).astype(jnp.float32)
    ray_origin = jnp.broadcast_to(camera_origin, (n, 3)).astype(jnp.float32)

    noise = noise_planes.reshape(noise_planes.shape[0], n)

    sun_dir = sun_direction(params.sun_yaw, params.sun_pitch)
    sun_color = jnp.asarray(params.sun_color) * params.sun_strength
    sky_color = jnp.asarray(params.sky_color)

    sample_color = jnp.zeros_like(ray_dir)
    blending = jnp.ones_like(ray_dir)
    ambient_rays = jnp.ones_like(px)
    path_alive = jnp.full_like(px, True, dtype=bool)

    first_node = jnp.full_like(px, MISS_NODE, dtype=jnp.int32)
    first_normal = jnp.full_like(ray_dir, ALMOST_INFINITY)
    first_time = jnp.full_like(px, -1.0)

    for bounce in range(max_bounces):
        k0 = RANDS_PER_BOUNCE * bounce
        hit, t, node, normal = trace_rays(
            flat_grid, dims, grid_origin, ray_origin, ray_dir,
            max_iterations,
        )
        hit = hit & path_alive
        hit_pos = ray_origin + t[:, None] * ray_dir

        color = (
            jnp.ones_like(ray_dir) if bounce == 0 else _node_color(node)
        )
        emissive = (node & EMISSIVE_BIT) != 0
        emittance = (
            emissive[:, None] * params.emit_strength * _node_color(node)
        )

        if bounce == 0:
            first_node = jnp.where(hit, node, first_node)
            first_normal = jnp.where(hit[:, None], normal, first_normal)
            first_time = jnp.where(hit, t, first_time)

        specular = noise[k0] < params.specularity

        reflect = _normalize(
            ray_dir
            - 2.0 * jnp.sum(normal * ray_dir, axis=1, keepdims=True) * normal
        )
        spec_blend = (
            2.0 * color * jnp.sum(reflect * normal, axis=1, keepdims=True)
        )

        # Sun next-event estimation (always traced; sun_strength gates
        # the contribution so the param stays dynamic).
        rand_dir = jnp.stack(
            [noise[k0 + 1], noise[k0 + 2], noise[k0 + 3]], axis=1
        )
        up_dir = _normalize(jnp.cross(rand_dir, sun_dir[None, :]))
        right_dir = _normalize(jnp.cross(sun_dir[None, :], up_dir))
        dx = 2.0 * noise[k0 + 4] - 1.0
        dy = 2.0 * noise[k0 + 5] - 1.0
        light_dir = _normalize(sun_dir)[None, :] + (
            dx[:, None] * right_dir + dy[:, None] * up_dir
        ) * params.sun_size
        shadow_dir = _normalize(-light_dir).astype(jnp.float32)
        shadow_origin = (hit_pos + RAY_EPS * normal).astype(jnp.float32)
        obstructed, _, _, _ = trace_rays(
            flat_grid, dims, grid_origin, shadow_origin, shadow_dir,
            max_iterations,
        )
        cos_term = jnp.maximum(0.0, jnp.sum(normal * shadow_dir, axis=1))
        sun_on = jnp.asarray(params.sun_strength) > 0
        sun_contrib = jnp.where(
            (obstructed | jnp.logical_not(sun_on))[:, None],
            0.0,
            sun_color[None, :] * color * blending * cos_term[:, None],
        )

        phi = 2.0 * jnp.pi * noise[k0 + 6]
        hx = 2.0 * noise[k0 + 7] - 1.0
        plane_r = jnp.sqrt(jnp.maximum(0.0, 1.0 - hx * hx))
        sphere = jnp.stack(
            [hx, plane_r * jnp.cos(phi), plane_r * jnp.sin(phi)], axis=1
        )
        ndot = jnp.sum(normal * sphere, axis=1, keepdims=True)
        hemi = sphere - normal * jnp.minimum(0.0, 2.0 * ndot)
        diff_blend = color * jnp.sum(normal * hemi, axis=1, keepdims=True)

        spec_sel = specular & hit
        diff_sel = ~specular & hit

        sample_color = sample_color + jnp.where(
            hit[:, None], emittance * blending, 0.0
        )
        sample_color = sample_color + jnp.where(
            diff_sel[:, None] & sun_on, sun_contrib, 0.0
        )
        ambient_rays = ambient_rays + (diff_sel & sun_on)

        blending = jnp.where(
            spec_sel[:, None],
            blending * spec_blend,
            jnp.where(diff_sel[:, None], blending * diff_blend, blending),
        )
        ray_dir = jnp.where(
            spec_sel[:, None], reflect, jnp.where(diff_sel[:, None], hemi, ray_dir)
        )
        ray_origin = jnp.where(
            hit[:, None], hit_pos + RAY_EPS * normal, ray_origin
        )

        miss = path_alive & ~hit
        if bounce == 0:
            sun_power = jnp.power(
                jnp.maximum(
                    0.0,
                    jnp.sum(ray_dir * _normalize(-sun_dir)[None, :], axis=1),
                ),
                1.0 / jnp.maximum(params.sun_size**2, 1e-12),
            )
            sky = sky_color[None, :] + sun_color[None, :] * sun_power[:, None]
        else:
            sky = jnp.broadcast_to(sky_color[None, :], (n, 3))
        sample_color = sample_color + jnp.where(
            miss[:, None], sky * blending, 0.0
        )
        path_alive = path_alive & hit

    out_color = sample_color / ambient_rays[:, None]
    emissive_first = (first_node & EMISSIVE_BIT) != 0
    albedo = jnp.where(
        emissive_first[:, None],
        jnp.ones_like(ray_dir),
        _node_color(first_node),
    )

    return {
        "color": out_color.reshape(height, width, 3).astype(jnp.float32),
        "normal": first_normal.reshape(height, width, 3),
        "depth": first_time.reshape(height, width),
        "albedo": albedo.reshape(height, width, 3).astype(jnp.float32),
        "node": first_node.reshape(height, width),
    }
