"""Path-trace stage as one Pallas kernel for NVIDIA GPUs (Triton route).

Same semantics as :func:`voxtracer.ops.trace_xla.render_sample` (and so
as :mod:`voxtracer.oracle.renderer`): the same ray generation, the same
one-cell DDA over the dense grid, the same 3-bounce integrator with sun
next-event estimation and the same fixed noise-slot schedule, and the
same G-buffer dict out.

The XLA twin marches every ray of the image in lockstep: each trip of
its ``lax.while_loop`` moves all per-ray state through device memory and
hands the loop predicate to the host, and a frame runs six such loops.
Here one program owns a ``BLOCK_H x BLOCK_W`` pixel tile, one lane per
ray, and keeps the whole path in registers: all 3 bounces and their 3
shadow rays run in one launch, each DDA a ``while`` loop that ends when
every lane of the tile is done.  This is the reference's own GPU design,
one thread per ray (``shaders/voxels.comp:134-247``).

The scene grid and the noise buffer stay in global memory (every shipped
scene is a few MB, inside the H100's 50 MB L2) and are read with masked
pointer gathers.  Noise is read straight from the (S, 128, 128) buffer
at ``(frame + 1 + k) % S`` instead of materializing the 24 per-frame
noise planes.  Lanes whose path already ended skip their traces.

``interpret=True`` runs the kernel through the Pallas interpreter, which
is how the CPU tests check it; on the GPU it compiles through Triton.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import trace_xla

BLOCK_H = 16
BLOCK_W = 16
NUM_WARPS = 4

_F32 = jnp.float32
_I32 = jnp.int32

# float parameter vector layout (see _pack_params)
_P_ORIGIN, _P_RIGHT, _P_UP, _P_FWD = 0, 3, 6, 9
_P_SUN_DIR = 12  # sun_direction(yaw, pitch)
_P_SUN_N = 15  # normalize(sun_dir)
_P_SUN_NEG_N = 18  # normalize(-sun_dir)
_P_SUN_COLOR = 21  # sun_color * sun_strength
_P_SKY = 24
_P_EMIT = 27
_P_SUN_SIZE = 28
_P_SPEC = 29
_P_SUN_ON = 30  # 1.0 where sun_strength > 0
_P_SUN_EXP = 31  # 1 / max(sun_size**2, 1e-12)


def _pack_params(cam, params):
    """Traced: the kernel's (32,) f32 parameter vector.  The per-frame sun
    terms are computed here by the same jnp expressions as the XLA twin,
    so both kernels shade with identical constants."""
    sun_dir = trace_xla.sun_direction(params.sun_yaw, params.sun_pitch)
    sun_color = jnp.asarray(params.sun_color) * params.sun_strength
    parts = [
        jnp.reshape(cam.astype(_F32), (12,)),
        sun_dir,
        trace_xla._normalize(sun_dir),
        trace_xla._normalize(-sun_dir),
        sun_color,
        jnp.asarray(params.sky_color),
        jnp.stack(
            [
                jnp.asarray(params.emit_strength, _F32),
                jnp.asarray(params.sun_size, _F32),
                jnp.asarray(params.specularity, _F32),
                (jnp.asarray(params.sun_strength) > 0).astype(_F32),
                1.0 / jnp.maximum(jnp.asarray(params.sun_size, _F32) ** 2,
                                  1e-12),
            ]
        ),
    ]
    return jnp.concatenate([jnp.asarray(p, _F32).reshape(-1) for p in parts])


# -- per-lane 3-vector helpers (tuples of (n,) arrays) -----------------


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a):
    n = jnp.sqrt(_dot(a, a))
    return tuple(c / n for c in a)


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _select(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def _node_color(node):
    return tuple(
        ((node >> s) & 0xFF).astype(_F32) / 255.0 for s in (16, 8, 0)
    )


def _trace(grid_ref, o, d, active, dims, origin, max_iterations):
    """Lane-wise DDA to the first occupied cell, for lanes in
    ``active``.  The body is :func:`trace_xla.trace_rays`' loop body
    line for line, so hits, the iteration fuse and normals agree; only
    the loop ends when this tile's lanes are done instead of the
    whole image's.  Returns (hit, t, value, normal)."""
    cell_size = trace_xla.CELL
    inv = tuple(jnp.where(c != 0.0, 1.0 / c, jnp.inf) for c in d)
    lo_t = tuple(
        (np.float32(origin[a] * cell_size) - o[a]) * inv[a] for a in range(3)
    )
    hi_t = tuple(
        (np.float32((origin[a] + dims[a]) * cell_size) - o[a]) * inv[a]
        for a in range(3)
    )
    mins = [jnp.minimum(lo_t[a], hi_t[a]) for a in range(3)]
    maxs = [jnp.maximum(lo_t[a], hi_t[a]) for a in range(3)]
    t_entry = jnp.maximum(jnp.maximum(mins[0], mins[1]), mins[2])
    t_exit = jnp.minimum(jnp.minimum(maxs[0], maxs[1]), maxs[2])
    alive = active & (t_exit >= 0.0) & (t_entry < t_exit)

    t0 = jnp.maximum(0.0, t_entry)
    cell = []
    for a in range(3):
        cf = (o[a] + t0 * d[a]) / cell_size - np.float32(origin[a])
        c = jnp.floor(cf)
        c = jnp.where((cf == c) & (d[a] < 0), c - 1, c).astype(_I32)
        cell.append(jnp.clip(c, 0, dims[a] - 1))
    step = tuple(jnp.sign(c).astype(_I32) for c in d)
    stride = (dims[1] * dims[2], dims[2])

    def cond(s):
        i, alive = s[0], s[1]
        return (i < max_iterations) & (jnp.max(alive.astype(_I32)) > 0)

    def body(s):
        i, alive, cx, cy, cz, t, hit, value, ht, hx, hy, hz = s
        c = (cx, cy, cz)
        in_bounds = (
            (cx >= 0) & (cx < dims[0])
            & (cy >= 0) & (cy < dims[1])
            & (cz >= 0) & (cz < dims[2])
        )
        alive = alive & in_bounds
        flat = cx * stride[0] + cy * stride[1] + cz
        val = plgpu.load(
            grid_ref.at[jnp.where(alive, flat, 0)], mask=alive, other=0
        )
        found = alive & (val != 0)
        hit = hit | found
        value = jnp.where(found, val, value)
        ht = jnp.where(found, t, ht)
        hx, hy, hz = _select(found, c, (hx, hy, hz))
        alive = alive & ~found

        t_axes = []
        for a in range(3):
            bound = (
                (origin[a] + c[a] + (step[a] > 0).astype(_I32)).astype(_F32)
                * cell_size
            )
            t_axes.append(
                jnp.where(step[a] != 0, (bound - o[a]) * inv[a], jnp.inf)
            )
        t_cross = jnp.minimum(jnp.minimum(t_axes[0], t_axes[1]), t_axes[2])
        # argmin's first-minimum tie order: x, then y, then z
        on_x = (t_axes[0] <= t_axes[1]) & (t_axes[0] <= t_axes[2])
        on_y = ~on_x & (t_axes[1] <= t_axes[2])
        on_z = ~on_x & ~on_y
        cx = jnp.where(alive & on_x, cx + step[0], cx)
        cy = jnp.where(alive & on_y, cy + step[1], cy)
        cz = jnp.where(alive & on_z, cz + step[2], cz)
        t = jnp.where(alive, t_cross, t)
        return i + 1, alive, cx, cy, cz, t, hit, value, ht, hx, hy, hz

    zi = jnp.zeros_like(cell[0])
    zf = jnp.zeros_like(t0)
    init = (
        np.int32(0), alive, cell[0], cell[1], cell[2], t0,
        alive & False, zi, zf, zi, zi, zi,
    )
    _, alive, cx, cy, cz, t, hit, value, ht, hx, hy, hz = jax.lax.while_loop(
        cond, body, init
    )

    # iteration fuse: still-marching rays become opaque black leaves
    hit = hit | alive
    value = jnp.where(alive, trace_xla.LEAF_BIT, value)
    ht = jnp.where(alive, t, ht)
    hc = _select(alive, (cx, cy, cz), (hx, hy, hz))

    dist = []
    for a in range(3):
        p_hit = o[a] + ht * d[a]
        center = (origin[a] + hc[a]).astype(_F32) * cell_size + (
            0.5 * cell_size
        )
        dist.append(jnp.abs(p_hit - center))
    max_dist = jnp.maximum(jnp.maximum(dist[0], dist[1]), dist[2])
    normal = tuple(
        jnp.where(hit & (dist[a] == max_dist), -jnp.sign(d[a]), 0.0)
        for a in range(3)
    )
    return hit, ht, value, normal


def _kernel(
    fp_ref, ip_ref, grid_ref, noise_ref,
    color_ref, normal_ref, depth_ref, albedo_ref, node_ref,
    *, dims, origin, height, width, noise_shape, max_bounces,
    max_iterations,
):
    n = BLOCK_H * BLOCK_W
    lane = jax.lax.broadcasted_iota(_I32, (n,), 0)
    y = pl.program_id(0) * BLOCK_H + lane // BLOCK_W
    x = pl.program_id(1) * BLOCK_W + lane % BLOCK_W
    valid = (y < height) & (x < width)
    frame = ip_ref[0]
    gy = y + ip_ref[1]  # global image row (row-sharded slabs)

    def vec3(i):
        return tuple(fp_ref[i + a] for a in range(3))

    def scalar(i):
        return fp_ref[i]

    n_slices, sh, sw = noise_shape
    pix_off = (gy % sh) * sw + x % sw

    def rand(k):
        s = (frame + (1 + k)) % n_slices
        return plgpu.load(
            noise_ref.at[s * (sh * sw) + pix_off], mask=valid, other=0.0
        )

    right, up, fwd = vec3(_P_RIGHT), vec3(_P_UP), vec3(_P_FWD)
    px = x.astype(_F32)
    py = gy.astype(_F32)
    ray_dir = _normalize(
        tuple(px * right[a] - py * up[a] + fwd[a] for a in range(3))
    )
    zero = jnp.zeros_like(px)
    ray_origin = tuple(zero + c for c in vec3(_P_ORIGIN))

    sun_dir = vec3(_P_SUN_DIR)
    sun_n = vec3(_P_SUN_N)
    sun_neg_n = vec3(_P_SUN_NEG_N)
    sun_color = vec3(_P_SUN_COLOR)
    sky_color = vec3(_P_SKY)
    emit = scalar(_P_EMIT)
    sun_size = scalar(_P_SUN_SIZE)
    specularity = scalar(_P_SPEC)
    sun_on = scalar(_P_SUN_ON) > 0.0
    sun_exp = scalar(_P_SUN_EXP)

    sample = (zero, zero, zero)
    blending = (zero + 1.0, zero + 1.0, zero + 1.0)
    ambient = zero + 1.0
    path_alive = valid
    first_node = jnp.zeros_like(lane) + trace_xla.MISS_NODE
    first_normal = tuple(zero + trace_xla.ALMOST_INFINITY for _ in range(3))
    first_time = zero - 1.0

    for bounce in range(max_bounces):
        k0 = trace_xla.RANDS_PER_BOUNCE * bounce
        hit, t, node, normal = _trace(
            grid_ref, ray_origin, ray_dir, path_alive, dims, origin,
            max_iterations,
        )
        hit_pos = tuple(ray_origin[a] + t * ray_dir[a] for a in range(3))

        if bounce == 0:
            color = (zero + 1.0, zero + 1.0, zero + 1.0)
            first_node = jnp.where(hit, node, first_node)
            first_normal = _select(hit, normal, first_normal)
            first_time = jnp.where(hit, t, first_time)
        else:
            color = _node_color(node)
        emissive = (node & trace_xla.EMISSIVE_BIT) != 0
        node_rgb = _node_color(node)

        specular = rand(k0) < specularity
        nd = _dot(normal, ray_dir)
        reflect = _normalize(
            tuple(ray_dir[a] - 2.0 * nd * normal[a] for a in range(3))
        )
        rn = _dot(reflect, normal)
        spec_blend = tuple(2.0 * color[a] * rn for a in range(3))

        # sun next-event estimation: only diffuse hits use the result,
        # so only they trace the shadow ray
        rand_dir = (rand(k0 + 1), rand(k0 + 2), rand(k0 + 3))
        up_dir = _normalize(_cross(rand_dir, sun_dir))
        right_dir = _normalize(_cross(sun_dir, up_dir))
        dx = 2.0 * rand(k0 + 4) - 1.0
        dy = 2.0 * rand(k0 + 5) - 1.0
        light_dir = tuple(
            sun_n[a] + (dx * right_dir[a] + dy * up_dir[a]) * sun_size
            for a in range(3)
        )
        shadow_dir = _normalize(tuple(-c for c in light_dir))
        shadow_origin = tuple(
            hit_pos[a] + trace_xla.RAY_EPS * normal[a] for a in range(3)
        )
        diff_sel = ~specular & hit
        spec_sel = specular & hit
        lit = diff_sel & sun_on
        obstructed, _, _, _ = _trace(
            grid_ref, shadow_origin, shadow_dir, lit, dims, origin,
            max_iterations,
        )
        cos_term = jnp.maximum(0.0, _dot(normal, shadow_dir))

        phi = (2.0 * np.pi) * rand(k0 + 6)
        hx = 2.0 * rand(k0 + 7) - 1.0
        plane_r = jnp.sqrt(jnp.maximum(0.0, 1.0 - hx * hx))
        sphere = (hx, plane_r * jnp.cos(phi), plane_r * jnp.sin(phi))
        ndot = _dot(normal, sphere)
        hemi = tuple(
            sphere[a] - normal[a] * jnp.minimum(0.0, 2.0 * ndot)
            for a in range(3)
        )
        nh = _dot(normal, hemi)

        sun_ok = lit & ~obstructed
        sample = tuple(
            sample[a]
            + jnp.where(
                hit & emissive, emit * node_rgb[a] * blending[a], 0.0
            )
            + jnp.where(
                sun_ok, sun_color[a] * color[a] * blending[a] * cos_term, 0.0
            )
            for a in range(3)
        )
        ambient = ambient + lit.astype(_F32)
        blending = tuple(
            jnp.where(
                spec_sel,
                blending[a] * spec_blend[a],
                jnp.where(diff_sel, blending[a] * (color[a] * nh), blending[a]),
            )
            for a in range(3)
        )
        ray_dir = _select(spec_sel, reflect, _select(diff_sel, hemi, ray_dir))
        ray_origin = _select(
            hit,
            tuple(
                hit_pos[a] + trace_xla.RAY_EPS * normal[a] for a in range(3)
            ),
            ray_origin,
        )

        miss = path_alive & ~hit
        if bounce == 0:
            sun_power = jnp.power(
                jnp.maximum(0.0, _dot(ray_dir, sun_neg_n)), sun_exp
            )
            sky = tuple(
                sky_color[a] + sun_color[a] * sun_power for a in range(3)
            )
        else:
            sky = sky_color
        sample = tuple(
            sample[a] + jnp.where(miss, sky[a] * blending[a], 0.0)
            for a in range(3)
        )
        path_alive = path_alive & hit

    emissive_first = (first_node & trace_xla.EMISSIVE_BIT) != 0
    first_rgb = _node_color(first_node)
    pix = y * width + x
    for a in range(3):
        idx = pix * 3 + a
        plgpu.store(color_ref.at[idx], sample[a] / ambient, mask=valid)
        plgpu.store(normal_ref.at[idx], first_normal[a], mask=valid)
        plgpu.store(
            albedo_ref.at[idx],
            jnp.where(emissive_first, 1.0, first_rgb[a]),
            mask=valid,
        )
    plgpu.store(depth_ref.at[pix], first_time, mask=valid)
    plgpu.store(node_ref.at[pix], first_node, mask=valid)


def render_sample(
    flat_grid: jnp.ndarray,  # int32 [X*Y*Z]
    dims: Tuple[int, int, int],  # static
    grid_origin: Tuple[int, int, int],  # static
    cam: jnp.ndarray,  # (4, 3): origin, right, up, forward (pixel-scaled)
    params,  # RenderParams pytree (traced leaves)
    noise_buffer: jnp.ndarray,  # (S, 128, 128) f32
    frame_number,  # int32 scalar
    height: int,
    width: int,
    row0=0,  # traced: global image row of this slab's row 0
    interpret: bool = False,
    max_bounces: int = trace_xla.MAX_BOUNCES,
    max_iterations: int = trace_xla.MAX_ITERATIONS,
) -> Dict[str, jnp.ndarray]:
    """One 1-spp path-traced sample; returns the G-buffer of
    :func:`trace_xla.render_sample` (channels-last color, normal and
    albedo, (H, W) depth and node)."""
    dims = tuple(int(d) for d in dims)
    origin = tuple(int(v) for v in grid_origin)
    fp = _pack_params(cam, params)
    ip = jnp.stack(
        [jnp.asarray(frame_number, _I32), jnp.asarray(row0, _I32)]
    )
    noise_shape = tuple(int(s) for s in noise_buffer.shape)
    n = height * width
    kernel = functools.partial(
        _kernel,
        dims=dims,
        origin=origin,
        height=height,
        width=width,
        noise_shape=noise_shape,
        max_bounces=int(max_bounces),
        max_iterations=int(max_iterations),
    )
    color, normal, depth, albedo, node = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((n * 3,), _F32),
            jax.ShapeDtypeStruct((n * 3,), _F32),
            jax.ShapeDtypeStruct((n,), _F32),
            jax.ShapeDtypeStruct((n * 3,), _F32),
            jax.ShapeDtypeStruct((n,), _I32),
        ),
        grid=(pl.cdiv(height, BLOCK_H), pl.cdiv(width, BLOCK_W)),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        name="trace_triton",
    )(fp, ip, flat_grid, jnp.reshape(noise_buffer, (-1,)))
    return {
        "color": color.reshape(height, width, 3),
        "normal": normal.reshape(height, width, 3),
        "depth": depth.reshape(height, width),
        "albedo": albedo.reshape(height, width, 3),
        "node": node.reshape(height, width),
    }
