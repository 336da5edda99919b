"""Cross-bilateral denoise as one Pallas kernel for NVIDIA GPUs (Triton
route).

Same semantics as :func:`voxtracer.ops.denoise.denoise` (the
``shaders/denoise.comp`` filter): for every pixel, a Gaussian over pixel
distance times the edge-stopping term of the (2r+1)² window, taps
outside the frame skipped, then the albedo remodulation.

The XLA stencil unrolls the window into (2r+1)² shifted full-image
slices; XLA fuses them into one loop, but at r=8 (289 taps) that loop
is slow to compile and to run.  Here one program owns a ``BLOCK_H x
BLOCK_W`` pixel tile and walks the taps in a rolled loop, reading each
neighbor with masked gathers that the tile's neighbors share through
the L1 cache, so the cost grows with the taps read rather than with
the program's size.

``row0`` / ``out_rows`` let a device filter only its row slab of the
full image (under ``shard_map``).  ``interpret=True`` runs the kernel
through the Pallas interpreter (the CPU tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .trace_triton import _dot, _normalize

BLOCK_H = 8
BLOCK_W = 32
NUM_WARPS = 4

_F32 = jnp.float32
_I32 = jnp.int32


def _kernel(
    fp_ref, ip_ref, color_ref, normal_ref, depth_ref, node_ref, albedo_ref,
    out_ref, *, height, width, out_rows, radius,
):
    n = BLOCK_H * BLOCK_W
    lane = jax.lax.broadcasted_iota(_I32, (n,), 0)
    y = pl.program_id(0) * BLOCK_H + lane // BLOCK_W
    x = pl.program_id(1) * BLOCK_W + lane % BLOCK_W
    valid = (y < out_rows) & (x < width)
    gy = y + ip_ref[0]  # row in the full image
    pix = jnp.where(valid, gy * width + x, 0)

    def load3(ref, q, mask):
        return tuple(
            plgpu.load(ref.at[q * 3 + a], mask=mask, other=0.0)
            for a in range(3)
        )

    def vec3(i):
        return tuple(fp_ref[i + a] for a in range(3))

    right, up, fwd = vec3(0), vec3(3), vec3(6)
    sigma_d2, sigma_r2, factor = fp_ref[9], fp_ref[10], fp_ref[11]

    c = load3(color_ref, pix, valid)
    nrm = load3(normal_ref, pix, valid)
    px = x.astype(_F32)
    py = gy.astype(_F32)
    ray = _normalize(
        tuple(px * right[a] - py * up[a] + fwd[a] for a in range(3))
    )
    depth_bias = jnp.maximum(0.0, _dot(nrm, tuple(-r for r in ray)))
    logd = jnp.log(jnp.abs(plgpu.load(depth_ref.at[pix], mask=valid,
                                      other=1.0)))
    mat = plgpu.load(node_ref.at[pix], mask=valid, other=0) >> 24

    k = 2 * radius + 1

    def body(t, carry):
        norm_sum, s0, s1, s2 = carry
        dy = jax.lax.div(t, k) - radius  # t >= 0: truncation == floor
        dx = jax.lax.rem(t, k) - radius
        ty = gy + dy
        tx = x + dx
        ok = valid & (ty >= 0) & (ty < height) & (tx >= 0) & (tx < width)
        q = jnp.where(ok, ty * width + tx, 0)
        wc = load3(color_ref, q, ok)
        wn = load3(normal_ref, q, ok)
        wlogd = jnp.log(jnp.abs(
            plgpu.load(depth_ref.at[q], mask=ok, other=1.0)
        ))
        wmat = plgpu.load(node_ref.at[q], mask=ok, other=0) >> 24
        cd = tuple(c[a] - wc[a] for a in range(3))
        nd = tuple(nrm[a] - wn[a] for a in range(3))
        dd = logd - wlogd
        md = (mat != wmat).astype(_F32)
        factor_range = (
            _dot(cd, cd)
            + 1e4 * _dot(nd, nd)
            + 1e4 * (depth_bias * dd) ** 2
            + 1e4 * md
        ) / sigma_r2
        factor_dist = (dx * dx + dy * dy).astype(_F32) / sigma_d2
        f = jnp.where(ok, jnp.exp(-factor_range - factor_dist), 0.0)
        return (
            norm_sum + f, s0 + f * wc[0], s1 + f * wc[1], s2 + f * wc[2]
        )

    zero = jnp.zeros_like(px)
    norm_sum, *sums = jax.lax.fori_loop(
        0, k * k, body, (zero, zero, zero, zero)
    )
    albedo = load3(albedo_ref, pix, valid)
    opix = y * width + x
    for a in range(3):
        out = sums[a] / norm_sum
        plgpu.store(
            out_ref.at[opix * 3 + a],
            out * (1.0 - factor) + albedo[a] * out * factor,
            mask=valid,
        )


def denoise(
    colors: jnp.ndarray,  # (H, W, 3) temporally blended color
    normal: jnp.ndarray,  # (H, W, 3)
    depth: jnp.ndarray,  # (H, W)
    albedo: jnp.ndarray,  # (H, W, 3)
    material: jnp.ndarray,  # (H, W) int32 (top 8 bits compared)
    cam: tuple,  # origin, right, up, forward (pixel-scaled)
    params,  # DenoiseParams (traced sigmas / albedo factor)
    radius: int,  # static, >= 1
    row0=0,  # traced: first image row this call filters
    out_rows=None,  # static: rows filtered (default: the whole image)
    interpret: bool = False,
) -> jnp.ndarray:
    """Returns the (out_rows, W, 3) filtered, albedo-remodulated color
    of image rows ``row0 .. row0 + out_rows``."""
    height, width = depth.shape
    out_rows = height if out_rows is None else out_rows
    _, right, up, forward = cam
    fp = jnp.concatenate(
        [
            jnp.asarray(right, _F32).reshape(3),
            jnp.asarray(up, _F32).reshape(3),
            jnp.asarray(forward, _F32).reshape(3),
            jnp.stack(
                [
                    2.0 * jnp.asarray(params.sigma_distance, _F32) ** 2,
                    2.0 * jnp.asarray(params.sigma_range, _F32) ** 2,
                    jnp.asarray(params.albedo_factor, _F32),
                ]
            ),
        ]
    )
    ip = jnp.reshape(jnp.asarray(row0, _I32), (1,))
    kernel = functools.partial(
        _kernel, height=height, width=width, out_rows=out_rows,
        radius=int(radius),
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((out_rows * width * 3,), _F32),
        grid=(pl.cdiv(out_rows, BLOCK_H), pl.cdiv(width, BLOCK_W)),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        name="denoise_triton",
    )(
        fp, ip,
        jnp.reshape(colors, (-1,)), jnp.reshape(normal, (-1,)),
        jnp.reshape(depth, (-1,)), jnp.reshape(material, (-1,)),
        jnp.reshape(albedo, (-1,)),
    )
    return out.reshape(out_rows, width, 3)
