"""Render parameter pytrees — the uniform ABI, reborn as jit arguments.

Mirrors the reference's uniform structs and defaults:
``Uniforms`` (``src/context.rs:425-498``), ``TemporalUniforms``
(``:502-525``) and ``DenoiseUniforms`` (``:304-325``).  Instead of
hand-packed GPU buffers these are dataclass pytrees whose leaves flow
into the jitted frame function as traced scalars, so parameter changes
never retrace.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda obj: (
            tuple(getattr(obj, name) for name in fields),
            None,
        ),
        lambda _, leaves: cls(**dict(zip(fields, leaves))),
    )
    return cls


@_pytree_dataclass
class RenderParams:
    """Lighting / material parameters of the path tracer."""

    emit_strength: float = 4.0
    sun_strength: float = 4.0
    sun_size: float = 0.05
    sun_yaw: float = 1.32
    sun_pitch: float = 1.0
    sun_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    sky_color: Tuple[float, float, float] = (0.45, 0.6, 0.65)
    specularity: float = 0.0


@_pytree_dataclass
class TemporalParams:
    """Temporal reprojection blending parameters."""

    sample_blending: float = 0.5
    maximum_blending: float = 0.98
    blending_distance_cutoff: float = 1e-2


@_pytree_dataclass
class DenoiseParams:
    """Cross-bilateral denoiser parameters.

    ``radius`` is a *static* structural parameter (it fixes the stencil
    footprint, so changing it recompiles); the sigmas and albedo factor
    are traced.
    """

    sigma_distance: float = 2.0
    sigma_range: float = 1.5
    albedo_factor: float = 1.0


DENOISE_RADIUS_DEFAULT = 0  # src/context.rs:316-325


# -- packed per-frame inputs ------------------------------------------
#
# The frame function's dynamic inputs (camera basis + all three param
# pytrees + frame number) are ~30 scalars.  Passed as separate jit
# args they become ~6 separate host->device transfers per frame, so the
# Renderer ships ONE (1, 32) f32 vector and the jitted wrapper unpacks
# it into traced scalars; parameter changes still never retrace.
#
# Layout: 0-11 cam rows (origin, right, up, forward(pixel-scaled)) |
# 12-23 RenderParams (field order below) | 24-26 TemporalParams |
# 27-29 DenoiseParams | 30 frame_number (int32 BITS carried in the
# f32 lane via bitcast — a value cast would silently collapse
# consecutive frame numbers past 2**24, ~2 days of a live viewer,
# repeating noise planes) | 31 pad.
PACKED_LEN = 32


def pack_frame_inputs(cam, rp, tp, dp, frame_number):
    """Host-side: one (1, PACKED_LEN) float32 vector for the frame."""
    import numpy as np

    v = np.zeros((1, PACKED_LEN), np.float32)
    v[0, 0:12] = np.asarray(cam, np.float32).reshape(12)
    v[0, 12] = rp.emit_strength
    v[0, 13] = rp.sun_strength
    v[0, 14] = rp.sun_size
    v[0, 15] = rp.sun_yaw
    v[0, 16] = rp.sun_pitch
    v[0, 17:20] = rp.sun_color
    v[0, 20:23] = rp.sky_color
    v[0, 23] = rp.specularity
    v[0, 24] = tp.sample_blending
    v[0, 25] = tp.maximum_blending
    v[0, 26] = tp.blending_distance_cutoff
    v[0, 27] = dp.sigma_distance
    v[0, 28] = dp.sigma_range
    v[0, 29] = dp.albedo_factor
    v.view(np.int32)[0, 30] = int(frame_number)
    return v


def unpack_frame_inputs(vec):
    """Traced: rebuild (cam, RenderParams, TemporalParams,
    DenoiseParams, frame_number) from the (1, PACKED_LEN) vector."""
    cam = vec[0, 0:12].reshape(4, 3)
    rp = RenderParams(
        emit_strength=vec[0, 12],
        sun_strength=vec[0, 13],
        sun_size=vec[0, 14],
        sun_yaw=vec[0, 15],
        sun_pitch=vec[0, 16],
        sun_color=(vec[0, 17], vec[0, 18], vec[0, 19]),
        sky_color=(vec[0, 20], vec[0, 21], vec[0, 22]),
        specularity=vec[0, 23],
    )
    tp = TemporalParams(
        sample_blending=vec[0, 24],
        maximum_blending=vec[0, 25],
        blending_distance_cutoff=vec[0, 26],
    )
    dp = DenoiseParams(
        sigma_distance=vec[0, 27],
        sigma_range=vec[0, 28],
        albedo_factor=vec[0, 29],
    )
    frame_number = jax.lax.bitcast_convert_type(
        vec[0, 30], jax.numpy.int32
    )
    return cam, rp, tp, dp, frame_number


# Note on the reference's PointLight uniform (src/context.rs:527-534):
# it is only consumed by the legacy Whitted-style fragment shader
# (shaders/basic.frag), which no pipeline ever dispatches — the loaded
# display shaders are basic.vert + display.frag (src/context.rs:1364).
# It is therefore vestigial and intentionally not part of RenderParams.
