"""Packed per-frame input vector: exact roundtrip.

The Renderer ships every dynamic scalar input in ONE (1, 32) f32
vector (engine/params.pack_frame_inputs) to avoid ~6 small
host->device copies per frame; these pin the contract — values
roundtrip exactly, and the frame number rides as int32 BITS (a value
cast would silently collapse consecutive frames past 2**24, ~2 days
of a live viewer, repeating noise planes).
"""

import numpy as np

from voxtracer.engine.params import (
    DenoiseParams,
    RenderParams,
    TemporalParams,
    pack_frame_inputs,
    unpack_frame_inputs,
)


def _roundtrip(frame_number):
    cam = np.arange(12, dtype=np.float32).reshape(4, 3) / 7.0
    rp = RenderParams(
        emit_strength=3.25, sun_strength=1.5, sun_size=0.125,
        sun_yaw=0.75, sun_pitch=0.5, sun_color=(0.25, 0.5, 0.75),
        sky_color=(0.1, 0.2, 0.3), specularity=0.375,
    )
    tp = TemporalParams(
        sample_blending=0.625, maximum_blending=0.9375,
        blending_distance_cutoff=0.03125,
    )
    dp = DenoiseParams(
        sigma_distance=2.5, sigma_range=1.25, albedo_factor=0.875
    )
    vec = pack_frame_inputs(cam, rp, tp, dp, frame_number)
    cam2, rp2, tp2, dp2, fn2 = unpack_frame_inputs(vec)
    np.testing.assert_array_equal(np.asarray(cam2), cam)
    for a, b in ((rp, rp2), (tp, tp2), (dp, dp2)):
        import jax

        for la, lb in zip(
            jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        ):
            # the packed lane is f32 — the same precision the
            # reference's uniform buffers carry (src/context.rs:425)
            assert np.float32(la) == np.float32(np.asarray(lb)), (la, lb)
    assert int(np.asarray(fn2)) == frame_number


def test_packed_roundtrip_exact():
    _roundtrip(7)


def test_frame_number_survives_past_f32_precision():
    # 2**24 + 1 is NOT representable in f32; the bitcast lane must
    # still return it exactly (and distinguish it from 2**24)
    _roundtrip(2**24 + 1)
    _roundtrip(2**24)
    _roundtrip(2**31 - 1)
