"""Scan-batched sequence/burst rendering.

``Renderer.render_sequence`` runs N frames in ONE device dispatch
(``lax.scan`` over the packed per-frame input rows).  It must advance
the accumulation state and produce frames exactly as N sequential
``render()`` calls would — the batched path is a dispatch optimization,
never a semantic fork.
"""

import numpy as np
import pytest

from voxtracer.engine.camera import Camera
from voxtracer.engine.pipeline import Renderer
from voxtracer.scene import GridScene, VoxelList, default_scene


def _tiny_scene():
    vl = VoxelList(
        pos=np.array([[0, 0, 0], [1, 1, 1]], dtype=np.int16),
        mrgb=np.array([[0, 200, 0, 0], [0, 0, 200, 0]], dtype=np.uint8),
    )
    return GridScene.from_voxels(vl)


def _orbit_cams(n):
    cams = []
    for i in range(n):
        a = 0.3 * i
        cams.append(
            Camera(
                position=np.array(
                    [4.0 * np.sin(a), 1.5, -4.0 * np.cos(a)]
                ),
                direction=np.array(
                    [-np.sin(a), -0.3, np.cos(a)]
                ),
            )
        )
    return cams


def _pair(scene, **kw):
    a = Renderer(scene=scene, height=16, width=16, **kw)
    b = Renderer(scene=scene, height=16, width=16, **kw)
    return a, b


@pytest.mark.slow
def test_burst_matches_sequential_still():
    """A fresh-state static burst == N sequential still renders."""
    scene = _tiny_scene()
    seq, bat = _pair(scene, trace_impl="xla", denoise_radius=1)
    cam = Camera(position=np.array([0.3, 0.2, -2.0]))

    outs = [np.asarray(seq.render(cam)["image"]) for _ in range(4)]
    frames = np.asarray(bat.render_sequence([cam] * 4))

    assert frames.shape == (4, 16, 16, 3)
    for i in range(4):
        np.testing.assert_array_equal(frames[i], outs[i])
    assert bat.frame_number == seq.frame_number == 4
    assert bat.still_sample == seq.still_sample
    for k in seq.state:
        np.testing.assert_array_equal(
            np.asarray(seq.state[k]), np.asarray(bat.state[k])
        )
    # a follow-up realtime frame continues identically
    np.testing.assert_array_equal(
        np.asarray(seq.render(cam)["image"]),
        np.asarray(bat.render(cam)["image"]),
    )


def test_sequence_matches_sequential_motion():
    """An every-frame-moving orbit == N sequential renders (the
    reproject=True path end to end, XLA trace kernel)."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    seq = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    bat = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    cams = _orbit_cams(5)

    outs = []
    for c in cams:
        outs.append(np.asarray(seq.render(c)["image"]))
    frames = np.asarray(bat.render_sequence(cams))

    for i in range(5):
        np.testing.assert_array_equal(frames[i], outs[i])
    for k in seq.state:
        np.testing.assert_array_equal(
            np.asarray(seq.state[k]), np.asarray(bat.state[k])
        )


@pytest.mark.slow
def test_mixed_still_and_motion_sequence_matches_sequential():
    """A path mixing stills with pans splits into per-segment
    sub-scans (static reproject each) and stays bit-identical to the
    per-frame render() loop — still frames keep the cheap elementwise
    blend (ADVICE r3; VERDICT r3 next #7)."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    seq = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    bat = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    orbit = _orbit_cams(3)
    # still, still, pan, pan, still, still, pan
    cams = [orbit[0], orbit[0], orbit[1], orbit[2], orbit[2],
            orbit[2], orbit[0]]

    outs = [np.asarray(seq.render(c)["image"]) for c in cams]
    frames = np.asarray(bat.render_sequence(cams))

    assert frames.shape[0] == len(cams)
    for i in range(len(cams)):
        np.testing.assert_array_equal(frames[i], outs[i])
    for k in seq.state:
        np.testing.assert_array_equal(
            np.asarray(seq.state[k]), np.asarray(bat.state[k])
        )
    assert bat.frame_number == seq.frame_number
    assert bat.still_sample == seq.still_sample


def test_segment_rle():
    segs = Renderer._segments([False, False, True, True, False, True])
    assert segs == [(0, 2, False), (2, 4, True), (4, 5, False),
                    (5, 6, True)]
    assert Renderer._segments([True]) == [(0, 1, True)]


def test_burst_returns_final_frame():
    scene = _tiny_scene()
    r = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    cam = Camera(position=np.array([0.3, 0.2, -2.0]))
    final = np.asarray(r.render_burst(cam, 3))

    r2 = Renderer(scene=scene, height=16, width=16, trace_impl="xla")
    for _ in range(3):
        out = r2.render(cam)
    np.testing.assert_array_equal(final, np.asarray(out["image"]))


def test_sequence_after_realtime_frames_continues_accumulation():
    """A batch appended to live realtime history consumes the existing
    state (history_valid rides in the carried state)."""
    scene = _tiny_scene()
    seq, bat = _pair(scene, trace_impl="xla")
    cam = Camera(position=np.array([0.3, 0.2, -2.0]))

    for r in (seq, bat):
        r.render(cam)
        r.render(cam)
    outs = [np.asarray(seq.render(cam)["image"]) for _ in range(3)]
    frames = np.asarray(bat.render_sequence([cam] * 3))
    for i in range(3):
        np.testing.assert_array_equal(frames[i], outs[i])
    assert bat.frame_number == seq.frame_number == 5


@pytest.mark.slow
def test_sequence_triton_matches_sequential():
    """Same invariance through the Triton trace kernel (interpreter)."""
    scene = GridScene.from_voxels(default_scene(radius=6, seed=3))
    kw = dict(height=16, width=32, trace_impl="triton", denoise_radius=1)
    seq = Renderer(scene=scene, **kw)
    bat = Renderer(scene=scene, **kw)
    cams = _orbit_cams(3)
    outs = [np.asarray(seq.render(c)["image"]) for c in cams]
    frames = np.asarray(bat.render_sequence(cams))
    for i in range(3):
        np.testing.assert_array_equal(frames[i], outs[i])


def test_empty_sequence_rejected():
    r = Renderer(scene=_tiny_scene(), height=16, width=16,
                 trace_impl="xla")
    with pytest.raises(ValueError, match="at least one"):
        r.render_sequence([])
