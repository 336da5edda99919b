"""Checkpoint / resume for progressive renders.

The reference has no persistence at all (SURVEY §5: camera, uniforms
and accumulation are ephemeral).  Headless progressive rendering makes
resumability cheap and useful: a snapshot captures the accumulation
state, camera pose, frame counters and all render parameters, so a
long-converging frame can continue across sessions.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from .camera import Camera
from .params import DenoiseParams, RenderParams, TemporalParams
from .pipeline import Renderer

FORMAT_VERSION = 2
_KNOWN_VERSIONS = (1, 2)  # v1 predates the scene-identity hash


def scene_hash(scene) -> str:
    """Stable identity of a scene's geometry + colors: digest of the
    dense grid values, origin and dims.  Accumulated history is only
    meaningful against the scene it was rendered from — resuming menger
    accumulation onto castle would silently blend mismatched history.
    """
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(scene.values.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(scene.origin).tobytes())
    h.update(np.ascontiguousarray(scene.values).tobytes())
    return h.hexdigest()


def save(path: str | os.PathLike, renderer: Renderer, camera: Camera):
    meta = {
        "version": FORMAT_VERSION,
        "scene_hash": scene_hash(renderer.scene),
        "height": renderer.height,
        "width": renderer.width,
        "frame_number": renderer.frame_number,
        "still_sample": renderer.still_sample,
        "denoise_radius": renderer.denoise_radius,
        "trace_impl": renderer.trace_impl,
        "render_params": dataclasses.asdict(renderer.render_params),
        "temporal_params": dataclasses.asdict(renderer.temporal_params),
        "denoise_params": dataclasses.asdict(renderer.denoise_params),
        "camera_position": list(map(float, camera.position)),
        "camera_direction": list(map(float, camera.direction)),
        "camera_fov": camera.fov,
    }
    arrays = {k: np.asarray(v) for k, v in renderer.state.items()}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load(path: str | os.PathLike, renderer: Renderer) -> Camera:
    """Restore state into ``renderer`` (scene must already be set);
    returns the snapshotted camera."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] not in _KNOWN_VERSIONS:
        raise ValueError(f"unsupported snapshot version {meta['version']}")
    if "scene_hash" in meta:
        live = scene_hash(renderer.scene)
        if meta["scene_hash"] != live:
            raise ValueError(
                "snapshot scene mismatch: it was written against a "
                f"different scene (snapshot {meta['scene_hash'][:12]}…, "
                f"live {live[:12]}…) — resuming would blend accumulated "
                "history from one scene onto another; load the matching "
                "scene first"
            )
    else:
        import logging

        logging.getLogger("voxtracer.engine.snapshot").warning(
            "v1 snapshot carries no scene identity; cannot verify it "
            "matches the live scene"
        )
    if (meta["height"], meta["width"]) != (renderer.height, renderer.width):
        raise ValueError(
            "snapshot resolution mismatch: "
            f"{meta['height']}x{meta['width']} vs "
            f"{renderer.height}x{renderer.width}"
        )
    loaded = {k: np.asarray(data[k]) for k in renderer.state}
    if loaded["accum_color"].shape[-1] == 3:
        # pre-planar snapshot (accum_color was channels-last (H, W, 3);
        # the live state is planar (3, H, W)) — migrate on load
        loaded["accum_color"] = np.moveaxis(loaded["accum_color"], -1, 0)
    renderer.state = {k: jnp.asarray(v) for k, v in loaded.items()}
    renderer.frame_number = int(meta["frame_number"])
    renderer.still_sample = int(meta["still_sample"])
    renderer.denoise_radius = int(meta["denoise_radius"])
    if meta["trace_impl"] != renderer.trace_impl:
        # trace_impl is platform-selected (triton on GPU, xla on CPU);
        # keep the live choice but surface the divergence.
        import logging

        logging.getLogger("voxtracer.engine.snapshot").warning(
            "snapshot was written with trace_impl=%r; resuming with %r",
            meta["trace_impl"],
            renderer.trace_impl,
        )
    renderer.render_params = RenderParams(**meta["render_params"])
    renderer.temporal_params = TemporalParams(**meta["temporal_params"])
    renderer.denoise_params = DenoiseParams(**meta["denoise_params"])
    cam = Camera(
        position=np.array(meta["camera_position"]),
        direction=np.array(meta["camera_direction"]),
        fov=meta["camera_fov"],
    )
    # history continues seamlessly only if the camera is unchanged;
    # mark it as the renderer's last pose
    right, up, forward = cam.axis_scaled(renderer.width, renderer.height)
    renderer._last_cam = np.stack(
        [np.asarray(cam.position), right, up, forward]
    ).astype(np.float32)
    # sync the host mirror the batch paths read (the restored device
    # state carries the authoritative flag)
    renderer._history_valid = bool(np.asarray(data["history_valid"]))
    return cam
