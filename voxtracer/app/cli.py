"""Headless render CLI — the app shell.

Where the reference boots a winit window and an egui debug panel
(``src/main.rs``, ``src/context.rs:1692-1827``), a headless accelerator
renders to files: every live GUI parameter is a flag with the same
name, default and range (SURVEY §5 "config/flag system"); scenes come
from the same ``vox/`` assets or the procedural default; camera motion
comes from scripted paths or an explicit pose.

Examples:
  python -m voxtracer.app.cli --scene menger --frames 32 -o out.png
  python -m voxtracer.app.cli --scene assets/vox/monu9.vox \\
      --size 1920x1080 --path orbit --frames 120 --video-dir frames/ \\
      --denoise-radius 2
  python -m voxtracer.app.cli --scene default --list-scenes
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
import time

import numpy as np

from ..engine.camera import Camera
from ..engine.params import DenoiseParams, RenderParams, TemporalParams
from ..engine.pipeline import Renderer
from ..engine.reload import KernelWatcher
from ..engine import snapshot as snapshot_mod
from ..io import vox as voxio
from ..io.image import write_png
from ..scene import GridScene, default_scene, voxels_from_vox
from ..utils import FpsCounter, StageTimer, setup_logging
from ..utils.compile_cache import enable_compile_cache
from . import camera_paths

log = logging.getLogger("voxtracer.app")

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "vox",
)


def available_scenes():
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(ASSET_DIR, "*.vox"))
    )


def load_scene(name: str) -> GridScene:
    if name == "default":
        return GridScene.from_voxels(default_scene())
    if os.path.exists(name):
        path = name
    else:
        path = os.path.join(ASSET_DIR, name + ".vox")
        if not os.path.exists(path):
            raise SystemExit(
                f"unknown scene {name!r}; available: "
                f"{', '.join(['default'] + available_scenes())}"
            )
    return GridScene.from_voxels(voxels_from_vox(voxio.load(path)))


def load_voxels(name: str):
    """The raw voxel list for a scene name (the legacy Whitted renderer
    consumes the pointer octree, not the dense grid)."""
    if name == "default":
        return default_scene()
    path = name if os.path.exists(name) else os.path.join(ASSET_DIR, name + ".vox")
    return voxels_from_vox(voxio.load(path))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxtracer", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--scene", default="default",
                   help="scene name from assets/vox, a .vox path, or 'default'")
    p.add_argument("--list-scenes", action="store_true")
    p.add_argument("--size", default="1280x720", help="WIDTHxHEIGHT")
    p.add_argument("--frames", type=int, default=16,
                   help="frames to accumulate/render")
    p.add_argument("--batch", type=int, default=1,
                   help="render frames in scanned device batches of this "
                        "size (ONE dispatch per batch via lax.scan) — the "
                        "offline/export mode; 1 = realtime per-frame loop")
    p.add_argument("-o", "--output", default="frame.png",
                   help="output PNG for the final frame")
    p.add_argument("--video-dir", default=None,
                   help="also write every frame as PNG into this directory")
    p.add_argument("--path", default="static",
                   choices=sorted(camera_paths.PATHS),
                   help="scripted camera path")
    p.add_argument("--fps-target", type=float, default=30.0,
                   help="camera-path playback rate (frames advance 1/fps)")
    p.add_argument("--camera-pos", default=None,
                   help="explicit camera position 'x,y,z' (overrides --path)")
    p.add_argument("--camera-dir", default=None,
                   help="explicit camera direction 'x,y,z'")
    p.add_argument("--fov", type=float, default=70.0, help="degrees")
    p.add_argument("--trace-impl", default=None,
                   choices=["triton", "xla"],
                   help="trace kernel (default: triton on GPU, xla on CPU)")
    p.add_argument("--noise", default="blue", choices=["blue", "white"],
                   help="RNG source (blue bakes/loads the noise asset)")

    scene_g = p.add_argument_group("scene / lighting (GUI parity)")
    scene_g.add_argument("--sun-strength", type=float, default=4.0,
                         help="0..10")
    scene_g.add_argument("--sun-size", type=float, default=0.05, help="0..1")
    scene_g.add_argument("--sun-yaw", type=float, default=None,
                         help="degrees 0..360 (default 75.6)")
    scene_g.add_argument("--sun-pitch", type=float, default=None,
                         help="degrees -90..90 (default 57.3)")
    scene_g.add_argument("--sun-color", default="1,1,1")
    scene_g.add_argument("--sky-color", default="0.45,0.6,0.65")
    scene_g.add_argument("--emit-strength", type=float, default=4.0,
                         help="0..40")
    scene_g.add_argument("--specularity", type=float, default=0.0,
                         help="0..1")

    ren_g = p.add_argument_group("renderer (GUI parity)")
    ren_g.add_argument("--temporal-factor", type=float, default=0.5,
                       help="sample blending 0..1")
    ren_g.add_argument("--temporal-max", type=float, default=0.98,
                       help="maximum blending 0..1")
    ren_g.add_argument("--temporal-cutoff", type=float, default=1e-2,
                       help="blending distance cutoff (log scale 0..1)")
    ren_g.add_argument("--denoise-radius", type=int, default=0,
                       help="0..8")
    ren_g.add_argument("--sigma-distance", type=float, default=2.0,
                       help="0.1..5")
    ren_g.add_argument("--sigma-range", type=float, default=1.5,
                       help="0.1..5")
    ren_g.add_argument("--albedo", type=float, default=1.0,
                       help="albedo composition factor 0..1")

    io_g = p.add_argument_group("session")
    io_g.add_argument("--save-snapshot", default=None,
                      help="write a resumable snapshot (.npz) at the end")
    io_g.add_argument("--resume", default=None,
                      help="resume accumulation from a snapshot")
    io_g.add_argument("--legacy-whitted", action="store_true",
                      help="render one still with the legacy sorted-octant "
                           "Whitted raytracer (reference shaders/basic.frag) "
                           "instead of the path tracer")
    io_g.add_argument("--light", default="0.4,-0.4,0.02,0.05",
                      help="point light x,y,z,brightness for --legacy-whitted "
                           "(reference src/context.rs:944-947 defaults)")
    io_g.add_argument("--watch-kernels", action="store_true",
                      help="hot-reload kernel modules on source change")
    io_g.add_argument("--stats", action="store_true",
                      help="print per-stage timing at the end")
    io_g.add_argument("--profile", default=None, metavar="DIR",
                      help="capture a jax.profiler (perfetto) trace of the "
                           "render loop into DIR")
    return p


def _parse_vec(text):
    return tuple(float(v) for v in text.split(","))


def make_params(args) -> RenderParams:
    kwargs = dict(
        emit_strength=args.emit_strength,
        sun_strength=args.sun_strength,
        sun_size=args.sun_size,
        sun_color=_parse_vec(args.sun_color),
        sky_color=_parse_vec(args.sky_color),
        specularity=args.specularity,
    )
    if args.sun_yaw is not None:
        kwargs["sun_yaw"] = np.radians(args.sun_yaw)
    if args.sun_pitch is not None:
        kwargs["sun_pitch"] = np.radians(args.sun_pitch)
    return RenderParams(**kwargs)


def _ready(out):
    """--stats timing waits for the device result."""
    import jax

    return jax.block_until_ready(out)


def main(argv=None) -> int:
    setup_logging()
    args = build_parser().parse_args(argv)
    enable_compile_cache()

    if args.list_scenes:
        print("\n".join(["default"] + available_scenes()))
        return 0

    width, height = (int(v) for v in args.size.lower().split("x"))
    scene = load_scene(args.scene)
    log.info(
        "scene %s: grid %s, %.1f%% occupied",
        args.scene,
        scene.values.shape,
        100 * (scene.values != 0).mean(),
    )

    if args.legacy_whitted:
        # The legacy renderer is a per-ray pointer-chasing stack machine
        # over the sparse octree; it exists for reference parity and
        # octree debugging.
        from ..ops.whitted import render_scene as render_whitted_scene

        if args.camera_pos is not None:
            direction = (
                _parse_vec(args.camera_dir) if args.camera_dir else (0, 0, 1)
            )
            camera = Camera(
                position=np.array(_parse_vec(args.camera_pos)),
                direction=np.array(direction),
                fov=np.radians(args.fov),
            )
        else:
            camera = camera_paths.PATHS[args.path](scene)(0.0)
        *light_pos, light_brightness = _parse_vec(args.light)
        t0 = time.perf_counter()
        img = np.asarray(
            render_whitted_scene(
                load_voxels(args.scene), camera, width, height,
                light_pos=tuple(light_pos), light_brightness=light_brightness,
            )
        )
        write_png(args.output, np.clip(img * 255.0, 0, 255).astype(np.uint8))
        print(
            f"legacy whitted still at {width}x{height} in "
            f"{time.perf_counter() - t0:.2f}s -> {args.output}"
        )
        return 0

    noise_buffer = None
    if args.noise == "blue":
        from ..ops.bluenoise import cached_buffer

        noise_buffer = cached_buffer()

    renderer = Renderer(
        scene=scene,
        height=height,
        width=width,
        render_params=make_params(args),
        temporal_params=TemporalParams(
            sample_blending=args.temporal_factor,
            maximum_blending=args.temporal_max,
            blending_distance_cutoff=args.temporal_cutoff,
        ),
        denoise_params=DenoiseParams(
            sigma_distance=args.sigma_distance,
            sigma_range=args.sigma_range,
            albedo_factor=args.albedo,
        ),
        denoise_radius=args.denoise_radius,
        noise_buffer=noise_buffer,
        trace_impl=args.trace_impl,
        lean=True,
    )

    fixed_cam = None
    if args.camera_pos is not None:
        direction = (
            _parse_vec(args.camera_dir) if args.camera_dir else (0, 0, 1)
        )
        fixed_cam = Camera(
            position=np.array(_parse_vec(args.camera_pos)),
            direction=np.array(direction),
            fov=np.radians(args.fov),
        )
    path = camera_paths.PATHS[args.path](scene)

    start_frame = 0
    if args.resume:
        fixed_cam = snapshot_mod.load(args.resume, renderer)
        start_frame = renderer.frame_number
        log.info("resumed at frame %d", start_frame)

    if args.video_dir:
        os.makedirs(args.video_dir, exist_ok=True)

    watcher = KernelWatcher() if args.watch_kernels else None
    fps = FpsCounter()
    timer = StageTimer()
    out = None
    camera = fixed_cam
    profiler_ctx = None
    if args.profile:
        import jax

        os.makedirs(args.profile, exist_ok=True)
        jax.profiler.start_trace(args.profile)
    t_start = time.perf_counter()
    batched = 0
    if args.batch > 1:
        # Offline/export mode: the frame loop runs ON DEVICE as a
        # lax.scan over packed per-frame inputs — one dispatch per
        # batch instead of per frame.  The remainder (< batch frames)
        # falls through to the realtime loop below so it never
        # compiles a second scan length.
        while args.frames - batched >= args.batch:
            if watcher is not None:
                watcher.poll()
            cams = [
                fixed_cam
                if fixed_cam is not None
                else path((start_frame + batched + j) / args.fps_target)
                for j in range(args.batch)
            ]
            frames_u8 = timer.measure(
                "batch", renderer.render_sequence, cams,
                sync=_ready if args.stats else None,
            )
            camera = cams[-1]
            for _ in range(args.batch):
                fps.tick()
            if args.video_dir:
                for j, img in enumerate(np.asarray(frames_u8)):
                    write_png(
                        os.path.join(
                            args.video_dir,
                            f"frame_{start_frame + batched + j:05d}.png",
                        ),
                        img,
                    )
            out = {"image": frames_u8[-1]}
            batched += args.batch
    for i in range(batched, args.frames):
        if watcher is not None:
            watcher.poll()
        if fixed_cam is None:
            camera = path((start_frame + i) / args.fps_target)
        # Per-frame device syncs are only taken under --stats: waiting
        # on every frame caps the dispatch pipeline at one frame of
        # lookahead.
        out = timer.measure(
            "frame", renderer.render, camera,
            sync=_ready if args.stats else None,
        )
        fps.tick()
        if args.video_dir:
            write_png(
                os.path.join(
                    args.video_dir, f"frame_{start_frame + i:05d}.png"
                ),
                np.asarray(out["image"]),
            )
    wall = time.perf_counter() - t_start
    if args.profile:
        import jax

        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", args.profile)

    write_png(args.output, np.asarray(out["image"]))
    print(
        f"rendered {args.frames} frames at {width}x{height} in {wall:.2f}s "
        f"({args.frames / wall:.2f} fps, kernel={renderer.trace_impl}) "
        f"-> {args.output}"
    )

    if args.save_snapshot:
        snapshot_mod.save(args.save_snapshot, renderer, camera)
        log.info("snapshot saved to %s", args.save_snapshot)

    if args.stats:
        for name, avg in timer.report().items():
            print(f"  stage {name}: {avg * 1e3:.2f} ms avg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
