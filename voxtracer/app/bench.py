"""BASELINE measurement harness: the six configs of BASELINE.md.

Runs each config from BASELINE.md and prints one JSON line per config,
each naming the device it ran on.  Config 1 is the correctness gate
(the platform's trace kernel vs the NumPy oracle); configs 2-5 are
throughput; config 6 sweeps every shipped asset.  ``--quick`` limits
frame counts; ``--skip`` drops configs (e.g. the 4K stretch).

Run: ``python -m voxtracer.app.bench [--quick] [--skip 5]``
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..engine.camera import Camera
from ..engine.pipeline import Renderer, trace_sample
from ..utils.compile_cache import enable_compile_cache
from . import camera_paths
from .cli import load_scene


def _device():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def _emit(**kv):
    print(json.dumps(dict(kv, device=_device())), flush=True)


def _time_frames(renderer, cameras, full_out=True, per_frame=None):
    """Mean wall seconds per frame over ``cameras[1:]``.

    A warm pass over the whole camera sequence first compiles every
    jit variant it triggers (moving and still temporal paths).  Timing
    runs lean (the realtime output set) and ends in
    ``block_until_ready``; one full render afterwards supplies the
    G-buffer for post-analysis.  ``per_frame(i)`` lets a config mutate
    live parameters mid-sequence (config 5's animated sun)."""
    import jax

    def run(pass_cams, start):
        for i, cam in enumerate(pass_cams, start):
            if per_frame is not None:
                per_frame(i)
            out = renderer.render(cam, lean=True)
        jax.block_until_ready(out)

    run(cameras, 0)
    t0 = time.perf_counter()
    run(cameras[1:], 1)
    dt = (time.perf_counter() - t0) / max(1, len(cameras) - 1)
    out = renderer.render(cameras[-1], lean=not full_out)
    return dt, out


def _oracle_agreement(scene, cam, h, w, seed):
    """(node agreement, color PSNR dB) of the platform's trace kernel
    against the NumPy oracle on one shared-noise sample."""
    from ..engine.params import RenderParams
    from ..ops import noise as noise_op
    from ..oracle import renderer as oracle

    params = RenderParams()
    right, up, forward = cam.axis_scaled(w, h)
    buf = noise_op.white_noise_buffer(seed=seed)
    o = oracle.render_sample(
        scene.values, scene.origin.astype(np.int64),
        np.asarray(cam.position), right, up, forward,
        params, noise_op.noise_planes(buf, 1, h, w), w, h,
    )
    cam_arr = np.stack([cam.position, right, up, forward]).astype(np.float32)
    x = trace_sample(scene, cam_arr, params, buf, 1, h, w)
    agree = float((o["node"] == x["node"]).mean())
    err = (x["color"] - o["color"]).astype(np.float64)
    mse = float(np.mean(err**2))
    psnr = 10 * np.log10(
        max(1.0, float(o["color"].max())) ** 2 / max(mse, 1e-12)
    )
    return agree, psnr, x


def config1_oracle_match(quick=False):
    """8x8x8.vox, 256x256, 1 spp, static camera: trace kernel vs oracle."""
    scene = load_scene("8x8x8")
    size = 128 if quick else 256
    cam = Camera(
        position=np.array([2.0, 3.0, -4.0]),
        direction=np.array([0.2, 0.1, 1.0]),
    )
    agree, psnr, _ = _oracle_agreement(scene, cam, size, size, seed=7)
    _emit(
        config=1,
        name="8x8x8 oracle match",
        resolution=f"{size}x{size}",
        node_agreement=round(agree, 6),
        color_psnr_db=round(psnr, 2),
    )


def config2_menger(quick=False):
    scene = load_scene("menger")
    frames = 4 if quick else 10
    r = Renderer(scene=scene, height=720, width=1280)
    cam = Camera(
        position=np.array([36.0, 34.0, -5.0]),
        direction=np.array([-16.0, -14.0, 25.0]),
    )
    dt, _ = _time_frames(r, [cam] * (frames + 1))
    _emit(
        config=2,
        name="menger 720p progressive",
        ms_per_frame=round(dt * 1e3, 3),
        fps=round(1 / dt, 2),
    )


def config3_knight_temporal(quick=False):
    scene = load_scene("chr_knight")
    frames = 4 if quick else 10
    r = Renderer(scene=scene, height=720, width=1280)
    path = camera_paths.orbit(scene)
    cams = [path(i / 30.0) for i in range(frames + 1)]
    dt, out = _time_frames(r, cams)
    blend = np.asarray(r.state["accum_blend"])
    _emit(
        config=3,
        name="chr_knight 720p temporal reprojection (orbit)",
        ms_per_frame=round(dt * 1e3, 3),
        fps=round(1 / dt, 2),
        reprojection_accepted=round(float((blend < 1.0).mean()), 3),
    )


def config4_monu9_full(quick=False):
    import jax
    import jax.numpy as jnp
    from functools import partial

    from ..engine.params import DenoiseParams, TemporalParams
    from ..ops import denoise as denoise_op
    from ..ops import denoise_triton
    from ..ops import temporal as temporal_op
    from ..ops import tonemap as tonemap_op

    scene = load_scene("monu9")
    frames = 3 if quick else 8
    h, w = 1080, 1920
    r = Renderer(scene=scene, height=h, width=w, denoise_radius=2)
    path = camera_paths.dolly(scene)
    cams = [path(i / 30.0) for i in range(frames + 1)]
    dt, out = _time_frames(r, cams)

    # per-stage timings, each stage as its own jit (the reference has
    # no GPU timestamps at all — SURVEY §5)
    right, up, forward = cams[-1].axis_scaled(w, h)
    cam_t = tuple(
        jnp.asarray(v, jnp.float32)
        for v in (cams[-1].position, right, up, forward)
    )
    gN = jnp.asarray(out["normal"])
    gD = jnp.asarray(out["depth"])
    gA = jnp.asarray(out["albedo"])
    gC = jnp.asarray(out["trace_color"])
    gM = jnp.asarray(out["node"])

    def _t(fn, *args, n=5):
        jax.block_until_ready(fn(*args))
        t0 = time.perf_counter()
        for _ in range(n):
            res = fn(*args)
        jax.block_until_ready(res)
        return (time.perf_counter() - t0) / n

    # time the denoiser the pipeline selected for this device
    if r.trace_impl == "triton":
        den = jax.jit(lambda *a: denoise_triton.denoise(*a, 2))
    else:
        den = jax.jit(partial(denoise_op.denoise, radius=2))
    t_denoise = _t(den, gC, gN, gD, gA, gM, cam_t, DenoiseParams())
    tmp = jax.jit(partial(temporal_op.temporal_blend, reproject=True))
    t_temporal = _t(
        tmp, gC, gN, gD, gC, gD * 0 + 0.5, gD, cam_t, cam_t,
        TemporalParams(), jnp.asarray(True),
    )
    t_tone = _t(jax.jit(tonemap_op.to_u8), gC)

    _emit(
        config=4,
        name="monu9 1080p full pipeline (trace+temporal+denoise r=2)",
        ms_per_frame=round(dt * 1e3, 3),
        fps=round(1 / dt, 2),
        standalone_stage_ms_incl_dispatch={
            "temporal_reproject": round(t_temporal * 1e3, 3),
            "denoise_r2": round(t_denoise * 1e3, 3),
            "tonemap_u8": round(t_tone * 1e3, 3),
        },
    )


def config5_castle_4k(quick=False):
    import dataclasses

    scene = load_scene("castle")
    frames = 2 if quick else 4
    r = Renderer(scene=scene, height=2160, width=3840)
    cam = camera_paths.static(scene)(0.0)
    cams = [cam] * (frames + 1)

    def sun_sweep(i):
        # animated sun: yaw sweeps while the camera holds still
        # (params are traced jit args — the sweep must not recompile)
        r.render_params = dataclasses.replace(
            r.render_params, sun_yaw=1.32 + 0.05 * i
        )

    dt, _ = _time_frames(r, cams, per_frame=sun_sweep)
    _emit(
        config=5,
        name="castle 4K animated sun (stretch)",
        ms_per_frame=round(dt * 1e3, 3),
        fps=round(1 / dt, 3),
    )


def config6_asset_sweep(quick=False):
    """Every shipped .vox asset through the full pipeline: one JSON
    line per asset with fps, iteration-fuse pixel count and node
    agreement vs the oracle on a small crop (a regression net for
    kernel changes across the whole asset set)."""
    import glob
    import os

    from ..ops import trace_xla

    here = os.path.dirname(os.path.abspath(__file__))
    vox_dir = os.path.join(here, "..", "..", "assets", "vox")
    names = sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(vox_dir, "*.vox"))
    )
    h, w = (180, 320) if quick else (360, 640)
    ch, cw = 72, 128  # oracle-agreement crop
    frames = 2 if quick else 5
    for name in names:
        scene = load_scene(name)
        path = camera_paths.orbit(scene)
        cam = path(0.15)
        r = Renderer(scene=scene, height=h, width=w)
        dt, out = _time_frames(r, [cam] * (frames + 2))
        node = np.asarray(out["node"])
        fuse_px = int((node == trace_xla.LEAF_BIT).sum())
        agree, _, _ = _oracle_agreement(scene, cam, ch, cw, seed=3)
        _emit(
            config=6,
            name=f"asset sweep: {name}",
            resolution=f"{w}x{h}",
            ms_per_frame=round(dt * 1e3, 3),
            fps=round(1 / dt, 2),
            fuse_pixels=fuse_px,
            node_agreement=round(agree, 5),
        )


CONFIGS = {
    1: config1_oracle_match,
    2: config2_menger,
    3: config3_knight_temporal,
    4: config4_monu9_full,
    5: config5_castle_4k,
    6: config6_asset_sweep,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip", type=int, nargs="*", default=[])
    p.add_argument("--only", type=int, nargs="*", default=None)
    args = p.parse_args(argv)
    enable_compile_cache()
    failed = 0
    for idx, fn in CONFIGS.items():
        if idx in args.skip or (args.only and idx not in args.only):
            continue
        try:
            fn(quick=args.quick)
        except Exception as e:  # report, keep measuring the rest
            failed += 1
            _emit(config=idx, error=repr(e)[:400])
    return 1 if failed else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
