"""Smoke run of the whole frame pipeline on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # only the row-sharded frame on 4 cards

One process owns the card(s).  Phases, each of which must pass:

* device: JAX platform, device kind and count, and the card's name and
  power limit from ``nvidia-smi``; anything but a GPU fails.
* compile: the frame function at each real size, with
  ``compiled.memory_analysis()``.
* parity (tolerances in ``voxtracer/parity.py``): the Triton trace
  kernel vs the NumPy oracle (8x8x8.vox, 256x256) and vs the XLA trace
  (menger, 1280x720); the XLA denoise at r=2 and r=8 vs a float64 NumPy
  stencil at 1920x1080.
* end to end through ``Renderer``: menger 1280x720 on an orbit with
  reprojection and denoise r=2, monu9 1920x1080 full pipeline, castle
  3840x2160 with an animated sun, a still burst via ``render_burst``,
  and ``voxtracer.app.cli`` writing a PNG.  Frames must be finite and
  not blank.
* kernel decisions: in-frame ms/frame of the Triton trace vs the XLA
  trace, and of the temporal and denoise stages toggled inside the
  frame.
* the card's test lane (``tests/test_gpu.py``), in-process.

Timings are informational and printed beside the card's name and power
limit.  The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
a failed phase exits non-zero without it.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_name_and_power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi unavailable: {e}")
    return out.stdout.strip().splitlines()[0]


def run_phase(name, fn):
    t0 = time.perf_counter()
    try:
        result = fn()
    except Exception:
        traceback.print_exc()
        fail(f"phase {name!r} raised")
    print(
        f"[{name}] done in {time.perf_counter() - t0:.1f} s", flush=True
    )
    return result


def frame_ms(renderer, cams, warm=2):
    """Median wall ms of the whole frame function, one frame at a time
    (``block_until_ready`` after each)."""
    import jax

    for cam in cams[:warm]:
        jax.block_until_ready(renderer.render(cam, lean=True))
    times = []
    for cam in cams[warm:]:
        t0 = time.perf_counter()
        jax.block_until_ready(renderer.render(cam, lean=True))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def check_image(img, what):
    img = np.asarray(img)
    if not np.isfinite(img.astype(np.float64)).all():
        raise AssertionError(f"{what}: non-finite pixels")
    if img.astype(np.float64).std() < 1.0:
        raise AssertionError(f"{what}: blank image (std {img.std():.3f})")


# -- one card ---------------------------------------------------------------

# Sizes of the parity and decision phases: (width, height)
ORACLE_SIZE = (256, 256)
TRACE_PARITY_SIZE = (1280, 720)
DENOISE_SIZE = (1920, 1080)
DECISION_SIZES = (("menger_720p", "menger", 1280, 720),
                  ("monu9_1080p", "monu9", 1920, 1080))
BURST = ("menger", 1280, 720, 2, 16)  # scene, width, height, radius, passes
SHARDED_SIZE = (720, 1280, 2)  # height, width, denoise radius

# (label, scene, width, height, denoise radius, camera path)
SIZES = (
    ("menger_720p", "menger", 1280, 720, 2, "orbit"),
    ("monu9_1080p", "monu9", 1920, 1080, 2, "dolly"),
    ("castle_4k", "castle", 3840, 2160, 0, "static"),
)


def make_renderer(scene, width, height, radius, **kw):
    from voxtracer.engine.pipeline import Renderer

    return Renderer(scene=scene, height=height, width=width,
                    denoise_radius=radius, lean=True, **kw)


def path_cams(scene, path, n):
    from voxtracer.app import camera_paths

    p = camera_paths.PATHS[path](scene)
    return [p(i / 30.0) for i in range(n)]


def phase_compile(scenes, card):
    import jax.numpy as jnp

    from voxtracer.engine import pipeline
    from voxtracer.engine.params import pack_frame_inputs

    for label, name, w, h, radius, path in SIZES:
        r = make_renderer(scenes[name], w, h, radius)
        cam = r._cam_rows(path_cams(scenes[name], path, 1)[0])
        packed = pack_frame_inputs(cam, r.render_params, r.temporal_params,
                                   r.denoise_params, 1)
        for reproject in (True, False):
            t0 = time.perf_counter()
            compiled = pipeline.render_frame_packed.lower(
                r.state, r._scene_arrays, jnp.asarray(packed), r._noise,
                **r._static_kw(reproject, True),
            ).compile()
            ma = compiled.memory_analysis()
            print(
                f"  compile {label} r={radius} reproject={reproject} "
                f"trace={r.trace_impl}: {time.perf_counter() - t0:.1f} s; "
                f"memory_analysis: arguments {ma.argument_size_in_bytes} B, "
                f"outputs {ma.output_size_in_bytes} B, "
                f"aliased {ma.alias_size_in_bytes} B, "
                f"temp {ma.temp_size_in_bytes} B, "
                f"code {ma.generated_code_size_in_bytes} B",
                flush=True,
            )


def phase_parity(scenes, card):
    import jax

    from voxtracer import parity
    from voxtracer.engine.camera import Camera
    from voxtracer.engine.params import RenderParams
    from voxtracer.engine.pipeline import trace_sample
    from voxtracer.ops import bluenoise
    from voxtracer.ops import noise as noise_op
    from voxtracer.oracle import renderer as oracle

    print(
        f"  tolerances: node agreement >= {parity.NODE_AGREEMENT}; depth "
        f"rtol/atol {parity.DEPTH_TOL} on agreeing hits; color |err| < "
        f"{parity.COLOR_TOL} on >= {parity.COLOR_SHARE} of agreeing px; "
        f"denoise rtol/atol {parity.DENOISE_TOL}; all float32, no "
        "dot/einsum on the trace/temporal path (TF32 cannot enter), "
        "reference runs under default_matmul_precision('highest')",
        flush=True,
    )
    bad = []
    params = RenderParams()

    def cam_arr(cam, h, w):
        right, up, forward = cam.axis_scaled(w, h)
        return np.stack([cam.position, right, up, forward]).astype(np.float32)

    # Triton kernel vs the NumPy oracle (BASELINE config 1)
    scene = scenes["8x8x8"]
    w, h = ORACLE_SIZE
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    buf = noise_op.white_noise_buffer(seed=7, count=32)
    right, up, forward = cam.axis_scaled(w, h)
    o = oracle.render_sample(
        scene.values, scene.origin.astype(np.int64),
        np.asarray(cam.position), right, up, forward, params,
        noise_op.noise_planes(buf, 1, h, w), w, h,
    )
    x = trace_sample(scene, cam_arr(cam, h, w), params, buf, 1, h, w,
                     trace_impl="triton")
    gate = parity.gbuf_gate(o, x)
    print(f"  triton vs oracle, 8x8x8 {w}x{h}: {json.dumps(gate)}",
          flush=True)
    if not gate["ok"]:
        bad.append("triton vs oracle")

    # Triton kernel vs the XLA trace at a real size
    scene = scenes["menger"]
    w, h = TRACE_PARITY_SIZE
    cam = Camera(position=np.array([36.0, 34.0, -5.0]),
                 direction=np.array([-16.0, -14.0, 25.0]))
    buf = bluenoise.cached_buffer()
    args = (scene, cam_arr(cam, h, w), params, buf, 1, h, w)
    with jax.default_matmul_precision("highest"):
        ref = trace_sample(*args, trace_impl="xla")
    got = trace_sample(*args, trace_impl="triton")
    gate = parity.gbuf_gate(ref, got)
    print(f"  triton vs xla trace, menger {w}x{h}: {json.dumps(gate)}",
          flush=True)
    if not gate["ok"]:
        bad.append("triton vs xla")

    # denoise vs float64 NumPy at 1080p, the GUI's default and top
    # radius: the Triton kernel the GPU runs, and the XLA twin at r=2
    w, h = DENOISE_SIZE
    for impl, radius in (("triton", 2), ("triton", 8), ("xla", 2)):
        gate = parity.denoise_gate(h, w, radius, impl=impl)
        print(f"  {impl} denoise r={radius} vs float64 numpy, {w}x{h}: "
              f"{json.dumps(gate)}", flush=True)
        if not gate["ok"]:
            bad.append(f"{impl} denoise r={radius}")
    if bad:
        raise AssertionError(f"parity failed: {bad}")


def phase_end_to_end(scenes, card):
    import dataclasses

    import jax

    for label, name, w, h, radius, path in SIZES:
        r = make_renderer(scenes[name], w, h, radius)
        cams = path_cams(scenes[name], path, 12)
        per_frame = None
        if path == "static":
            def per_frame(i, r=r):  # animated sun, camera at rest
                r.render_params = dataclasses.replace(
                    r.render_params, sun_yaw=1.32 + 0.05 * i
                )
        for i, cam in enumerate(cams[:2]):
            out = r.render(cam)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i, cam in enumerate(cams[2:], 2):
            if per_frame is not None:
                per_frame(i)
            out = r.render(cam)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) * 1e3 / (len(cams) - 2)
        check_image(out["image"], label)
        if not np.isfinite(np.asarray(r.state["accum_color"])).all():
            raise AssertionError(f"{label}: non-finite accumulation")
        print(f"  {label} ({name} {w}x{h}, r={radius}, {path} camera, "
              f"trace={r.trace_impl}): {ms:.3f} ms/frame pipelined "
              f"[{card}]", flush=True)

    # converged still in one dispatch
    name, w, h, radius, n = BURST
    r = make_renderer(scenes[name], w, h, radius)
    cam = path_cams(scenes[name], "static", 1)[0]
    jax.block_until_ready(r.render_burst(cam, n))
    t0 = time.perf_counter()
    img = jax.block_until_ready(r.render_burst(cam, n))
    ms = (time.perf_counter() - t0) * 1e3 / n
    check_image(img, "render_burst")
    print(f"  render_burst {name} {w}x{h} r={radius}, {n} passes: "
          f"{ms:.3f} ms/pass [{card}]", flush=True)

    # the CLI entry point writes a PNG
    from voxtracer.app import cli

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "menger.png")
        name, w, h, radius, _ = BURST
        rc = cli.main(["--scene", name, "--size", f"{w}x{h}",
                       "--frames", "6", "--path", "orbit",
                       "--denoise-radius", str(radius), "-o", png])
        with open(png, "rb") as f:
            head = f.read(8)
        if rc != 0 or head != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"cli rc {rc}, header {head!r}")
        print(f"  cli wrote a {os.path.getsize(png)} B PNG", flush=True)


class xla_denoise_in_frame:
    """Swap the frame's denoise stage for its XLA twin while timing it
    in-frame (the jit caches are dropped on entry and exit, so neither
    variant reuses the other's compiled frame)."""

    def __enter__(self):
        import jax

        from voxtracer.engine import pipeline

        self._orig = orig = pipeline._denoise
        pipeline._denoise = lambda impl, *a: orig("xla", *a)
        jax.clear_caches()

    def __exit__(self, *exc):
        import jax

        from voxtracer.engine import pipeline

        pipeline._denoise = self._orig
        jax.clear_caches()


def phase_decisions(scenes, card):
    """In-frame timings that decide each stage's implementation."""
    rows = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        rows[key] = fn()
        print(f"  decision {key}: {rows[key]:.3f} ms/frame (median, whole "
              f"frame function; {time.perf_counter() - t0:.0f} s incl. "
              f"compile) [{card}]", flush=True)

    for label, name, w, h in DECISION_SIZES:
        path = "orbit" if name == "menger" else "dolly"
        cams = path_cams(scenes[name], path, 12)
        for impl, n in (("triton", 12), ("xla", 6)):
            timed(f"{label} moving r=2 trace+denoise={impl}",
                  lambda: frame_ms(make_renderer(scenes[name], w, h, 2,
                                                 trace_impl=impl), cams[:n]))

    # temporal: the same frame with and without reprojection; denoise:
    # the still frame at r = 0, 2, 8, and r=2 with the XLA stencil
    label, name, w, h = DECISION_SIZES[-1]
    cams = path_cams(scenes[name], "dolly", 12)
    for radius in (0, 2, 8):
        r = make_renderer(scenes[name], w, h, radius)
        timed(f"{label} still r={radius}",
              lambda: frame_ms(r, [cams[0]] * 10))
        if radius == 2:
            timed(f"{label} moving r=2", lambda: frame_ms(r, cams))
    with xla_denoise_in_frame():
        timed(f"{label} still r=2, XLA denoise",
              lambda: frame_ms(make_renderer(scenes[name], w, h, 2),
                               [cams[0]] * 10))
    return rows


def phase_gpu_tests(card):
    import pytest

    os.environ["VOX_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu.py")])
    if rc != 0:
        raise AssertionError(f"GPU test lane exit code {rc}")


# -- four cards -------------------------------------------------------------


def phase_sharded(scenes, devices, card):
    """One 720p frame split by rows over the cards (Triton trace per
    slab under shard_map, stencils by annotation) vs the single-card
    frame, two frames with camera motion."""
    import jax
    import jax.numpy as jnp

    from voxtracer import parity
    from voxtracer.engine import pipeline
    from voxtracer.engine.params import (DenoiseParams, RenderParams,
                                         TemporalParams)
    from voxtracer.ops import bluenoise
    from voxtracer.parallel import make_mesh, sharded_render_frame
    from voxtracer.parallel.mesh import scene_device_args

    scene = scenes["menger"]
    h, w, radius = SHARDED_SIZE
    meta, arrays = scene_device_args(scene)
    noise = jnp.asarray(bluenoise.cached_buffer())
    cams = path_cams(scene, "orbit", 2)

    def cam_arr(c):
        right, up, forward = c.axis_scaled(w, h)
        return jnp.asarray(
            np.stack([c.position, right, up, forward]).astype(np.float32))

    params = (RenderParams(), TemporalParams(), DenoiseParams())
    state = pipeline.init_state(h, w)
    for i, c in enumerate(cams):
        state, single = pipeline.render_frame(
            state, arrays, cam_arr(c), *params, noise, jnp.int32(i + 1),
            scene_meta=meta, height=h, width=w, radius=radius,
            reproject=i > 0, trace_impl="triton",
        )
    mesh = make_mesh(devices)
    fns = {
        rep: sharded_render_frame(mesh, scene_meta=meta, height=h, width=w,
                                  radius=radius, reproject=rep,
                                  trace_impl="triton")
        for rep in (False, True)
    }
    state = fns[False][1](pipeline.init_state(h, w))
    for i, c in enumerate(cams):
        state, sharded = fns[i > 0][0](
            state, arrays, cam_arr(c), *params, noise, jnp.int32(i + 1))
    jax.block_until_ready(sharded)

    def gbuf(out):
        return {"node": np.asarray(out["node"]),
                "depth": np.asarray(out["depth"]),
                "color": np.asarray(out["linear"])}

    gate = parity.gbuf_gate(gbuf(single), gbuf(sharded))
    same_px = float((np.asarray(single["image"])
                     == np.asarray(sharded["image"])).all(-1).mean())
    print(f"  sharded over {len(devices)} cards vs one card, menger "
          f"{w}x{h} r={radius}, frame 2 of an orbit: {json.dumps(gate)}; "
          f"identical u8 pixels {same_px:.6f}", flush=True)

    # informational: moving-camera frame time, sharded vs one card
    def timed(step, st, n=10):
        cs = path_cams(scene, "orbit", n + 2)
        for i, c in enumerate(cs[:2]):
            st, out = step(st, c, i)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for i, c in enumerate(cs[2:], 2):
            st, out = step(st, c, i)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) * 1e3 / n

    def one(st, c, i):
        return pipeline.render_frame(
            st, arrays, cam_arr(c), *params, noise, jnp.int32(i + 3),
            scene_meta=meta, height=h, width=w, radius=radius,
            reproject=True, trace_impl="triton")

    def many(st, c, i):
        return fns[True][0](st, arrays, cam_arr(c), *params, noise,
                            jnp.int32(i + 3))

    ms_one = timed(one, pipeline.init_state(h, w))
    ms_many = timed(many, state)
    print(f"  moving {w}x{h} r={radius} frame: one card {ms_one:.3f} ms, "
          f"{len(devices)} cards {ms_many:.3f} ms (pipelined) [{card}]",
          flush=True)
    if not gate["ok"]:
        raise AssertionError("sharded frame differs from the single-card frame")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded frame on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        from voxtracer.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        fail(f"the voxtracer package is not beside this script ({e})")
    enable_compile_cache()

    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        fail(f"no GPU: JAX platform is {dev.platform!r}")
    card = card_name_and_power_limit()
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    print(f"card: {card}", flush=True)

    from voxtracer.app.cli import load_scene

    if args.cards == 4:
        if len(devices) < 4:
            fail(f"--cards 4 needs 4 GPUs, found {len(devices)}")
        scenes = {"menger": load_scene("menger")}
        run_phase("sharded", lambda: phase_sharded(scenes, devices[:4], card))
        count = 4
    else:
        scenes = {n: load_scene(n)
                  for n in ("8x8x8", "menger", "monu9", "castle")}
        run_phase("compile", lambda: phase_compile(scenes, card))
        run_phase("parity", lambda: phase_parity(scenes, card))
        run_phase("end_to_end", lambda: phase_end_to_end(scenes, card))
        run_phase("decisions", lambda: phase_decisions(scenes, card))
        run_phase("gpu_tests", lambda: phase_gpu_tests(card))
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
