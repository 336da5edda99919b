"""The jitted frame function and its host-side driver.

The reference drives one command encoder per frame through three
sequential compute dispatches (trace -> temporal -> denoise), a
g-buffer ping-pong copy and a swapchain blit
(``src/context.rs:2004-2075``).  Here that frame is a single jitted
pure function ``(state, inputs) -> (state, outputs)``:

  * the g-buffer ping-pong becomes a donated carry (no copies at all —
    XLA aliases the buffers),
  * per-frame "uniform upload" becomes traced scalar arguments (no
    recompilation when parameters move),
  * the swapchain blit becomes an on-device sRGB/u8 encode; only the
    final u8 image crosses back to the host.

Static configuration (resolution, denoise radius, whether the camera
moved) selects among cached jit specializations.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional, Tuple

import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

log = logging.getLogger("voxtracer.engine.pipeline")

from ..ops import denoise as denoise_op
from ..ops import denoise_triton
from ..ops import noise as noise_op
from ..ops import temporal as temporal_op
from ..ops import tonemap
from ..ops import trace_triton
from ..ops import trace_xla
from ..scene.grid import GridScene
from .camera import Camera
from .params import DenoiseParams, RenderParams, TemporalParams

# Kernel set by device platform: "triton" (NVIDIA GPUs) runs the trace
# and the r > 0 denoise as Pallas-Triton kernels, "xla" (the CPU: tests,
# small offline renders) their plain-XLA twins.  Temporal and tonemap
# are plain XLA on both.
TRACE_IMPLS = ("xla", "triton")
_TRACE_BY_PLATFORM = {"gpu": "triton", "cpu": "xla"}


def select_trace_impl(platform: str) -> str:
    """The kernel set for a device platform; any platform without a
    supported path raises instead of falling back."""
    try:
        return _TRACE_BY_PLATFORM[platform]
    except KeyError:
        raise ValueError(
            f"no trace path for platform {platform!r} "
            f"(supported: {sorted(_TRACE_BY_PLATFORM)})"
        ) from None


def init_state(height: int, width: int) -> Dict[str, jnp.ndarray]:
    """Fresh accumulation / history state (all-invalid history)."""
    return {
        # planar (3, H, W); the frame function moves it to channels-last
        # where the reprojection and denoise stages read it
        "accum_color": jnp.zeros((3, height, width), jnp.float32),
        "accum_blend": jnp.ones((height, width), jnp.float32),
        "old_depth": jnp.full((height, width), -1.0, jnp.float32),
        "old_cam": jnp.zeros((4, 3), jnp.float32),
        "history_valid": jnp.zeros((), bool),
    }


def _trace(
    trace_impl, scene_arrays, scene_meta, cam, render_params, noise_buffer,
    frame_number, height, width, shard_mesh, shard_axis,
):
    """The trace stage: the G-buffer dict of ``trace_xla.render_sample``."""
    dims, origin = scene_meta
    if trace_impl == "xla":
        planes = noise_op.noise_planes(
            noise_buffer, frame_number, height, width, xp=jnp
        )
        return trace_xla.render_sample(
            scene_arrays["flat_grid"], dims, scene_arrays["grid_origin"],
            cam[0], cam[1], cam[2], cam[3], render_params, planes,
            height, width,
        )
    if trace_impl != "triton":
        raise ValueError(f"unknown trace_impl {trace_impl!r}")
    # The CPU has no Triton backend: there the kernel runs through the
    # Pallas interpreter (how the CPU tests check it).
    interpret = jax.default_backend() == "cpu"
    if shard_mesh is None:
        return trace_triton.render_sample(
            scene_arrays["flat_grid"], dims, origin, cam, render_params,
            noise_buffer, frame_number, height, width, interpret=interpret,
        )
    # XLA cannot partition a Triton custom call, so each device traces
    # its own row slab under shard_map; ray generation and noise stay
    # image-global through the slab's row offset.
    slab = height // shard_mesh.devices.size

    def per_slab(grid, cam, rp, noise, frame):
        row0 = jax.lax.axis_index(shard_axis) * slab
        return trace_triton.render_sample(
            grid, dims, origin, cam, rp, noise, frame, slab, width,
            row0=row0, interpret=interpret,
        )

    return jax.shard_map(
        per_slab,
        mesh=shard_mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(shard_axis),
        check_vma=False,
    )(
        scene_arrays["flat_grid"], cam, render_params, noise_buffer,
        frame_number,
    )


def trace_sample(
    scene, cam, render_params, noise_buffer, frame_number, height, width,
    trace_impl: Optional[str] = None,
):
    """One G-buffer sample of ``scene`` through a trace path (default:
    the platform's) as host numpy arrays: the parity checks' entry."""
    from ..parallel.mesh import scene_device_args

    trace_impl = trace_impl or select_trace_impl(jax.devices()[0].platform)
    meta, arrays = scene_device_args(scene)
    fn = jax.jit(
        lambda arrays, cam, rp, noise, frame: _trace(
            trace_impl, arrays, meta, cam, rp, noise, frame, height, width,
            None, "rows",
        )
    )
    out = fn(
        arrays, jnp.asarray(cam, jnp.float32), render_params,
        jnp.asarray(noise_buffer), jnp.int32(frame_number),
    )
    return {k: np.asarray(v) for k, v in out.items()}

def _denoise(
    trace_impl, colors, gbuf, cam_tuple, denoise_params, radius, height,
    shard_mesh, shard_axis,
):
    """The denoise stage: (H, W, 3) filtered, albedo-remodulated color."""
    args = (
        colors, gbuf["normal"], gbuf["depth"], gbuf["albedo"], gbuf["node"],
        cam_tuple, denoise_params,
    )
    if trace_impl == "xla" or radius == 0:
        return denoise_op.denoise(*args, radius=radius)
    interpret = jax.default_backend() == "cpu"
    if shard_mesh is None:
        return denoise_triton.denoise(*args, radius, interpret=interpret)
    # Per row slab under shard_map, like the trace: each device reads
    # the whole (gathered) G-buffer for its halo and writes its slab.
    slab = height // shard_mesh.devices.size

    def per_slab(*a):
        row0 = jax.lax.axis_index(shard_axis) * slab
        return denoise_triton.denoise(
            *a, radius, row0=row0, out_rows=slab, interpret=interpret
        )

    return jax.shard_map(
        per_slab,
        mesh=shard_mesh,
        in_specs=(P(),) * len(args),
        out_specs=P(shard_axis),
        check_vma=False,
    )(*args)


def render_frame_impl(
    state: Dict[str, jnp.ndarray],
    scene_arrays: Dict[str, jnp.ndarray],
    cam: jnp.ndarray,  # (4, 3): origin, right, up, forward (pixel-scaled)
    render_params: RenderParams,
    temporal_params: TemporalParams,
    denoise_params: DenoiseParams,
    noise_buffer: jnp.ndarray,  # (S, 128, 128)
    frame_number: jnp.ndarray,  # int32 scalar
    *,
    scene_meta: Tuple,  # (dims, origin): hashable static scene geometry
    height: int,
    width: int,
    radius: int,
    reproject: bool,
    trace_impl: str = "xla",
    lean: bool = False,  # realtime outputs only (image, depth)
    shard_mesh=None,  # jax.sharding.Mesh: run the Triton kernels per row
    #   slab under shard_map (the other stages shard by annotation)
    shard_axis: str = "rows",
):
    cam_tuple = (cam[0], cam[1], cam[2], cam[3])
    old = state["old_cam"]
    old_cam_tuple = (old[0], old[1], old[2], old[3])

    gbuf = _trace(
        trace_impl, scene_arrays, scene_meta, cam, render_params,
        noise_buffer, frame_number, height, width, shard_mesh, shard_axis,
    )

    if reproject:
        blended, next_blend = temporal_op.temporal_blend(
            gbuf["color"],
            gbuf["normal"],
            gbuf["depth"],
            jnp.moveaxis(state["accum_color"], 0, -1),
            state["accum_blend"],
            state["old_depth"],
            cam_tuple,
            old_cam_tuple,
            temporal_params,
            state["history_valid"],
        )
    else:
        # camera at rest: the elementwise blend on the planar history
        # (the layout moves fuse into the blend)
        blended_planar, next_blend = temporal_op.temporal_blend_still_planar(
            jnp.moveaxis(gbuf["color"], -1, 0),
            jnp.moveaxis(gbuf["normal"], -1, 0),
            gbuf["depth"],
            state["accum_color"],
            state["accum_blend"],
            state["old_depth"],
            cam_tuple,
            old_cam_tuple,
            temporal_params,
            state["history_valid"],
        )
        blended = jnp.moveaxis(blended_planar, 0, -1)

    out = _denoise(
        trace_impl, blended, gbuf, cam_tuple, denoise_params, radius,
        height, shard_mesh, shard_axis,
    )
    image_u8 = tonemap.to_u8(out)

    new_state = {
        "accum_color": jnp.moveaxis(blended, -1, 0),
        "accum_blend": next_blend,
        "old_depth": gbuf["depth"],
        "old_cam": cam,
        "history_valid": state["history_valid"] | True,
    }
    outputs = {"image": image_u8, "depth": gbuf["depth"]}
    if not lean:
        outputs.update(
            {
                "linear": out,
                "trace_color": gbuf["color"],
                "normal": gbuf["normal"],
                "albedo": gbuf["albedo"],
                "node": gbuf["node"],
            }
        )
    return new_state, outputs


_STATIC = (
    "scene_meta", "height", "width", "radius", "reproject", "trace_impl",
    "lean", "shard_mesh", "shard_axis",
)

render_frame = partial(
    jax.jit, static_argnames=_STATIC, donate_argnames=("state",)
)(render_frame_impl)


def _render_frame_packed_impl(
    state, scene_arrays, packed, noise_buffer, **static_kw
):
    """Same frame function, but every dynamic scalar input rides in
    ONE packed (1, 32) host array per frame instead of ~6 small
    host-to-device copies (see ``params.pack_frame_inputs``)."""
    from .params import unpack_frame_inputs

    cam, rp, tp, dp, frame_number = unpack_frame_inputs(packed)
    return render_frame_impl(
        state, scene_arrays, cam, rp, tp, dp, noise_buffer,
        frame_number, **static_kw,
    )


render_frame_packed = partial(
    jax.jit, static_argnames=_STATIC, donate_argnames=("state",)
)(_render_frame_packed_impl)


def _render_sequence_impl(
    state, scene_arrays, packed_seq, noise_buffer, **static_kw
):
    """N frames in ONE device dispatch: ``lax.scan`` over the packed
    per-frame input rows.

    Offline work (converged stills, turntables, animation exports) has
    the whole camera path up front, so the frame loop can run on the
    device: the scan body is the exact packed frame function, the carry
    is the accumulation state, and the stacked per-frame inputs
    (``packed_seq``, (N, 1, 32)) are the scanned xs.  Returns the final
    state and the (N, H, W, 3) u8 tonemapped frames.

    ``reproject`` is a static jit arg, uniform across the scan; the
    Renderer splits a mixed still/moving camera path into per-segment
    sub-scans (each with its own static ``reproject``), so still frames
    keep the cheap elementwise blend and every segment stays
    bit-identical to the per-frame ``render()`` loop.  (A traced
    per-frame ``lax.cond`` was tried instead and rejected: the cond
    boundary changes XLA's fusion/FMA contraction enough to flip
    validity-threshold pixels.)
    """

    def step(st, packed):
        st, outputs = _render_frame_packed_impl(
            st, scene_arrays, packed, noise_buffer, **static_kw
        )
        return st, outputs["image"]

    return jax.lax.scan(step, state, packed_seq)


render_sequence_jit = partial(
    jax.jit, static_argnames=_STATIC, donate_argnames=("state",)
)(_render_sequence_impl)


def _render_burst_impl(
    state, scene_arrays, packed_seq, noise_buffer, **static_kw
):
    """Carry-only burst scan: N accumulation passes, ONE output frame.

    ``_render_sequence_impl`` stacks every step's u8 image as scan ys:
    at 4K a 256-pass converged still would hold ~6 GB of device memory
    for output that is 24 MB.  A burst only wants the LAST frame, so
    the image rides in the carry instead (one (H, W, 3) u8 buffer,
    overwritten and donated each step)."""
    height = static_kw["height"]
    width = static_kw["width"]

    def body(carry, packed):
        st, _ = carry
        st, outputs = _render_frame_packed_impl(
            st, scene_arrays, packed, noise_buffer, **static_kw
        )
        return (st, outputs["image"]), None

    init = (state, jnp.zeros((height, width, 3), jnp.uint8))
    (st, image), _ = jax.lax.scan(body, init, packed_seq)
    return st, image


render_burst_jit = partial(
    jax.jit, static_argnames=_STATIC, donate_argnames=("state",)
)(_render_burst_impl)


@dataclasses.dataclass
class Renderer:
    """Host-side frame driver: owns device scene + state, advances frames.

    Capability analog of the reference's ``Context`` render half: frame
    counters, camera-motion detection (selects the no-resample temporal
    path, and resets ``still_sample`` like ``src/context.rs:1999``),
    and scene swapping (``recreate_octree``, ``:799-810``).
    """

    scene: GridScene
    height: int
    width: int
    render_params: RenderParams = RenderParams()
    temporal_params: TemporalParams = TemporalParams()
    denoise_params: DenoiseParams = DenoiseParams()
    denoise_radius: int = 0
    noise_buffer: Optional[np.ndarray] = None
    trace_impl: Optional[str] = None  # None: select_trace_impl(platform)
    lean: bool = False  # default render() output set (see render_frame_impl)

    def __post_init__(self):
        if self.trace_impl is None:
            self.trace_impl = select_trace_impl(jax.devices()[0].platform)
        if self.trace_impl not in TRACE_IMPLS:
            raise ValueError(f"unknown trace_impl {self.trace_impl!r}")
        if self.noise_buffer is None:
            # Blue noise is the reference's RNG source
            # (src/context.rs:1019-1116); the baked asset loads instantly.
            # White noise is only the emergency fallback (e.g. missing
            # asset on a machine where baking is unavailable).
            try:
                from ..ops import bluenoise

                self.noise_buffer = bluenoise.cached_buffer()
            except Exception:
                log.warning("blue-noise asset unavailable; using white noise")
                self.noise_buffer = noise_op.white_noise_buffer()
        self._noise = jnp.asarray(self.noise_buffer)
        self._upload_scene(self.scene)
        self.state = init_state(self.height, self.width)
        self.frame_number = 0
        self.still_sample = 0
        self._last_cam: Optional[np.ndarray] = None
        # host mirror of state["history_valid"]: a batch reprojects only
        # where history exists (snapshot.load syncs it on resume)
        self._history_valid = False

    def _upload_scene(self, scene: GridScene):
        from ..parallel.mesh import scene_device_args

        self.scene = scene
        self._scene_meta, self._scene_arrays = scene_device_args(scene)

    def set_scene(self, scene: GridScene):
        """Swap scenes and restart accumulation (src/context.rs:1406-1424)."""
        self._upload_scene(scene)
        self.reset_accumulation()

    def reset_accumulation(self):
        self.state = init_state(self.height, self.width)
        self.still_sample = 0
        self._history_valid = False

    def resize(self, height: int, width: int):
        """Live resolution change: keep the scene tables, params and
        camera; restart accumulation at the new shape (history is
        size-bound).  The reference recreates every size-dependent
        resource on window resize (``src/context.rs:1430-1461``); here
        the scene upload survives untouched and the jit cache simply
        gains a specialization for the new shape on the next frame."""
        if (height, width) == (self.height, self.width):
            return
        if height <= 0 or width <= 0:
            raise ValueError(f"invalid size {width}x{height}")
        self.height = int(height)
        self.width = int(width)
        self._last_cam = None  # pixel-scaled basis changed shape
        self.reset_accumulation()

    def _static_kw(self, reproject, lean):
        return dict(
            scene_meta=self._scene_meta,
            height=self.height,
            width=self.width,
            radius=self.denoise_radius,
            reproject=reproject,
            trace_impl=self.trace_impl,
            lean=lean,
        )

    def _cam_rows(self, camera: Camera) -> np.ndarray:
        right, up, forward = camera.axis_scaled(self.width, self.height)
        return np.stack(
            [np.asarray(camera.position), right, up, forward]
        ).astype(np.float32)

    def render(
        self, camera: Camera, lean: Optional[bool] = None
    ) -> Dict[str, np.ndarray]:
        from .params import pack_frame_inputs

        lean = self.lean if lean is None else lean
        cam = self._cam_rows(camera)
        prev_cam = self._last_cam
        moved = prev_cam is None or not np.array_equal(cam, prev_cam)
        self._last_cam = cam
        if moved:
            self.still_sample = 0
        self.frame_number += 1
        self.still_sample += 1

        self.state, outputs = render_frame_packed(
            self.state,
            self._scene_arrays,
            pack_frame_inputs(
                cam, self.render_params, self.temporal_params,
                self.denoise_params, self.frame_number,
            ),
            self._noise,
            **self._static_kw(moved, lean),
        )
        self._history_valid = True
        return outputs

    def _pack_sequence(self, cameras):
        """Shared sequence prep: per-frame packed rows and per-frame
        reproject flags (True where a moved camera meets live history).
        Returns ``(packed_seq, flags, still, last_cam)``."""
        from .params import pack_frame_inputs

        cams = [self._cam_rows(c) for c in cameras]
        if not cams:
            raise ValueError("render_sequence needs at least one camera")
        prev = self._last_cam
        rows = []
        flags = []
        still = self.still_sample
        for i, cam in enumerate(cams):
            moved = prev is None or not np.array_equal(cam, prev)
            hvalid = self._history_valid if i == 0 else True
            # reproject matters only where history exists to resample
            flags.append(bool(moved and hvalid))
            still = 0 if moved else still
            still += 1
            rows.append(
                pack_frame_inputs(
                    cam, self.render_params, self.temporal_params,
                    self.denoise_params, self.frame_number + i + 1,
                )
            )
            prev = cam
        return np.stack(rows), flags, still, prev

    @staticmethod
    def _segments(flags):
        """Run-length encode the per-frame reproject flags into
        ``(start, end, reproject)`` sub-scan segments.  A mixed
        still/moving path dispatches one scan per segment, each with
        its static ``reproject``, so still frames keep the cheap
        elementwise blend AND every frame stays bit-identical to the
        per-frame ``render()`` loop."""
        segs = []
        start = 0
        for i in range(1, len(flags)):
            if flags[i] != flags[start]:
                segs.append((start, i, flags[start]))
                start = i
        segs.append((start, len(flags), flags[start]))
        return segs

    def _finish_sequence(self, n, still, last_cam):
        self.frame_number += n
        self.still_sample = still
        self._last_cam = last_cam
        self._history_valid = True

    def render_sequence(self, cameras) -> jnp.ndarray:
        """Render ``len(cameras)`` frames in ONE device dispatch.

        The device runs the whole frame loop as a ``lax.scan`` over
        host-packed per-frame input rows: no per-frame dispatch, no
        per-frame host round trip.  Returns the (N, H, W, 3) u8 frame
        stack (device array; ``np.asarray`` it once at the end).
        Advances the renderer's accumulation state and frame counters
        exactly as N sequential :meth:`render` calls would.

        Output frames stay on the device: at 4K a 32-frame stack is
        ~760 MB, so chunk long exports into multiple calls.  Each
        distinct (segment length, reproject) pair compiles its own scan;
        paths that alternate motion every frame would compile many, so
        render such paths frame by frame instead.
        """
        packed_seq, flags, still, last = self._pack_sequence(cameras)
        parts = []
        for start, end, reproject in self._segments(flags):
            self.state, frames = render_sequence_jit(
                self.state,
                self._scene_arrays,
                packed_seq[start:end],
                self._noise,
                **self._static_kw(reproject, True),
            )
            parts.append(frames)
        self._finish_sequence(len(cameras), still, last)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    def render_burst(self, camera: "Camera", n: int) -> jnp.ndarray:
        """N accumulation passes at a fixed camera in one dispatch;
        returns the final (converged) u8 frame (device array).  The
        offline-still analog of holding the realtime loop still for N
        frames (the reference's progressive accumulation,
        ``src/context.rs:1999``).  Unlike :meth:`render_sequence` the
        scan is carry-only: the intermediate frames are never
        materialized, so a 256-pass 4K burst holds one output image."""
        packed_seq, flags, still, last = self._pack_sequence([camera] * n)
        image = None
        for start, end, reproject in self._segments(flags):
            self.state, image = render_burst_jit(
                self.state,
                self._scene_arrays,
                packed_seq[start:end],
                self._noise,
                **self._static_kw(reproject, True),
            )
        self._finish_sequence(n, still, last)
        return image
