"""Several devices: image-row data parallelism over a device mesh.

The reference's only parallelism is the GPU's own SIMT grid (16x16
workgroups, ``src/context.rs:2018-2037``): one device, no
communication layer.  Here one frame is split across devices by
sharding the row dimension of every per-pixel array over a 1-D
``jax.sharding.Mesh`` ("rows"), with the scene, noise buffer and camera
replicated.  The cards of one host are joined all to all, so the mesh
follows the algorithm alone:

  * the path-trace stage is embarrassingly parallel per pixel, with no
    collectives on its hot loop.  XLA cannot partition the Triton
    kernel's custom call, so on that path each device traces its own
    row slab under ``shard_map`` (``pipeline._trace``);
  * the temporal resample and the denoise stencil read across slab
    boundaries.  The temporal stage is ordinary jnp ops under ``jit``
    with sharding annotations, and the SPMD partitioner inserts the halo
    exchanges; the Triton denoise runs per slab under ``shard_map`` on
    the gathered G-buffer (``pipeline._denoise``).

Scene data is replicated (voxel scenes are a few MB), so the only
steady-state traffic between devices is the stencil halos.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import pipeline


def make_mesh(devices: Optional[Sequence] = None, axis: str = "rows") -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (axis,))


def _state_specs(axis: str) -> Dict[str, P]:
    return {
        # accum_color is planar (3, H, W): rows live on axis 1
        "accum_color": P(None, axis),
        "accum_blend": P(axis),
        "old_depth": P(axis),
        "old_cam": P(),
        "history_valid": P(),
    }


def sharded_render_frame(
    mesh: Mesh,
    *,
    scene_meta: Tuple,
    height: int,
    width: int,
    radius: int = 0,
    reproject: bool = True,
    trace_impl: str = "xla",
    axis: str = "rows",
):
    """Build a jitted frame function with row-sharded pixel arrays.

    Returns ``(fn, shard_state)`` where ``shard_state`` places a host
    state dict onto the mesh.  ``fn`` has the same signature as
    :func:`voxtracer.engine.pipeline.render_frame` minus the static
    keywords.
    """
    n_dev = mesh.devices.size
    if height % n_dev != 0:
        raise ValueError(
            f"height {height} must divide evenly over {n_dev} devices"
        )

    def spec(p):
        return NamedSharding(mesh, p)

    state_shardings = {k: spec(v) for k, v in _state_specs(axis).items()}
    rep = spec(P())

    out_shardings = (
        state_shardings,
        {
            "image": spec(P(axis)),
            "linear": spec(P(axis)),
            "trace_color": spec(P(axis)),
            "depth": spec(P(axis)),
            "normal": spec(P(axis)),
            "albedo": spec(P(axis)),
            "node": spec(P(axis)),
        },
    )

    scene_shardings = rep  # every scene array replicated
    fn = jax.jit(
        partial(
            pipeline.render_frame_impl,
            scene_meta=scene_meta,
            height=height,
            width=width,
            radius=radius,
            reproject=reproject,
            trace_impl=trace_impl,
            # the Triton kernels run per slab under shard_map; the XLA
            # stages shard through annotations
            shard_mesh=mesh if trace_impl == "triton" else None,
            shard_axis=axis,
        ),
        in_shardings=(
            state_shardings,  # state
            scene_shardings,  # scene arrays (replicated)
            rep,  # cam
            None,  # render params (scalars)
            None,  # temporal params
            None,  # denoise params
            rep,  # noise buffer
            None,  # frame number
        ),
        out_shardings=out_shardings,
        donate_argnums=(0,),
    )

    def shard_state(state):
        return {
            k: jax.device_put(v, state_shardings[k]) for k, v in state.items()
        }

    return fn, shard_state


def scene_device_args(scene):
    """(scene_meta, scene_arrays) for render_frame from a GridScene.

    Both trace paths read the dense int32 grid; the XLA trace also
    takes the grid origin as an array, the Triton kernel as the static
    ``scene_meta`` entry."""
    import jax.numpy as jnp

    meta = (
        tuple(int(d) for d in scene.values.shape),
        tuple(int(v) for v in scene.origin),
    )
    arrays = {
        "flat_grid": jnp.asarray(scene.values.reshape(-1)),
        "grid_origin": jnp.asarray(scene.origin.astype(np.int32)),
    }
    return meta, arrays
