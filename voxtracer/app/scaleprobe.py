"""Scale probe: a large synthetic scene through the normal Renderer.

Builds a dense noisy shell at ``--dims`` (default 480: a 442 MB dense
int32 grid, far beyond every shipped asset), times frames at
``--size`` on the platform's trace path, and optionally (--xla)
renders the same sample on the XLA trace for a node-agreement +
speedup check.

Run: python -m voxtracer.app.scaleprobe [--dims 480] [--xla]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def synthetic_shell(dims: int, seed: int = 3) -> "GridScene":
    """A hollow noisy sphere-shell scene of ``dims``^3 extent —
    a large, non-uniform scene whose colors still fit the palette."""
    from ..scene import grid as grid_mod
    from ..scene.grid import GridScene

    rng = np.random.default_rng(seed)
    n = dims
    c = (n - 1) / 2.0
    g = np.arange(n, dtype=np.float32) - c
    d2 = (g[:, None, None] ** 2 + g[None, :, None] ** 2
          + g[None, None, :] ** 2)
    r = n * 0.47
    shell = (d2 < r * r) & (d2 > (r - 6.0) ** 2)
    # random surface colors, ~1% emissive (like the procedural bowl);
    # colors go through the same leaf quantizer as real scenes so the
    # palette budget holds.  Leaves are built only at shell cells to
    # keep host memory ~O(occupied), not O(n^3) per channel.
    idx = np.nonzero(shell)
    k = idx[0].size
    cols = rng.integers(40, 255, size=(k, 3), dtype=np.uint32)
    emis = (rng.random(k) < 0.01).astype(np.uint32)
    leaf = (
        np.uint32(1 << 31)
        | (emis << 30)
        | (emis << 24)
        | (cols[:, 0] << 16)
        | (cols[:, 1] << 8)
        | cols[:, 2]
    ).view(np.int32)
    leaf = grid_mod._quantize_leaves(leaf)
    values = np.zeros((n, n, n), dtype=np.int32)
    values[idx] = leaf
    origin = np.array([-int(c)] * 3, dtype=np.int32)
    mips = grid_mod._build_mips(values != 0, 6)
    return GridScene(values=values, origin=origin, mips=mips)


def main(argv=None) -> int:
    import jax

    from ..engine.camera import Camera
    from ..engine.pipeline import Renderer
    from ..utils.compile_cache import enable_compile_cache

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dims", type=int, default=480)
    p.add_argument("--size", default="640x360")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--xla", action="store_true",
                   help="also render one sample on the XLA trace "
                        "for node agreement + speedup (slow)")
    args = p.parse_args(argv)
    enable_compile_cache()

    w, h = (int(v) for v in args.size.split("x"))
    t0 = time.perf_counter()
    scene = synthetic_shell(args.dims)
    print(f"# scene {args.dims}^3 built in {time.perf_counter()-t0:.1f}s; "
          f"dense grid {scene.values.nbytes / 1e6:.0f} MB")

    cam = Camera(
        position=np.array([args.dims * 0.75, args.dims * 0.55,
                           -args.dims * 0.7]),
        direction=np.array([-0.6, -0.45, 1.0]),
    )

    r = Renderer(scene=scene, height=h, width=w, lean=True)
    out = None
    for _ in range(2):
        out = r.render(cam)
    jax.block_until_ready(out)  # land the warm frames
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out = r.render(cam)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.frames
    print(f"trace_impl={r.trace_impl}: {dt*1e3:.1f} ms/frame "
          f"at {w}x{h}")

    if args.xla:
        rx = Renderer(scene=scene, height=h, width=w, lean=False,
                      trace_impl="xla")
        rp = Renderer(scene=scene, height=h, width=w, lean=False)
        t0 = time.perf_counter()
        ox = rx.render(cam)
        nx = np.asarray(ox["node"])
        dtx = time.perf_counter() - t0
        op = rp.render(cam)
        npx = np.asarray(op["node"])
        agree = float((nx == npx).mean())
        print(f"xla trace: {dtx:.1f} s/frame (cold+run); node "
              f"agreement {agree:.5f}; speedup ~{dtx/dt:.0f}x")
        # Character of the disagreements: on this scene every voxel
        # has a distinct random color, so a 1-ulp tangent-ray cell
        # flip (two correct f32 marches entering grazing cells in
        # different order at ~1e-4 depth deltas) counts as a node
        # mismatch that the uniform-colored shipped assets would hide.
        # Real bugs show up here as hit/miss flips or large depth
        # deltas; float divergence shows up as adjacent-cell both-hit
        # flips.
        d = nx != npx
        if d.any():
            dxp = np.abs(np.asarray(ox["depth"]) - np.asarray(op["depth"]))
            miss_x = nx[d] == 0xFFFFFF
            miss_p = npx[d] == 0xFFFFFF
            print(f"  disagreements: {int(d.sum())} px — "
                  f"hit/miss flips {int((miss_x ^ miss_p).sum())}, "
                  f"both-hit cell flips "
                  f"{int((~miss_x & ~miss_p).sum())}; depth |delta| "
                  f"at flips p50 {np.median(dxp[d]):.2e} "
                  f"max {dxp[d].max():.2e}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
