"""Per-op device-time profile of the frame function.

Captures a ``jax.profiler`` trace of a few rendered frames and prints
the top device ops by total time: the in-frame stage breakdown, with
no dispatch time mixed in.

The reference has no GPU timestamps at all (SURVEY §5 — its only
timing is a host-side fps counter, ``src/context.rs:559-588``); this
adds them.

Usage::

    python -m voxtracer.app.profile --scene monu9 --size 1920x1080 \
        --denoise-radius 2 [--static] [--frames 4] [--top 20]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple


def summarize_xplane(path: str) -> Dict[str, float]:
    """Total duration (ns) per op name on device planes of an
    ``*.xplane.pb`` trace file."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)

    def collect(planes) -> Dict[str, float]:
        tot: Dict[str, float] = defaultdict(float)
        for plane in planes:
            for line in plane.lines:
                for ev in line.events:
                    tot[ev.name] += ev.duration_ns
        return dict(tot)

    device = [p for p in pd.planes if "/device:" in p.name]
    tot = collect(device)
    if not tot:
        # CPU-only runs place XLA ops on host threads
        tot = collect(p for p in pd.planes if "/host:" in p.name)
    return tot


def profile_frames(
    renderer, cams, logdir: str
) -> List[Tuple[str, float]]:
    """Render ``cams`` under a profiler trace; return [(op, total_ns)]
    sorted by descending device time."""
    import jax
    import numpy as np

    # warm every jit variant outside the trace
    np.asarray(renderer.render(cams[0])["image"])
    np.asarray(renderer.render(cams[min(1, len(cams) - 1)])["image"])
    with jax.profiler.trace(logdir):
        for c in cams:
            out = renderer.render(c)
        np.asarray(out["image"])
    files = glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True)
    tot: Dict[str, float] = defaultdict(float)
    for f in files:
        for name, ns in summarize_xplane(f).items():
            tot[name] += ns
    return sorted(tot.items(), key=lambda kv: -kv[1])


def main(argv=None) -> None:
    from ..engine.pipeline import Renderer
    from ..utils.compile_cache import enable_compile_cache
    from . import camera_paths
    from .cli import load_scene

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="menger")
    p.add_argument("--size", default="1280x720")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--denoise-radius", type=int, default=0)
    p.add_argument(
        "--static", action="store_true",
        help="hold the camera still (temporal fast path)",
    )
    p.add_argument("--top", type=int, default=20)
    p.add_argument(
        "--keep", metavar="DIR", default=None,
        help="keep the raw trace under DIR (e.g. for perfetto)",
    )
    args = p.parse_args(argv)
    enable_compile_cache()

    w, h = (int(v) for v in args.size.split("x"))
    scene = load_scene(args.scene)
    r = Renderer(
        scene=scene, height=h, width=w,
        denoise_radius=args.denoise_radius, lean=True,
    )
    if args.static:
        path = camera_paths.static(scene)
        cams = [path(0.0)] * args.frames
    else:
        path = camera_paths.dolly(scene)
        cams = [path(i / 30.0) for i in range(args.frames)]

    logdir = args.keep or tempfile.mkdtemp(prefix="voxprof_")
    try:
        rows = profile_frames(r, cams, logdir)
        total = sum(ns for _, ns in rows)
        n = max(1, args.frames)
        print(f"total device time: {total / n / 1e6:.2f} ms/frame")
        for name, ns in rows[: args.top]:
            print(f"{ns / n / 1e6:9.3f} ms/frame  {name[:90]}")
    finally:
        if args.keep is None:
            shutil.rmtree(logdir, ignore_errors=True)


if __name__ == "__main__":
    main()
