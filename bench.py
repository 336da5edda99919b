"""Headline benchmark: menger.vox progressive path tracing at 720p
(BASELINE config 2) on one device.

Prints ONE JSON line: the metric, its value in fps, the median and
spread of the timed bursts, and the device it ran on (JAX platform,
device kind and count, plus the card's name and power limit from
``nvidia-smi`` where there is one).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

WIDTH, HEIGHT = 1280, 720
WARMUP = 3
FRAMES = 12
BURSTS = 3


def card_name_and_power_limit():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main():
    import jax

    from voxtracer.engine.camera import Camera
    from voxtracer.engine.pipeline import Renderer
    from voxtracer.io import vox as voxio
    from voxtracer.scene import GridScene, voxels_from_vox
    from voxtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    vox_path = os.path.join(here, "assets", "vox", "menger.vox")
    scene = GridScene.from_voxels(voxels_from_vox(voxio.load(vox_path)))

    renderer = Renderer(scene=scene, height=HEIGHT, width=WIDTH, lean=True)
    # frame-filling view of the sponge (~90% pixel coverage), matching
    # the reference's demo framing
    cam = Camera(
        position=np.array([36.0, 34.0, -5.0]),
        direction=np.array([-16.0, -14.0, 25.0]),
    )

    for _ in range(WARMUP):
        out = renderer.render(cam)
    jax.block_until_ready(out)

    dts = []
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        for _ in range(FRAMES):
            out = renderer.render(cam)
        jax.block_until_ready(out)
        dts.append((time.perf_counter() - t0) / FRAMES)
    dev = jax.devices()
    print(
        json.dumps(
            {
                "metric": "menger.vox 720p progressive path trace fps (1 spp/frame, temporal accum, one device, median of bursts)",
                "value": round(1.0 / float(np.median(dts)), 3),
                "unit": "fps",
                "burst_fps": [round(1.0 / d, 3) for d in dts],
                "device": {
                    "platform": dev[0].platform,
                    "kind": dev[0].device_kind,
                    "count": len(dev),
                },
                "card": card_name_and_power_limit(),
            }
        )
    )


if __name__ == "__main__":
    main()
