import os
import sys

# Tests run on the CPU with a virtual 8-device mesh, so the multi-device
# sharding logic is exercised without accelerators (SURVEY.md §4).  The
# card lane (VOX_GPU=1 python -m pytest -m gpu tests/test_gpu.py) keeps
# the GPU backend instead.
GPU_LANE = os.environ.get("VOX_GPU", "") == "1"
if not GPU_LANE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not GPU_LANE:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VOX_DIR = os.path.join(os.path.dirname(__file__), "..", "assets", "vox")


def vox_dir() -> str:
    return VOX_DIR
