"""The card's test lane: ``VOX_GPU=1 python -m pytest -m gpu tests/test_gpu.py``
(``chip_smoke.py`` runs it in-process on the card).

The CPU suite checks the Triton trace kernel through the Pallas
interpreter; these tests check what only the card shows, the compiled
kernel, against the same references and tolerances
(``voxtracer/parity.py``):

* trace kernel vs the NumPy oracle (BASELINE config 1's gate)
* trace kernel vs the XLA trace on a real asset
* the Triton denoise (r=2, r=8) and the XLA denoise (r=2) vs the
  float64 NumPy stencil
* whole frames through ``Renderer`` are finite and not blank
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU "
            "(VOX_GPU=1 python -m pytest -m gpu tests/test_gpu.py)"
        )


def _scene(name):
    from voxtracer.app.cli import load_scene

    return load_scene(name)


def _cam_arr(cam, h, w):
    right, up, forward = cam.axis_scaled(w, h)
    return np.stack([cam.position, right, up, forward]).astype(np.float32)


def test_trace_kernel_matches_oracle_on_card(gpu):
    from voxtracer import parity
    from voxtracer.engine.camera import Camera
    from voxtracer.engine.params import RenderParams
    from voxtracer.engine.pipeline import trace_sample
    from voxtracer.ops import noise as noise_op
    from voxtracer.oracle import renderer as oracle

    scene = _scene("8x8x8")
    h = w = 128
    cam = Camera(position=np.array([2.0, 3.0, -4.0]),
                 direction=np.array([0.2, 0.1, 1.0]))
    params = RenderParams()
    buf = noise_op.white_noise_buffer(seed=7, count=32)
    right, up, forward = cam.axis_scaled(w, h)
    o = oracle.render_sample(
        scene.values, scene.origin.astype(np.int64),
        np.asarray(cam.position), right, up, forward, params,
        noise_op.noise_planes(buf, 1, h, w), w, h,
    )
    x = trace_sample(scene, _cam_arr(cam, h, w), params, buf, 1, h, w,
                     trace_impl="triton")
    gate = parity.gbuf_gate(o, x)
    assert gate["ok"], gate


@pytest.mark.parametrize("specularity", [0.0, 0.4])
def test_trace_kernel_matches_xla_on_card(gpu, specularity):
    import jax

    from voxtracer import parity
    from voxtracer.engine.camera import Camera
    from voxtracer.engine.params import RenderParams
    from voxtracer.engine.pipeline import trace_sample
    from voxtracer.ops import bluenoise

    scene = _scene("menger")
    h, w = 360, 640
    cam = Camera(position=np.array([36.0, 34.0, -5.0]),
                 direction=np.array([-16.0, -14.0, 25.0]))
    params = RenderParams(specularity=specularity)
    buf = bluenoise.cached_buffer()
    args = (scene, _cam_arr(cam, h, w), params, buf, 5, h, w)
    with jax.default_matmul_precision("highest"):
        ref = trace_sample(*args, trace_impl="xla")
        got = trace_sample(*args, trace_impl="triton")
    gate = parity.gbuf_gate(ref, got)
    assert gate["ok"], gate


@pytest.mark.parametrize("impl,radius", [("triton", 2), ("triton", 8),
                                         ("xla", 2)])
def test_denoise_matches_numpy_on_card(gpu, impl, radius):
    from voxtracer import parity

    gate = parity.denoise_gate(270, 480, radius, impl=impl)
    assert gate["ok"], gate


def test_renderer_frames_on_card(gpu):
    from voxtracer.app import camera_paths
    from voxtracer.engine.pipeline import Renderer

    scene = _scene("chr_knight")
    r = Renderer(scene=scene, height=180, width=320, denoise_radius=2)
    assert r.trace_impl == "triton"
    path = camera_paths.orbit(scene)
    for i in range(3):
        out = r.render(path(i / 30.0))
    img = np.asarray(out["image"])
    assert img.shape == (180, 320, 3)
    assert img.std() > 1.0, "blank frame"
    assert np.isfinite(np.asarray(r.state["accum_color"])).all()
