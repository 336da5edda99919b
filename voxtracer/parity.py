"""Parity gates: the GPU trace kernel against the oracle and the XLA
trace, and the denoise (XLA or Triton) against a float64 NumPy stencil.

One home for the tolerances that the CPU tests, the card's test lane
(``tests/test_gpu.py``) and ``chip_smoke.py`` all apply.  Everything is
float32.  The trace and temporal stages contain no ``dot``/``einsum``
(``ops/temporal.py`` reprojects with explicit products), so TF32 never
enters; the comparisons still run under
``jax.default_matmul_precision("highest")``.
"""

from __future__ import annotations

import numpy as np

NODE_AGREEMENT = 0.999  # share of pixels whose first-hit node agrees
DEPTH_TOL = 1e-5  # rtol and atol on the depth of agreeing hits
COLOR_TOL = 1e-3  # per-pixel max |color error| ...
COLOR_SHARE = 0.995  # ... met by this share of agreeing pixels
DENOISE_TOL = 1e-4  # rtol and atol of the XLA denoise vs float64 NumPy


def gbuf_gate(ref, got):
    """Compare two G-buffer dicts (numpy, channels-last); returns the
    measured agreement and ``ok``."""
    agree = np.asarray(ref["node"]) == np.asarray(got["node"])
    hit = (np.asarray(ref["depth"]) >= 0) & agree
    dr = np.asarray(ref["depth"], np.float64)[hit]
    dg = np.asarray(got["depth"], np.float64)[hit]
    depth_ok = bool(
        np.all(np.abs(dg - dr) <= DEPTH_TOL + DEPTH_TOL * np.abs(dr))
    )
    err = np.abs(
        np.asarray(got["color"], np.float64)
        - np.asarray(ref["color"], np.float64)
    ).max(axis=-1)
    color_share = float((err[agree] < COLOR_TOL).mean()) if agree.any() else 0.0
    node_agreement = float(agree.mean())
    return {
        "node_agreement": node_agreement,
        "depth_max_abs_err": float(np.abs(dg - dr).max()) if dr.size else 0.0,
        "color_share_within_tol": color_share,
        "ok": bool(
            node_agreement >= NODE_AGREEMENT
            and depth_ok
            and color_share >= COLOR_SHARE
        ),
    }


def denoise_inputs(height, width, seed=0):
    """A noisy G-buffer (mixed normals, depths, materials and misses)
    and a camera for the denoise comparison."""
    from .engine.camera import Camera

    rng = np.random.default_rng(seed)
    colors = rng.random((height, width, 3), np.float32)
    normal = np.zeros((height, width, 3), np.float32)
    normal[..., 2] = -1.0
    normal[:, width // 2 :] = (0.0, 1.0, 0.0)
    depth = (4.0 + 0.05 * rng.random((height, width))).astype(np.float32)
    depth[: height // 8, : width // 8] = -1.0
    albedo = rng.random((height, width, 3), np.float32)
    material = (rng.integers(0, 2, (height, width)) << 24).astype(np.int32)
    cam = Camera()
    right, up, forward = cam.axis_scaled(width, height)
    cam_rows = [
        np.asarray(v, np.float32) for v in (cam.position, right, up, forward)
    ]
    return colors, normal, depth, albedo, material, cam_rows


def numpy_denoise(colors, normal, depth, albedo, material, cam, params,
                  radius):
    """The oracle's float64 denoise, computed in row bands on a thread
    pool (NumPy releases the GIL), so a 1080p r=8 reference takes
    seconds."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from .oracle import renderer as oracle

    h = colors.shape[0]
    n = max(1, min(os.cpu_count() or 1, 16, h))
    edges = [h * i // n for i in range(n + 1)]
    with ThreadPoolExecutor(n) as pool:
        parts = pool.map(
            lambda i: oracle.denoise(
                colors, normal, depth, albedo, material, cam, params,
                radius, rows=(edges[i], edges[i + 1]),
            ),
            range(n),
        )
        return np.concatenate(list(parts))


def denoise_gate(height, width, radius, impl="xla", seed=0):
    """Max |error| of the jitted denoise (``impl`` "xla" or "triton")
    against the float64 NumPy denoise of the oracle; ``ok`` within
    ``DENOISE_TOL``."""
    import jax
    import jax.numpy as jnp

    from .engine.params import DenoiseParams
    from .ops import denoise as denoise_op
    from .ops import denoise_triton

    colors, normal, depth, albedo, material, cam = denoise_inputs(
        height, width, seed
    )
    params = DenoiseParams(sigma_distance=3.0, sigma_range=2.0,
                           albedo_factor=0.75)
    if impl == "xla":
        fn = jax.jit(denoise_op.denoise, static_argnames="radius")
    else:
        interpret = jax.default_backend() == "cpu"
        fn = jax.jit(
            lambda *a, radius: denoise_triton.denoise(
                *a, radius, interpret=interpret
            ),
            static_argnames="radius",
        )
    with jax.default_matmul_precision("highest"):
        got = np.asarray(
            fn(
                jnp.asarray(colors), jnp.asarray(normal), jnp.asarray(depth),
                jnp.asarray(albedo), jnp.asarray(material),
                tuple(jnp.asarray(c) for c in cam), params, radius=radius,
            )
        )
    ref = numpy_denoise(colors, normal, depth, albedo, material, cam,
                        params, radius)
    bound = DENOISE_TOL + DENOISE_TOL * np.abs(ref)
    return {
        "max_abs_err": float(np.abs(got - ref).max()),
        "ok": bool(np.all(np.abs(got - ref) <= bound)),
    }
